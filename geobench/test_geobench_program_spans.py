"""The readers of the program's own spans: windowing, tags, nothing to
read on a program without the spans, and every per-layer metric of a small
traced run of the sharded cell on the CPU."""
import pytest

from geobench.harness import run_cell
from geobench.tracing import _reader

STEPS = [(0.0, 1.0, 200, True), (1.0, 2.0, 300, True)]  # 500 window reads
SPAN_READERS = {"pool_wait_us": "facade.pool_wait", "fetch_us": "facade.fetch_rows",
                "observe_us": "facade.observe", "shard_route_us": "shard.route"}


def _ctx(tracer, steps=STEPS):
    # the window is [100, 110) on perf_counter
    return {"tracer": tracer, "clock_origin": 100.0, "T0": 0.0, "end": 10.0, "steps": steps}


@pytest.mark.parametrize("metric,span", sorted(SPAN_READERS.items()))
def test_span_readers_count_spans_begun_in_the_window(metric, span):
    from repro_torch.obs import Tracer

    tracer = Tracer(enabled=True)
    # begun before the window, twice inside (one running past its end), at its end
    for t0, dur in ((99.9, 0.5), (101.0, 0.002), (109.999, 0.003), (110.0, 1.0)):
        tracer.record(span, t0, t0 + dur)
    tracer.record("facade.other", 101.0, 102.0)
    read = _reader(metric)
    assert read(_ctx(tracer)) == pytest.approx((0.002 + 0.003) * 1e6 / 500)
    assert read(_ctx(tracer, steps=[])) is None  # no reads
    assert read(_ctx(Tracer(enabled=True))) is None  # no such span: the parent
    assert read(_ctx(None)) is None  # untraced


def test_shard_cpu_share_and_fused_read_share_readers():
    from repro_torch.obs import Tracer

    tracer = Tracer(enabled=True)
    for t0, dur, cpu in ((99.0, 0.1, 0.1), (101.0, 0.004, 0.001), (102.0, 0.006, 0.003)):
        tracer.record("shard.route", t0, t0 + dur, cpu_s=cpu)
    for t0, path, reads in ((99.0, "fused", 1000), (101.0, "fused", 70), (101.5, "numpy", 20),
                            (102.0, "scalar", 1)):
        tracer.record("route.expand", t0, t0 + 0.001, path=path, reads=reads)
    cpu, fused = _reader("shard_cpu_share"), _reader("fused_read_share")
    assert cpu(_ctx(tracer)) == pytest.approx(0.004 / 0.010)
    assert fused(_ctx(tracer)) == pytest.approx(70 / 91)
    for read in (cpu, fused):
        assert read(_ctx(Tracer(enabled=True))) is None
        assert read(_ctx(None)) is None


def test_traced_sharded_run_reports_every_per_layer_metric(cell_of):
    cell = cell_of(flat=False)
    out = run_cell(cell, 2**31 + 6, 1.5, trace=True, device="cpu")
    assert out["correct"], out["checks"]
    # device_idle comes from the profiler, which runs only on the card
    assert {m["name"] for m in cell.per_layer} - {"device_idle"} <= set(out["metrics"])
    assert 0.0 < out["metrics"]["shard_cpu_share"]["value"] <= 1.0
