"""The benchmark's own arithmetic: traffic, clock, metrics, byte counts and
the names in BENCHMARK.json."""
import json
import math
import pathlib
import re
import time

import numpy as np
import pytest

from geobench import stats
from geobench.clock import WallClock
from geobench.traffic import make_reads, warmup_reads

ROOT = pathlib.Path(__file__).resolve().parents[1]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")

READS = {"rate_rps": 2000.0, "home_share": 0.65}
ELIGIBLE = np.array([0, 2, 3, 5])
HOME = np.array([1, 0, 4, 2, 0, 3])


def test_traffic_repeats_by_seed():
    a = make_reads(READS, ELIGIBLE, HOME, 5, 2**31 + 77, 2.0)
    b = make_reads(READS, ELIGIBLE, HOME, 5, 2**31 + 77, 2.0)
    c = make_reads(READS, ELIGIBLE, HOME, 5, 2**31 + 78, 2.0)
    for x, y in ((a.due, b.due), (a.pattern, b.pattern), (a.origin, b.origin)):
        np.testing.assert_array_equal(x, y)
    assert not np.array_equal(a.due[:50], c.due[:50])
    np.testing.assert_array_equal(warmup_reads(READS, ELIGIBLE, HOME, 5, 9, 40)[0],
                                  warmup_reads(READS, ELIGIBLE, HOME, 5, 9, 40)[0])


def test_traffic_rate_and_origin_mix():
    s = make_reads(READS, ELIGIBLE, HOME, 5, 3, 20.0)
    assert abs(len(s.due) / 20.0 - 2000.0) < 60.0
    assert np.all(np.diff(s.due) >= 0) and s.due[-1] < 20.0
    assert set(np.unique(s.pattern)) <= set(ELIGIBLE.tolist())
    at_home = np.mean(s.origin == HOME[s.pattern])
    assert abs(at_home - (0.65 + 0.35 / 5)) < 0.02


def test_clock_semantics():
    c = WallClock()
    t0 = c.now()
    assert 0.0 <= t0 < 0.05
    c.advance(5.0)  # a drain's time has passed already: no jump
    assert c.now() < t0 + 0.05
    with pytest.raises(ValueError):
        c.advance(-1.0)
    c.jump_to(c.now() + 0.02)
    assert c.now() >= t0 + 0.02
    c.horizon = c.now() + 0.01
    t = time.perf_counter()
    c.jump_to(c.now() + 10.0)  # never waits past the harness's next event
    assert time.perf_counter() - t < 0.5
    assert c.now() >= c.horizon


def test_read_latency_arithmetic():
    due = np.array([0.0, 1.0, 2.0, 3.0, 4.0])
    t_ret = np.array([0.5, 1.25, np.nan, np.nan, 9.0])
    failed = np.array([False, False, False, True, False])
    lat = stats.read_latencies(due, t_ret, failed, end=5.0)
    # pending reads count with their age at the close; a failed one is infinite
    np.testing.assert_allclose(lat[:3], [0.5, 0.25, 3.0])
    assert math.isinf(lat[3]) and lat[4] == 1.0
    assert math.isinf(stats.p95(lat))
    assert stats.p95(np.arange(1, 101, dtype=float)) == 96.0
    assert stats.spread([1.0, 2.0, 3.0, 4.0, 5.0]) == pytest.approx(3.0 / 3.0)


def test_device_summary_from_profiler_events():
    import types

    import torch

    from geobench.harness import _Timeline
    from geobench.tracing import device_summary

    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU

    def ev(name, t0, dur, kind):  # profiler times in ns from its own origin
        return types.SimpleNamespace(name=lambda: name, start_ns=lambda: int(t0 * 1e9),
                                     duration_ns=lambda: int(dur * 1e9),
                                     device_type=lambda: kind)

    events = [ev("geobench.mark", 5.0, 0.0, cpu), ev("k_a", 5.5, 0.1, cuda),
              ev("k_b", 6.0, 0.2, cuda), ev("k_a", 6.9, 0.3, cuda), ev("k_c", 9.0, 0.1, cuda),
              ev("host_op", 5.6, 1.0, cpu)]
    prof = types.SimpleNamespace(
        t_mark=100.0, t_start=100.0, t_stop=102.0,
        prof=types.SimpleNamespace(profiler=types.SimpleNamespace(
            kineto_results=types.SimpleNamespace(events=lambda: events))))
    tl = _Timeline()
    tl.add("step", 100.0, 100.4)
    ctx = {"prof": prof, "probe": [(100.6, 101.9, 0.0)], "timeline": tl}
    out = device_summary(ctx)
    # k_a's second launch is cut at the window's end; k_c falls outside it
    assert out["busy_s"] == pytest.approx(0.4) and out["window_s"] == pytest.approx(2.0)
    ops = dict(out["breakdown"]["device_ops"])
    assert ops.keys() == {"k_a", "k_b"} and ops["k_a"] == pytest.approx(0.2)
    gaps = dict(out["breakdown"]["idle_gaps"])
    assert gaps["controller.step outside serve_batch"] == pytest.approx(0.5)
    assert gaps["store.serve_batch"] == pytest.approx(0.4 + 0.7)
    assert sum(gaps.values()) == pytest.approx(2.0 - 0.4)


def test_benchmark_names_and_units():
    for key in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [m["name"] for m in BENCH[key]]
        assert len(names) == len(set(names))
        assert all(NAME.match(n) for n in names)
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for w in BENCH["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert (ROOT / "geobench" / "traffic" / f"{w['traffic']}.json").is_file()
    for c in BENCH["configs"]:
        assert all(NAME.match(k) for k in c["reduced"])
        assert (ROOT / c["file"]).is_file()
    for m in BENCH["per_layer"]:
        assert (ROOT / "geobench" / "metrics" / f"{m['name']}.py").is_file()


def test_per_layer_metrics_move_a_reported_metric():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    cells = [w["name"] for w in BENCH["workloads"]]
    for m in BENCH["per_layer"]:
        moved = e2e[m["moves"]]
        for cell in m.get("workloads", cells):
            assert cell in moved.get("workloads", cells), (m["name"], cell)
    for cell in cells:
        assert any(cell in m.get("workloads", cells) for m in BENCH["per_layer"])
        assert any(cell in m.get("workloads", cells) for m in BENCH["end_to_end"]
                   if m["name"] != "setup_s")


def test_idle_gaps_are_labelled_by_every_harness_span():
    from geobench.harness import _Timeline
    from geobench.tracing import _label

    tl = _Timeline()
    for label, a, b in (("step", 2, 3), ("submit", 3, 4), ("submit", 2.4, 2.6)):
        tl.add(label, a, b)
    ctx = {"probe": [(5, 6, 0.0)], "timeline": tl}
    assert [_label(t, ctx) for t in (2.2, 2.5, 3.5, 5.5, 7.0)] == [
        "controller.step outside serve_batch", "controller.step outside serve_batch",
        "harness.submit", "store.serve_batch", "harness.wait"]
