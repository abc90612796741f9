"""The whole-neighbourhood deployment ``snb-sf3-5shard-nbr`` and its readers:
its configuration differs from ``snb-sf3-5shard``'s in the reads alone, a
small run of ``snb3s-nbr-over`` on the CPU comes out correct with reads on
the fused path, and ``fused_item_share`` and ``route_expand_roofline`` read
what the program records, or nothing where it records nothing."""
import json
import pathlib
import types

import numpy as np
import pytest

from geobench import roofline, stats
from geobench.harness import resolve_cell, run_cell, window_mask
from geobench.tracing import _reader

ROOT = pathlib.Path(__file__).resolve().parents[1]
CELL = "snb3s-nbr-over"


def test_config_differs_from_the_sampled_reads_in_the_patterns_alone():
    base = json.loads((ROOT / "geobench/configs/snb-sf3-5shard.json").read_text())
    nbr = resolve_cell(CELL).config
    for key in ("store", "graph", "environment", "n_dcs", "admission", "placement",
                "guarantees", "reduced_note", "shard_devices", "placement_note"):
        assert nbr[key] == base[key], key
    assert nbr["patterns"] == dict(base["patterns"], hop_weights=[5, 6],
                                   branch=base["graph"]["max_degree"])


def test_small_run_is_correct_with_reads_on_the_fused_path(cell_of):
    # offered far over the small store's capacity with the cell's 512 reads
    # in the store, so drains fill and their sub-batches pass the item gate
    cell = cell_of(CELL, rate=8000.0)
    cell.mix["max_outstanding"] = resolve_cell(CELL).mix["max_outstanding"]
    out = run_cell(cell, 2**31 + 7, 1.5, trace=True, device="cpu")
    json.dumps(out, allow_nan=False)  # the result line is strict JSON
    assert out["correct"], out["checks"]
    assert out["attempted"] > 8000 and out["failed"] == 0
    assert 0.0 < out["metrics"]["fused_item_share"]["value"] <= 1.0
    assert "route_expand_roofline" not in out["metrics"]  # no profiled card on the CPU


BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_tail_is_read_only_where_warm_up_reads_stay_under_its_rank(cell):
    # the warm-up's reads are due at -inf; the window's mask leaves them out,
    # so the tail is finite whatever share of the reads the warm-up holds,
    # and every cell reads its tail (snb3s-nbr-over's warm-up is 6% of them)
    c = resolve_cell(cell)
    n_warm = sum(c.mix["warmup_drains"])
    n_win = int(c.mix["reads"]["rate_rps"] * BENCH["run_seconds"])
    due = np.concatenate([np.full(n_warm, -np.inf),
                          np.linspace(0.0, BENCH["run_seconds"], n_win, endpoint=False)])
    mask = window_mask(due, float(BENCH["run_seconds"]))
    assert mask.sum() == n_win and not mask[:n_warm].any()
    lat = stats.read_latencies(due[mask], due[mask] + 0.01, np.zeros(n_win, bool),
                               float(BENCH["run_seconds"]))
    assert stats.p95(lat) == pytest.approx(0.01)
    assert "read_p95_ms.over" in {m["name"] for m in c.per_layer}, cell


def _span(name, t0, **tags):
    return types.SimpleNamespace(name=name, t0=t0, t1=t0 + 0.001, tags=tags)


def _ctx(records, prof=None):
    tracer = types.SimpleNamespace(records=records)
    return {"tracer": tracer, "clock_origin": 0.0, "T0": 1.0, "end": 3.0, "prof": prof,
            "cell": resolve_cell(CELL)}


@pytest.mark.parametrize("records,want", [
    ([_span("route.expand", 1.5, path="fused", reads=50, items=3000),
      _span("route.expand", 1.6, path="numpy", reads=2, items=1000),
      _span("route.expand", 1.7, path="scalar", reads=1, items=1000),
      _span("route.expand", 0.5, path="numpy", reads=2, items=9000)], 0.6),
    ([_span("route.expand", 1.5, path="fused", reads=50)], None),  # no items tag
    ([], None),
], ids=["items in the window", "a program without the tag", "no span"])
def test_fused_item_share_reads_the_items_tags(records, want):
    got = _reader("fused_item_share")(_ctx(records))
    assert got == (None if want is None else pytest.approx(want))


def _prof(durations_ns):
    events = [types.SimpleNamespace(name=lambda n=n: n, duration_ns=lambda d=d: d)
              for n, d in durations_ns]
    return types.SimpleNamespace(
        t_start=1.0, t_stop=2.0, stopped=True,
        prof=types.SimpleNamespace(profiler=types.SimpleNamespace(
            kineto_results=types.SimpleNamespace(events=lambda: events))))


def test_route_expand_roofline_divides_the_bytes_by_the_kernels_time():
    kernel = "void (anonymous namespace)::route_expand_ragged_kernel(int const*)"
    prof = _prof([(kernel, 20_000), (kernel, 30_000), ("route_expand_regs_kernel<4>", 9_000)])
    recs = [_span("route.device", 1.2, layout="ragged", variant="ragged", slots=150_000,
                  reads=50, layers=3),
            _span("route.device", 1.4, layout="ragged", variant="ragged", slots=1_000,
                  reads=10, layers=3),
            _span("route.device", 2.5, layout="ragged", variant="ragged", slots=9, reads=1,
                  layers=3)]  # after the profiled sub-window
    moved = roofline.ragged_bytes(150_000, 50, 5, 3) + roofline.ragged_bytes(1_000, 10, 5, 3)
    want = 100.0 * moved / 50e-6 / roofline.HBM_BYTES_PER_S
    assert _reader("route_expand_roofline")(_ctx(recs, prof)) == pytest.approx(want)
    # the parent's spans carry no variant; a run without a profile reads nothing
    old = [_span("route.device", 1.2)]
    assert _reader("route_expand_roofline")(_ctx(old, prof)) is None
    assert _reader("route_expand_roofline")(_ctx(recs, None)) is None


def test_ragged_bytes_count_slots_and_reads():
    assert roofline.ragged_bytes(0, 0, 5, 3) == 4
    assert roofline.ragged_bytes(100, 0, 5, 3) == 904
    # offset, origin, order, layers used, 4 miss counts, 5 DCs' bytes, straggler, WAN
    assert roofline.ragged_bytes(0, 1, 5, 3) == 4 + 4 * (3 + 1 + 4 + 5 + 2)
