"""The port's store under streaming and workload updates vs the JAX
package's, on the CPU.

Twin stores — one per package, each built by its own placement on the
``churned_store`` setup of ``tests/test_streaming.py`` (220 vertices, 24
patterns, ``PlacementConfig(precache=False, dhd_steps=4)``) — take the same
three churn batches at 2%, then a flush, a compaction, a served batch and a
maintenance pass.  Integer and routing outputs must be identical; heat is
held to the DHD tolerance (atol 1e-5, rtol 1e-4, ``tests/test_kernels.py``).
"""
import dataclasses

import numpy as np
import pytest

from repro.core.graph import Graph as JaxGraph
from repro.core.latency import make_paper_env as jax_env
from repro.core.patterns import Workload as JaxWorkload
from repro.core.patterns import generate_khop_patterns as jax_khop
from repro.core.placement import PlacementConfig as JaxPlacementConfig
from repro.core.routing import route_online_batch as jax_route_online_batch
from repro.core.store import GeoGraphStore as JaxStore
from repro.streaming import DeltaGraph as JaxDeltaGraph
from repro.streaming import random_churn_batch as jax_churn
from repro_torch.core.graph import Graph, build_csr
from repro_torch.core.latency import make_paper_env
from repro_torch.core.patterns import Workload, generate_khop_patterns
from repro_torch.core.placement import PlacementConfig
from repro_torch.core.routing import route_online_batch
from repro_torch.core.store import GeoGraphStore
from repro_torch.kernels.cuda_lib import launch_counters, reset_launch_counters
from repro_torch.streaming import DeltaGraph

DHD_TOL = dict(atol=1e-5, rtol=1e-4)
REPORT_INTS = (
    "n_add_vertices", "n_del_vertices", "n_add_edges", "n_del_edges",
    "n_touched_vertices", "compacted",
)
WARM_INTS = ("frontier_size", "halo_size", "local_iters", "global_iters")


def _setup(pkg):
    G, env_f, khop, W = {
        "jax": (JaxGraph, jax_env, jax_khop, JaxWorkload),
        "torch": (Graph, make_paper_env, generate_khop_patterns, Workload),
    }[pkg]
    rng = np.random.default_rng(11)
    src, dst = rng.integers(0, 220, 1400), rng.integers(0, 220, 1400)
    keep = src != dst
    g = G.from_edges(220, src[keep], dst[keep], partition=rng.integers(0, 4, 220))
    env = env_f()
    csr = build_csr(g.n_nodes, g.src, g.dst, symmetrize=True)
    pats = khop(g, csr, 24, seed=3, n_dcs=env.n_dcs)
    return g, env, W.from_patterns(pats, g.n_items, env.n_dcs), csr


def _twins(**kw):
    gj, envj, wlj, _ = _setup("jax")
    gt, envt, wlt, _ = _setup("torch")
    js = JaxStore(gj, envj, wlj, config=JaxPlacementConfig(precache=False, dhd_steps=4), **kw)
    ts = GeoGraphStore(
        gt, envt, wlt, config=PlacementConfig(precache=False, dhd_steps=4),
        device="cpu", **kw,
    )
    _assert_same_store(ts, js)
    return js, ts


def _canon_layers(lg):
    return [
        [(b.layer, b.bs_id, b.comp, b.edge_ids.tolist(), list(b.children), b.dcs.tolist())
         for b in layer]
        for layer in lg.layers
    ]


def _assert_same_store(ts, js):
    """Every item-indexed table and the layered graph identical."""
    np.testing.assert_array_equal(ts.state.delta, js.state.delta)
    np.testing.assert_array_equal(ts.route_index.nearest, js.route_index.nearest)
    np.testing.assert_array_equal(ts.route_index.second, js.route_index.second)
    np.testing.assert_array_equal(ts._item_uid, js._item_uid)
    assert ts._next_uid == js._next_uid and ts._id_epoch == js._id_epoch
    np.testing.assert_array_equal(ts.workload.r_xy, js.workload.r_xy)
    np.testing.assert_array_equal(ts.workload.w_xy, js.workload.w_xy)
    for a, b in zip(ts.workload.patterns, js.workload.patterns, strict=True):
        np.testing.assert_array_equal(a.items, b.items)
    # served traffic deposits exactly; maintain() diffuses it (DHD floats)
    np.testing.assert_allclose(ts.demand.heat, js.demand.heat, **DHD_TOL)
    for f in ("src", "dst", "partition", "node_size", "edge_size"):
        np.testing.assert_array_equal(getattr(ts.g, f), getattr(js.g, f))
    assert ts.lg.n_layers == js.lg.n_layers
    assert ts.lg.thresholds_s == js.lg.thresholds_s
    np.testing.assert_array_equal(ts.lg.edge_layer, js.lg.edge_layer)
    np.testing.assert_array_equal(ts.lg.comp_of_dc, js.lg.comp_of_dc)
    assert _canon_layers(ts.lg) == _canon_layers(js.lg)


def _assert_same_heat(ts, js):
    assert (ts._heat is None) == (js._heat is None)
    if ts._heat is None:
        return
    np.testing.assert_array_equal(ts._heat.cols, js._heat.cols)
    np.testing.assert_array_equal(ts._heat.vals, js._heat.vals)
    assert ts._heat.alpha == js._heat.alpha
    np.testing.assert_allclose(ts._heat.heat, js._heat.heat, **DHD_TOL)
    assert ts._heat_scale == js._heat_scale


def _assert_same_report(rt, rj):
    assert [getattr(rt, f) for f in REPORT_INTS] == [getattr(rj, f) for f in REPORT_INTS]
    assert dataclasses.asdict(rt.repair) == dataclasses.asdict(rj.repair)
    assert [getattr(rt.heat, f) for f in WARM_INTS] == [getattr(rj.heat, f) for f in WARM_INTS]
    np.testing.assert_allclose(rt.heat_residual, rj.heat_residual, **DHD_TOL)


def _requests(store, n, seed):
    rng = np.random.default_rng(seed)
    pats = [p for p in store.workload.patterns if len(p.items)]
    reqs = []
    for _ in range(n):
        p = pats[int(rng.integers(0, len(pats)))]
        home = int(np.argmax(p.r_py))
        origin = home if rng.random() < 0.65 else int(rng.integers(0, store.env.n_dcs))
        reqs.append((p.items, origin))
    return reqs


def _assert_same_results(got, want):
    assert len(got) == len(want)
    for x, y in zip(got, want):
        np.testing.assert_array_equal(x.served_by, y.served_by)
        assert x.latency_s == y.latency_s
        assert x.per_dc_latency == y.per_dc_latency
        assert x.wan_bytes == y.wan_bytes
        assert x.layers_used == y.layers_used and x.n_missing == y.n_missing


@pytest.fixture(scope="module")
def churned_twins():
    """Twins after the three batches, with each batch's reports."""
    reset_launch_counters()
    js, ts = _twins()
    js._delta_graph = JaxDeltaGraph(js.g)
    ts._delta_graph = DeltaGraph(ts.g)
    rng = np.random.default_rng(12)
    reports = []
    for _ in range(3):
        batch = jax_churn(js._delta_graph, 0.02, rng)
        reports.append((ts.apply_updates(batch), js.apply_updates(batch)))
        _assert_same_store(ts, js)
        _assert_same_heat(ts, js)
    assert all(c.n == 0 for c in launch_counters().values())
    return js, ts, reports


def test_each_batch_matches_jax(churned_twins):
    js, ts, reports = churned_twins
    for rt, rj in reports:
        _assert_same_report(rt, rj)
        assert rt.n_add_edges > 0 and rt.n_del_edges > 0
    assert ts.tombstone_ratio() == js.tombstone_ratio() > 0.0


def test_flush_compact_serve_maintain_match_jax(churned_twins):
    """Runs on the churned twins in the order a maintenance window would."""
    js, ts, _ = churned_twins
    pj, pt = js.flush_migrations(), ts.flush_migrations()
    assert [(m.item, m.dc, m.kind, m.src) for m in pt.moves] == [
        (m.item, m.dc, m.kind, m.src) for m in pj.moves
    ]
    assert len(pt.moves) > 0 and pt.schedule.n_waves == pj.schedule.n_waves
    _assert_same_store(ts, js)

    seen = {"jax": [], "torch": []}
    js.add_remap_listener(lambda imap: seen["jax"].append(imap.copy()))
    ts.add_remap_listener(lambda imap: seen["torch"].append(imap.copy()))
    assert ts.compact() is js.compact() is True
    assert len(seen["torch"]) == len(seen["jax"]) == 1
    np.testing.assert_array_equal(seen["torch"][0], seen["jax"][0])
    assert ts.tombstone_ratio() == js.tombstone_ratio() == 0.0
    assert ts.compact() is js.compact() is False
    _assert_same_store(ts, js)
    _assert_same_heat(ts, js)

    reqs = _requests(js, 64, seed=64)
    _assert_same_results(ts.serve_batch(reqs), js.serve_batch(reqs))
    _assert_same_results(
        route_online_batch(ts.lg, ts.state, reqs, fast=False, device="cpu"),
        jax_route_online_batch(js.lg, js.state, reqs, fast=False),
    )
    mt, mj = ts.maintain(), js.maintain()
    assert mt["evicted"] == mj["evicted"] > 0
    np.testing.assert_allclose(mt["heat_residual"], mj["heat_residual"], **DHD_TOL)
    _assert_same_store(ts, js)
    _assert_same_heat(ts, js)
    assert ts.constraints() == js.constraints()


def test_compaction_trigger_and_remap_listeners_match_jax():
    """A low ``compact_ratio`` fires the compaction inside
    ``apply_updates``: both packages fire the growth map, then the
    compaction map, to their listeners."""
    js, ts = _twins(compact_ratio=0.01)
    js._delta_graph = JaxDeltaGraph(js.g)
    ts._delta_graph = DeltaGraph(ts.g)
    seen = {"jax": [], "torch": []}
    js.add_remap_listener(lambda imap: seen["jax"].append(imap.copy()))
    ts.add_remap_listener(lambda imap: seen["torch"].append(imap.copy()))
    batch = jax_churn(js._delta_graph, 0.02, np.random.default_rng(5))
    rj, rt = js.apply_updates(batch), ts.apply_updates(batch)
    assert rt.compacted and rj.compacted
    _assert_same_report(rt, rj)
    assert len(seen["torch"]) == len(seen["jax"]) == 2
    for a, b in zip(seen["torch"], seen["jax"]):
        np.testing.assert_array_equal(a, b)
    _assert_same_store(ts, js)
    _assert_same_heat(ts, js)


def test_default_flush_before_any_churn_matches_jax():
    """A flush on a never-churned store cold-solves the heat field first."""
    js, ts = _twins()
    assert ts.maintain()["heat_residual"] == js.maintain()["heat_residual"] == 0.0
    pj, pt = js.flush_migrations(), ts.flush_migrations()
    assert [(m.item, m.dc, m.kind) for m in pt.moves] == [
        (m.item, m.dc, m.kind) for m in pj.moves
    ]
    _assert_same_heat(ts, js)
    _assert_same_store(ts, js)


def test_workload_updates_match_jax():
    """``insert_patterns_incremental`` replays the journal as the JAX store
    does (same rows changed, same hits and misses); ``insert_patterns`` and
    ``delete_items`` leave identical replica sets."""
    js, ts = _twins()
    g, env, _, csr = _setup("torch")
    new = generate_khop_patterns(g, csr, 6, seed=9, n_dcs=env.n_dcs)
    new = [dataclasses.replace(p, pid=100 + i) for i, p in enumerate(new)]
    rj = js.insert_patterns_incremental(new)
    rt = ts.insert_patterns_incremental(new)
    for k in ("n_new", "rows_changed", "journal_hits", "journal_misses"):
        assert rt[k] == rj[k], k
    assert rt["journal_hits"] > 0
    _assert_same_store(ts, js)
    more = generate_khop_patterns(g, csr, 4, seed=10, n_dcs=env.n_dcs)
    more = [dataclasses.replace(p, pid=200 + i) for i, p in enumerate(more)]
    js.insert_patterns(more)
    ts.insert_patterns(more)
    _assert_same_store(ts, js)
    assert ts.stats.placement_stats["competitions"] == js.stats.placement_stats["competitions"]
    victims = np.unique(np.concatenate([p.items[:3] for p in more]))
    js.delete_items(victims)
    ts.delete_items(victims)
    assert not ts.state.delta[victims].any()
    _assert_same_store(ts, js)
