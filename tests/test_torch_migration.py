"""The port's migration pipeline vs the JAX package's, on the CPU.

Twin stores — one per package, each built by its own placement on the
churned setup of ``tests/test_migration_pipeline.py`` (220 vertices, 24
patterns, 3 churn batches at 2%) — plan, schedule and apply the same
flushes:

* ``plan_migrations`` (vectorized and the per-item legacy planner): the
  same moves in the same order, with identical benefits and counters;
* ``schedule_transfers`` (``ff`` and ``lpt``): the same waves, link loads
  and makespans;
* ``apply_plan`` wave by wave and ``WaveApplier`` stepped by hand: after
  every wave ``state.delta`` and ``route_index.nearest`` are identical;
* an id-epoch change between waves raises ``StaleFlushError`` in both.
"""
import numpy as np
import pytest

from repro.core.graph import Graph as JaxGraph
from repro.core.latency import make_paper_env as jax_env
from repro.core.patterns import Workload as JaxWorkload
from repro.core.patterns import generate_khop_patterns as jax_khop
from repro.core.placement import PlacementConfig as JaxPlacementConfig
from repro.core.store import GeoGraphStore as JaxStore
from repro.streaming import DeltaGraph as JaxDeltaGraph
from repro.streaming import random_churn_batch as jax_churn
from repro.streaming.migration import StaleFlushError as JaxStaleFlushError
from repro.streaming.migration import plan_migrations as jax_plan
from repro.streaming.migration import schedule_transfers as jax_schedule
from repro_torch.core.graph import Graph, build_csr
from repro_torch.core.latency import make_paper_env
from repro_torch.core.patterns import Workload, generate_khop_patterns
from repro_torch.core.placement import PlacementConfig
from repro_torch.core.store import GeoGraphStore
from repro_torch.streaming import DeltaGraph
from repro_torch.streaming.migration import StaleFlushError, plan_migrations, schedule_transfers

PLAN_KW = (
    dict(theta_add=0.5, theta_drop=0.15),
    dict(theta_add=0.8, theta_drop=0.05),
    dict(theta_add=0.3, theta_drop=0.30, max_moves=64),
)


def _store(pkg, seed):
    """A store of ``pkg`` ("jax" or "torch") on the seeded random graph."""
    G, env_f, khop, W, PC, S, kw = {
        "jax": (JaxGraph, jax_env, jax_khop, JaxWorkload, JaxPlacementConfig, JaxStore, {}),
        "torch": (Graph, make_paper_env, generate_khop_patterns, Workload,
                  PlacementConfig, GeoGraphStore, {"device": "cpu"}),
    }[pkg]
    rng = np.random.default_rng(seed)
    src, dst = rng.integers(0, 220, 1400), rng.integers(0, 220, 1400)
    keep = src != dst
    g = G.from_edges(220, src[keep], dst[keep], partition=rng.integers(0, 4, 220))
    env = env_f()
    csr = build_csr(g.n_nodes, g.src, g.dst, symmetrize=True)
    pats = khop(g, csr, 24, seed=seed + 1, n_dcs=env.n_dcs)
    wl = W.from_patterns(pats, g.n_items, env.n_dcs)
    return S(g, env, wl, config=PC(precache=False, dhd_steps=4), **kw)


def _twins(seed, n_batches=3, rate=0.02):
    """(jax store, port store), identically built and churned; the port's
    batches come from its own generator on an identically seeded rng."""
    js, ts = _store("jax", seed), _store("torch", seed)
    np.testing.assert_array_equal(ts.state.delta, js.state.delta)
    js._delta_graph = JaxDeltaGraph(js.g)
    ts._delta_graph = DeltaGraph(ts.g)
    rng_j, rng_t = np.random.default_rng(seed + 100), np.random.default_rng(seed + 100)
    for _ in range(n_batches):
        js.apply_updates(jax_churn(js._delta_graph, rate, rng_j))
        ts.apply_updates(_port_churn(ts, rate, rng_t))
    _assert_same_placement(ts, js)
    return js, ts


def _port_churn(store, rate, rng):
    from repro_torch.streaming import random_churn_batch

    return random_churn_batch(store._delta_graph, rate, rng)


def _assert_same_placement(ts, js):
    np.testing.assert_array_equal(ts.state.delta, js.state.delta)
    np.testing.assert_array_equal(ts.route_index.nearest, js.route_index.nearest)
    np.testing.assert_array_equal(ts.route_index.second, js.route_index.second)


def _planning_inputs(store):
    """flush_migrations' default heat and liveness (planning inputs only)."""
    vheat = store._heat.vertex_heat
    eheat = 0.5 * (vheat[store.g.src] + vheat[store.g.dst])
    alive = np.concatenate([store._delta_graph.node_alive, store._delta_graph.edge_alive])
    budget = 0.05 * float(store.g.item_size().sum())
    return np.concatenate([vheat, eheat]) * alive, alive, budget


def _moves(plan):
    return [(m.item, m.dc, m.kind, m.src, m.benefit, m.wan_bytes) for m in plan.moves]


def _assert_same_plan(pt, pj):
    assert _moves(pt) == _moves(pj)
    assert (pt.wan_bytes, pt.est_benefit, pt.n_candidates, pt.skipped_budget) == (
        pj.wan_bytes, pj.est_benefit, pj.n_candidates, pj.skipped_budget
    )


def _waves(sched):
    return [
        (w.index, w.makespan_s,
         [(b.src, b.dst, b.nbytes, b.items.tolist(), [(m.item, m.dc) for m in b.moves])
          for b in w.links])
        for w in sched.waves
    ]


def _assert_same_schedule(st, sj):
    assert _waves(st) == _waves(sj)
    assert [(m.item, m.dc) for m in st.local] == [(m.item, m.dc) for m in sj.local]
    assert (st.makespan_s, st.oversized, st.packing, st.window_s) == (
        sj.makespan_s, sj.oversized, sj.packing, sj.window_s
    )
    np.testing.assert_array_equal(st.link_budget, sj.link_budget)
    assert st.link_loads() == sj.link_loads()


def _tight_window(store, n_items_per_wave=3.0):
    med = float(np.median(store.g.item_size()))
    return n_items_per_wave * med / float(store.env.bw_Bps_safe().min())


@pytest.fixture(scope="module")
def planned_twins():
    return _twins(0)


@pytest.mark.parametrize("vectorized", [True, False])
def test_planner_matches_jax(planned_twins, vectorized):
    js, ts = planned_twins
    for kw in PLAN_KW:
        hj, aj, bj = _planning_inputs(js)
        ht, at, bt = _planning_inputs(ts)
        np.testing.assert_allclose(ht, hj, atol=1e-5, rtol=1e-4)
        np.testing.assert_array_equal(at, aj)
        # the same heat into both planners: move identity is the planner's
        # contract, heat parity is test_torch_streaming's
        pj = jax_plan(js.g, js.env, js.state, js.workload.r_xy, js.workload.w_xy,
                      hj, bj, item_alive=aj, vectorized=vectorized, **kw)
        pt = plan_migrations(ts.g, ts.env, ts.state, ts.workload.r_xy,
                             ts.workload.w_xy, hj, bt, item_alive=at,
                             vectorized=vectorized, **kw)
        assert len(pj.moves) > 0
        _assert_same_plan(pt, pj)


@pytest.mark.parametrize("packing", ["ff", "lpt"])
def test_schedule_matches_jax(planned_twins, packing):
    js, ts = planned_twins
    hj, aj, bj = _planning_inputs(js)
    kw = dict(theta_add=0.3, theta_drop=0.15)
    pj = jax_plan(js.g, js.env, js.state, js.workload.r_xy, js.workload.w_xy,
                  hj, bj, item_alive=aj, **kw)
    pt = plan_migrations(ts.g, ts.env, ts.state, ts.workload.r_xy, ts.workload.w_xy,
                         hj, bj, item_alive=aj, **kw)
    window = _tight_window(js)
    sj = jax_schedule(pj, js.env, window, schedule=packing)
    st = schedule_transfers(pt, ts.env, window, schedule=packing)
    assert sj.n_waves >= 2
    _assert_same_schedule(st, sj)


@pytest.mark.parametrize("window", ["tight", "single_shot"])
def test_flush_wave_by_wave_matches_jax(window):
    """``flush_migrations`` with its default heat: the same plan, and after
    every wave the same replica sets and nearest-replica table."""
    js, ts = _twins(6)
    snaps = {"jax": [], "torch": []}

    def on_wave(name, store):
        def fn(wave):
            snaps[name].append(
                (wave.index, store.state.delta.copy(), store.route_index.nearest.copy())
            )
        return fn

    w = _tight_window(js) if window == "tight" else None
    kw = dict(theta_add=0.3, theta_drop=0.15)
    pj = js.flush_migrations(window_s=w, on_wave=on_wave("jax", js), **kw)
    pt = ts.flush_migrations(window_s=w, on_wave=on_wave("torch", ts), **kw)
    _assert_same_plan(pt, pj)
    assert pt.rolled_back == pj.rolled_back
    if w is None:
        assert pt.schedule is None and pj.schedule is None
    else:
        _assert_same_schedule(pt.schedule, pj.schedule)
        assert len(snaps["jax"]) == pj.schedule.n_waves >= 2
    assert len(snaps["torch"]) == len(snaps["jax"])
    for (it, dt, nt), (ij, dj, nj) in zip(snaps["torch"], snaps["jax"]):
        assert it == ij
        np.testing.assert_array_equal(dt, dj)
        np.testing.assert_array_equal(nt, nj)
    _assert_same_placement(ts, js)
    assert ts.route_index.verify(ts.state.delta)
    assert ts.constraints() == js.constraints()


def test_wave_applier_and_stale_flush_match_jax():
    """``begin_flush`` stepped by hand in both packages, then a churn batch
    between waves: the next wave raises ``StaleFlushError`` in both and
    the placement keeps what had landed."""
    js, ts = _twins(7)
    kw = dict(theta_add=0.3, theta_drop=0.15)
    window = _tight_window(js)
    pj, aj = js.begin_flush(window_s=window, **kw)
    pt, at = ts.begin_flush(window_s=window, **kw)
    _assert_same_plan(pt, pj)
    _assert_same_placement(ts, js)  # zero-byte local adds landed
    assert at.n_remaining == aj.n_remaining >= 3
    for _ in range(2):
        wj, wt = aj.apply_next(), at.apply_next()
        assert wt.index == wj.index
        _assert_same_placement(ts, js)
    assert at.peek().index == aj.peek().index
    rng = np.random.default_rng(70)
    batch = jax_churn(js._delta_graph, 0.01, rng)
    js.apply_updates(batch)
    ts.apply_updates(batch)
    _assert_same_placement(ts, js)
    with pytest.raises(JaxStaleFlushError):
        aj.apply_next()
    with pytest.raises(StaleFlushError, match="re-plan"):
        at.apply_next()
    with pytest.raises(StaleFlushError):
        at.finish()
    # a fresh flush on the new id space runs to the end in both
    pj2, pt2 = js.flush_migrations(window_s=window, **kw), ts.flush_migrations(
        window_s=window, **kw
    )
    _assert_same_plan(pt2, pj2)
    _assert_same_placement(ts, js)
