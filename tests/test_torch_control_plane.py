"""The port's serving control plane against the JAX package's, on the CPU.

``StoreClient`` / ``AdmissionController`` / ``MaintenancePolicy`` of both
packages drive twin stores built from the same seeded inputs (the port's
with ``device="cpu"``).  Everything runs on the simulated clock, so the
comparison is exact:

  * the arrival regimes of ``benchmarks/bench_scheduler.py`` (bursty,
    steady, mixed) under the fixed, greedy and adaptive policies, on
    ``run_traced``'s churned 220-vertex store and on a small community
    store: ``ctl.metrics()`` equal, ``BatchRecord``s identical, every
    handle's result equal;
  * ``run_traced``'s churn-and-flush run (adaptive policy, a migration
    flush landing waves in the bursty idle gaps, periodic ``maintain``):
    the Chrome trace export byte-identical;
  * the predictive policy (measured heat, an EWMA forecaster pre-staging
    replicas): ``policy.stats()``, replica sets and latencies equal;
  * ``StoreClient`` handles, deadline accounting, and
    ``_remap_pending_items`` across mutation growth and a compaction.

The trace builders are carried from ``bench_scheduler.py`` (numpy only), so
both packages replay the same arrivals.
"""
import math
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

import repro.obs as jobs
import repro.serve as jserve
from repro.core.graph import Graph as JGraph
from repro.core.graph import build_csr as j_build_csr
from repro.core.latency import make_paper_env as j_paper_env
from repro.core.patterns import Workload as JWorkload
from repro.core.patterns import generate_khop_patterns as j_khop
from repro.core.placement import PlacementConfig as JPlacementConfig
from repro.core.store import GeoGraphStore as JStore
from repro.data.synthetic import community_graph as j_community
from repro.data.synthetic import diurnal_demand_trace
from repro.demand import EWMAForecaster as JEWMAForecaster
from repro.streaming import DeltaGraph as JDeltaGraph
from repro.streaming import random_churn_batch as j_churn_batch
import repro_torch.obs as tobs
import repro_torch.serve as tserve
from repro_torch.core.graph import Graph, build_csr
from repro_torch.core.latency import make_paper_env
from repro_torch.core.patterns import Workload, generate_khop_patterns
from repro_torch.core.placement import PlacementConfig
from repro_torch.core.store import GeoGraphStore
from repro_torch.data.synthetic import community_graph
from repro_torch.demand import EWMAForecaster
from repro_torch.streaming import DeltaGraph, random_churn_batch

PORT = dict(Graph=Graph, csr=build_csr, env=make_paper_env, khop=generate_khop_patterns,
            Workload=Workload, Config=PlacementConfig, Store=GeoGraphStore,
            community=community_graph, DeltaGraph=DeltaGraph, churn=random_churn_batch,
            serve=tserve, obs=tobs, Forecaster=EWMAForecaster, kw=dict(device="cpu"))
JAX = dict(Graph=JGraph, csr=j_build_csr, env=j_paper_env, khop=j_khop,
           Workload=JWorkload, Config=JPlacementConfig, Store=JStore,
           community=j_community, DeltaGraph=JDeltaGraph, churn=j_churn_batch,
           serve=jserve, obs=jobs, Forecaster=JEWMAForecaster, kw={})
PKGS = (PORT, JAX)

_POLICIES = {
    "fixed": dict(policy="fixed", fairness="fifo"),
    "greedy": dict(policy="greedy", fairness="fifo"),
    "adaptive": dict(policy="adaptive", fairness="round_robin"),
}


# ------------------------------------------------------------ the fixtures
def _traced_store(pkg, seed=13, n_batches=3):
    """``bench_scheduler.run_traced``'s store: a random 220-vertex graph over
    4 of the 5 DCs, 24 k-hop patterns, three churn batches at 0.02."""
    rng = np.random.default_rng(seed)
    src, dst = rng.integers(0, 220, 1400), rng.integers(0, 220, 1400)
    keep = src != dst
    g = pkg["Graph"].from_edges(220, src[keep], dst[keep], partition=rng.integers(0, 4, 220))
    env = pkg["env"]()
    csr = pkg["csr"](g.n_nodes, g.src, g.dst, symmetrize=True)
    pats = pkg["khop"](g, csr, 24, seed=seed + 1, n_dcs=env.n_dcs)
    wl = pkg["Workload"].from_patterns(pats, g.n_items, env.n_dcs)
    store = pkg["Store"](g, env, wl, config=pkg["Config"](precache=False, dhd_steps=4),
                         **pkg["kw"])
    rng = np.random.default_rng(seed + 100)
    store._delta_graph = pkg["DeltaGraph"](store.g)
    for _ in range(n_batches):
        store.apply_updates(pkg["churn"](store._delta_graph, 0.02, rng))
    return store


def _community_store(pkg, seed=0, window_s=60.0):
    g = pkg["community"](400, n_communities=8, p_in=0.04, p_out=0.001, seed=seed, n_dcs=5)
    env = pkg["env"]()
    csr = pkg["csr"](g.n_nodes, g.src, g.dst, symmetrize=True)
    pats = pkg["khop"](g, csr, 24, seed=seed + 1, n_dcs=env.n_dcs)
    wl = pkg["Workload"].from_patterns(pats, g.n_items, env.n_dcs)
    return pkg["Store"](g, env, wl, config=pkg["Config"](precache=False, dhd_steps=4),
                        demand_window_s=window_s, **pkg["kw"])


def _pick(store, rng):
    pats = [p for p in store.workload.patterns if len(p.items)]
    p = pats[int(rng.integers(0, len(pats)))]
    home = int(np.argmax(p.r_py))
    origin = home if rng.random() < 0.65 else int(rng.integers(0, store.env.n_dcs))
    return p.items, origin


def make_trace(store, regime, n, seed=0):
    """``bench_scheduler.make_trace``: (t, items, origin, priority, deadline)."""
    rng = np.random.default_rng(seed)
    out = []
    if regime == "steady":
        t = 0.0
        for _ in range(n):
            t += float(rng.exponential(0.004))
            out.append((t, *_pick(store, rng), 0, 0.5))
    elif regime == "bursty":
        t = 0.0
        while len(out) < n:
            for _ in range(min(80, n - len(out))):
                items, origin = _pick(store, rng)
                out.append((t + float(rng.random()) * 1e-3, items, origin, 0, 0.5))
            t += 0.5
    else:  # mixed
        t = 0.0
        for _ in range(n):
            t += float(rng.exponential(0.004))
            items, origin = _pick(store, rng)
            out.append((t, items, origin, 0, 0.3) if rng.random() < 0.7
                       else (t, items, origin, 1, 3.0))
    return out


def _replay(pkg, store, trace, maint=None, **cfg):
    serve = pkg["serve"]
    ctl = serve.AdmissionController(store, serve.AdmissionConfig(**cfg), policy=maint)
    client = serve.StoreClient(ctl)
    for t, items, origin, prio, deadline in trace:
        client.submit(items, origin, deadline_s=deadline, priority=prio, at=t)
    done = ctl.run_until_idle()
    assert len(done) == len(trace)
    return ctl, done


def _same_results(r1, r2):
    assert len(r1) == len(r2)
    for a, b in zip(r1, r2):
        assert np.array_equal(a.served_by, b.served_by)
        assert a.latency_s == b.latency_s and a.per_dc_latency == b.per_dc_latency
        assert (a.wan_bytes, a.layers_used, a.n_missing) == (b.wan_bytes, b.layers_used,
                                                              b.n_missing)


def _same_runs(run_a, run_b):
    (ctl_a, done_a), (ctl_b, done_b) = run_a, run_b
    assert ctl_a.metrics() == ctl_b.metrics()
    hist_a = [tuple(vars(b).values()) for b in ctl_a.history]
    assert hist_a == [tuple(vars(b).values()) for b in ctl_b.history]
    assert [(h.rid, h.t_dispatch, h.t_done) for h in done_a] == [
        (h.rid, h.t_dispatch, h.t_done) for h in done_b]
    _same_results([h.result for h in done_a], [h.result for h in done_b])


@pytest.fixture(scope="module")
def traced_twins():
    return [_traced_store(pkg) for pkg in PKGS]


@pytest.fixture(scope="module")
def community_twins():
    return [_community_store(pkg) for pkg in PKGS]


@pytest.mark.parametrize("policy", sorted(_POLICIES))
@pytest.mark.parametrize("regime", ["bursty", "steady", "mixed"])
@pytest.mark.parametrize("fixture", ["traced_twins", "community_twins"])
def test_regimes_and_policies_equal(request, fixture, regime, policy):
    stores = request.getfixturevalue(fixture)
    assert np.array_equal(stores[0].state.delta, stores[1].state.delta)
    trace = make_trace(stores[1], regime, 240, seed=13)
    runs = [_replay(pkg, s, trace, max_batch=64, **_POLICIES[policy])
            for pkg, s in zip(PKGS, stores)]
    _same_runs(*runs)
    assert runs[0][0].metrics()["completed"] == 240


# ------------------------------------------------------ churn-and-flush run
def run_traced(pkg, n_req, seed=13):
    """``bench_scheduler.run_traced`` in either package: (trace text, policy,
    controller)."""
    serve, obs = pkg["serve"], pkg["obs"]
    store = _traced_store(pkg, seed)
    window = 3.0 * float(np.median(store.g.item_size())) / float(
        store.env.bw_Bps_safe().min())
    old = obs.set_default_registry(obs.MetricsRegistry(enabled=True))
    try:
        policy = serve.MaintenancePolicy(store, serve.MaintenanceConfig(
            window_s=window, plan_kw=dict(theta_add=0.3, theta_drop=0.15),
            maintain_every_s=1.0, maintain_cost_s=1e-4))
        policy.request_flush()
        ctl = serve.AdmissionController(store, serve.AdmissionConfig(policy="adaptive"),
                                        policy=policy)
        client = serve.StoreClient(ctl)
        for t, items, origin, prio, deadline in make_trace(store, "bursty", n_req, seed=seed):
            client.submit(items, origin, deadline_s=deadline, priority=prio, at=t)
        ctl.run_until_idle()
        text = obs.export_chrome_trace(ctl.tracer)
        snap = obs.get_registry().snapshot()
    finally:
        obs.set_default_registry(old)
    return text, policy, ctl, store, snap


def test_churn_and_flush_trace_byte_identical():
    port, ref = (run_traced(pkg, 300) for pkg in PKGS)
    text, policy, ctl, store, snap = port
    assert text == ref[0]  # byte-identical sim-clock trace export
    assert policy.stats() == ref[1].stats()
    assert ctl.metrics() == ref[2].metrics()
    assert np.array_equal(store.state.delta, ref[3].state.delta)
    assert np.array_equal(store.state.route, ref[3].state.route)
    assert policy.n_waves > 0 and policy.n_maintains > 0
    names = [s.name for s in ctl.tracer.records]
    assert names.count("request") == 300 and names.count("migration_wave") == policy.n_waves
    for key in ("migration.wan_bytes", "migration.wave_makespan_s"):
        assert snap[key] == ref[4][key]


# ------------------------------------------------------------- predictive
def test_predictive_policy_stats_equal():
    """Measured heat with an EWMA forecaster pre-staging replicas one demand
    window ahead, over two diurnal periods."""
    outcomes = []
    for pkg in PKGS:
        serve = pkg["serve"]
        store = _community_store(pkg, seed=5, window_s=3.0)
        pats = [p for p in store.workload.patterns if len(p.items)]
        trace, _ = diurnal_demand_trace(pats, store.env.n_dcs, 400, 24.0, n_periods=2,
                                        locality=1.0, seed=7, deadline_s=0.5)
        policy = serve.MaintenancePolicy(store, serve.MaintenanceConfig(
            window_s=2.0, budget_frac=0.05, flush_every_s=3.0, heat_source="measured",
            plan_kw=dict(theta_add=0.3, theta_drop=0.25), predictive=True,
            forecaster=pkg["Forecaster"](), prestage_horizon=1, prestage_theta_add=0.3))
        ctl, done = _replay(pkg, store, trace, maint=policy, policy="greedy",
                            fairness="fifo", max_batch=16)
        outcomes.append((policy, ctl, done, store))
    (pol, ctl, done, store), (jpol, jctl, jdone, jstore) = outcomes
    assert pol.stats() == jpol.stats()
    assert pol.n_prestage_flushes > 0 and pol.prestage_hits + pol.prestage_wasted > 0
    assert ctl.metrics() == jctl.metrics()
    assert np.array_equal(store.state.delta, jstore.state.delta)
    assert [h.latency_s for h in done] == [h.latency_s for h in jdone]
    assert np.array_equal(store.demand.od, jstore.demand.od)


# -------------------------------------------------- handles and remapping
@pytest.mark.parametrize("pkg", PKGS, ids=["port", "jax"])
def test_handles_are_futures(pkg):
    serve = pkg["serve"]
    store = _community_store(pkg, seed=1)
    ctl = serve.AdmissionController(store)
    client = serve.StoreClient(ctl)
    h = client.submit(store.workload.patterns[0].items, 0, at=5.0)
    assert not h.done and ctl.n_scheduled == 1 and ctl.pending == 0
    with pytest.raises(RuntimeError, match="pending"):
        h.value()
    res = client.result(h)
    assert h.done and res is h.result
    assert h.t_done >= h.t_dispatch >= h.t_submit == 5.0
    assert math.isfinite(h.latency_s) and h.latency_s >= 0.0
    assert h.priority == serve.INTERACTIVE and h.deadline_s == 0.25
    b = client.submit(store.workload.patterns[1].items, 1, priority=serve.BULK)
    assert b.deadline_s == 2.0


def test_deadline_accounting_equal():
    runs = []
    for pkg in PKGS:
        store = _community_store(pkg, seed=2)
        trace = [(t, it, o, 0, 1e-6) for t, it, o, _, _ in make_trace(store, "steady", 80, 3)]
        runs.append(_replay(pkg, store, trace, initial_batch=32, min_batch=2))
    _same_runs(*runs)
    ctl, done = runs[0]
    assert all(h.deadline_missed for h in done) and ctl.deadline_misses == 80
    assert ctl.batch_target == 2
    assert sum(ctl.misses_by_cause.values()) == 80


def _remap_run(pkg, seed=14):
    """Queued handles holding edge rows across a growth batch, then across
    a same-batch growth + reactive compaction, then a policy compaction in
    an idle gap: every surviving row keeps its uid."""
    serve = pkg["serve"]
    store = _traced_store(pkg, seed=seed, n_batches=1)
    ctl = serve.AdmissionController(store, serve.AdmissionConfig())
    assert ctl._remap_registered
    client = serve.StoreClient(ctl)
    rows = store.g.n_nodes + np.arange(0, 12, dtype=np.int64)
    uid0 = store._item_uid[rows].copy()
    handles = [client.submit(rows.copy(), 0, at=10.0) for _ in range(3)]
    store.apply_updates(pkg["churn"](store._delta_graph, 0.03, np.random.default_rng(5)))
    for h in handles:
        assert np.all(np.isin(store._item_uid[h.items], uid0))
    ctl.run_until_idle()
    store.compact_ratio = 1e-9
    h2 = client.submit(store.g.n_nodes + np.arange(0, 8, dtype=np.int64), 1, at=20.0)
    uid2 = store._item_uid[h2.items].copy()
    store.apply_updates(pkg["churn"](store._delta_graph, 0.03, np.random.default_rng(6)))
    assert np.all(np.isin(store._item_uid[h2.items], uid2))
    ctl.run_until_idle()
    # the policy compacts inside an idle gap while later requests are queued
    store.compact_ratio = 0.30  # tombstones stay for the policy to reclaim
    store.apply_updates(pkg["churn"](store._delta_graph, 0.03, np.random.default_rng(7)))
    policy = serve.MaintenancePolicy(store, serve.MaintenanceConfig(
        compact_ratio=1e-9, compact_cost_s=1e-6))
    ctl2 = serve.AdmissionController(store, serve.AdmissionConfig(), policy=policy)
    pats = [p for p in store.workload.patterns if len(p.items)]
    h3 = [serve.StoreClient(ctl2).submit_pattern(pats[i % len(pats)], 0, at=0.1 * (i + 1))
          for i in range(6)]
    ctl2.run_until_idle()
    return handles + [h2] + h3, store, policy


def test_remap_pending_items_across_growth_and_compaction():
    (hs, store, pol), (jhs, jstore, jpol) = (_remap_run(pkg) for pkg in PKGS)
    assert [h.items.tolist() for h in hs] == [h.items.tolist() for h in jhs]
    _same_results([h.result for h in hs], [h.result for h in jhs])
    assert all(h.done and h.result.n_missing == 0 for h in hs[:4])
    assert pol.n_compactions == jpol.n_compactions == 1
    assert store.tombstone_ratio() == jstore.tombstone_ratio() == 0.0
    assert np.array_equal(store.state.delta, jstore.state.delta)
    assert store.route_index.verify(store.state.delta)
    for h in hs:
        assert len(h.items) == 0 or int(h.items.max()) < store.g.n_items


def test_control_plane_exports_and_lazy_engine():
    for name in ("StoreClient", "AdmissionController", "AdmissionConfig", "MaintenancePolicy",
                 "MaintenanceConfig", "SimClock", "BatchRecord", "INTERACTIVE", "BULK",
                 "RequestHandle"):
        assert name in tserve.__all__ and hasattr(tserve, name)
    assert sorted(tserve.__all__) == sorted(jserve.__all__)
    code = ("import sys, repro_torch.serve as s\n"
            "assert 'repro_torch.serve.engine' not in sys.modules\n"
            "assert 'repro_torch.models.transformer' not in sys.modules\n"
            "assert s.engine is sys.modules['repro_torch.serve.engine']\n"
            "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(pathlib.Path(__file__).resolve().parents[1] / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, env=env)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
    with pytest.raises(AttributeError):
        tserve.nope  # noqa: B018
