"""Spans of the port's served read path and the controller's phase counters.

* ``Tracer`` on eight threads at once: unique span ids, each span parented
  to the span enclosing it on its own thread, an explicit ``parent=``
  honoured;
* one mixed-origin ``serve_batch`` of a five-shard store on the CPU, with
  the pool, without it, and by default (no pool: every shard on the host):
  one ``facade.serve_batch`` span, its five children on the calling thread
  (``facade.pool_wait`` tagged with the dispatch that ran), one
  ``shard.route`` per origin sub-batch parented to it, and the router's
  phases under each, with the path the item gate implies; results equal
  with the tracer on and off; the sub-batch over the gate folds its bytes
  on the card (``route.epilogue``'s ``fold`` tag, ``route.fold``);
* the controller's ``controller.*`` counters land in an injected enabled
  registry only, within the steps' wall time, and leave ``history``,
  ``metrics()`` and the sim-clock trace export as they were.
"""
import sys
import threading
import time

import numpy as np
import pytest

from repro_torch.core.graph import Graph, build_csr
from repro_torch.core.latency import make_paper_env
from repro_torch.core.patterns import Workload, generate_khop_patterns
from repro_torch.core.placement import PlacementConfig
from repro_torch.core.routing import FUSED_MIN_ITEMS
from repro_torch.core.store import GeoGraphStore
from repro_torch.distributed import ShardedGeoGraphStore
from repro_torch.obs import (
    MetricsRegistry,
    Tracer,
    export_chrome_trace,
    get_registry,
    set_default_registry,
)
from repro_torch.serve import AdmissionConfig, AdmissionController

FACADE_CHILDREN = {"facade.split", "facade.pool_wait", "facade.merge",
                   "facade.fetch_rows", "facade.observe"}
# reads per origin: one sub-batch over the item gate, some under it, one alone
READS_BY_ORIGIN = {0: 800, 1: 10, 2: 1, 3: 5, 4: 3}


def _inputs(seed, env):
    rng = np.random.default_rng(seed)
    src, dst = rng.integers(0, 220, 1400), rng.integers(0, 220, 1400)
    keep = src != dst
    g = Graph.from_edges(220, src[keep], dst[keep], partition=rng.integers(0, env.n_dcs, 220))
    csr = build_csr(g.n_nodes, g.src, g.dst, symmetrize=True)
    pats = generate_khop_patterns(g, csr, 24, seed=seed + 1, n_dcs=env.n_dcs)
    return g, Workload.from_patterns(pats, g.n_items, env.n_dcs), pats


def _sharded(tracer, parallel):
    env = make_paper_env()
    g, wl, pats = _inputs(7, env)
    store = ShardedGeoGraphStore(
        g, env, wl, config=PlacementConfig(precache=False, dhd_steps=4), n_shards=5,
        parallel=parallel, fetch_payload=True, device="cpu", tracer=tracer,
    )
    return store, pats


def _mixed_requests(pats):
    live = [p for p in pats if len(p.items)]
    rng = np.random.default_rng(3)
    reqs = [(live[int(rng.integers(0, len(live)))].items, o)
            for o, n in READS_BY_ORIGIN.items() for _ in range(n)]
    return [reqs[i] for i in rng.permutation(len(reqs))]


# ------------------------------------------------------------------ Tracer
def test_tracer_nests_per_thread_and_takes_an_explicit_parent():
    tracer = Tracer(enabled=True)
    with tracer.span("root") as root:
        pass
    n_threads, rounds = 8, 50
    barrier = threading.Barrier(n_threads)
    seen = {}  # thread -> [(outer sid, inner sids, adopted sid)]

    def work(k):
        barrier.wait(timeout=30)
        mine = []
        for _ in range(rounds):
            with tracer.span("outer", track=f"t{k}", thread=k) as outer:
                inner = []
                for _ in range(2):
                    with tracer.span("inner", track=f"t{k}", thread=k) as sp:
                        inner.append(sp.sid)
                with tracer.span("adopted", track=f"t{k}", parent=root.sid,
                                 thread=k) as adopted:
                    with tracer.span("under_adopted", track=f"t{k}", thread=k):
                        pass
            mine.append((outer.sid, inner, adopted.sid))
        seen[k] = mine

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(k,)) for k in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads) and len(seen) == n_threads
    recs = list(tracer.records)
    assert len(recs) == 1 + n_threads * rounds * 5
    by_sid = {r.sid: r for r in recs}
    assert len(by_sid) == len(recs)  # every id unique
    for k, mine in seen.items():
        for outer, inner, adopted in mine:
            assert by_sid[outer].parent is None and by_sid[outer].tags["thread"] == k
            assert all(by_sid[s].parent == outer for s in inner)
            assert by_sid[adopted].parent == root.sid  # explicit parent wins
    for r in recs:
        if r.name == "under_adopted":
            parent = by_sid[r.parent]
            assert parent.name == "adopted" and parent.tags["thread"] == r.tags["thread"]


def test_tracer_single_thread_records_are_unchanged():
    clock = iter(range(100)).__next__
    tracer = Tracer(clock=lambda: float(clock()), enabled=True)
    with tracer.span("a", track="x", k=1):
        with tracer.span("b"):
            pass
        sid = tracer.record("c", 0.5, 0.75, track="y", parent=None, z=2)
    got = [(r.sid, r.name, r.t0, r.t1, r.track, r.parent, r.tags) for r in tracer.records]
    assert got == [(1, "b", 1.0, 2.0, "main", 0, {}), (2, "c", 0.5, 0.75, "y", None, {"z": 2}),
                   (0, "a", 0.0, 3.0, "x", None, {"k": 1})]
    assert sid == 2
    tracer.reset()
    with tracer.span("d"):
        pass
    assert [(r.sid, r.parent) for r in tracer.records] == [(0, None)]
    off = Tracer(enabled=False)
    with off.span("e", parent=7) as sp:
        sp.tag(x=1)
    assert sp.sid is None and len(off) == 0


# ------------------------------------------------------- the facade's spans
@pytest.mark.parametrize("parallel", [True, False, None])
def test_facade_and_router_spans_of_one_mixed_batch(parallel):
    tracer = Tracer(clock=time.perf_counter, enabled=True)
    store, pats = _sharded(tracer, parallel)
    assert (store._pool is not None) == bool(parallel)
    reqs = _mixed_requests(pats)
    tracer.reset()
    got = store.serve_batch(reqs)
    recs = list(tracer.records)
    by_sid = {r.sid: r for r in recs}
    (root,) = [r for r in recs if r.name == "facade.serve_batch"]
    assert root.parent is None and root.tags == {"size": len(reqs), "n_origins": 5}
    children = [r for r in recs if r.parent == root.sid and r.name != "shard.route"]
    assert sorted(r.name for r in children) == sorted(FACADE_CHILDREN)
    assert all(root.t0 <= r.t0 <= r.t1 <= root.t1 for r in children)
    wait = next(r for r in children if r.name == "facade.pool_wait")
    assert wait.tags == {"dispatch": "pool" if parallel else "inline"}

    routes = [r for r in recs if r.name == "shard.route"]
    assert sorted(r.tags["origin"] for r in routes) == sorted(READS_BY_ORIGIN)
    for r in routes:
        assert r.parent == root.sid
        assert r.tags["reads"] == READS_BY_ORIGIN[r.tags["origin"]]
        assert r.tags["shard"] == store.origin_shard[r.tags["origin"]]
        assert 0.0 <= r.tags["cpu_s"] and wait.t0 <= r.t0 <= r.t1 <= wait.t1
    route_of = {r.sid: r for r in routes}

    gate = FUSED_MIN_ITEMS
    items_of = {}
    for items, o in reqs:
        items_of[o] = items_of.get(o, 0) + len(items)
    expands = [r for r in recs if r.name == "route.expand"]
    assert len(expands) == len(routes)
    for r in expands:
        reads = route_of[r.parent].tags["reads"]
        items = items_of[route_of[r.parent].tags["origin"]]
        want = "scalar" if reads == 1 else "fused" if items >= gate else "numpy"
        assert r.tags == {"path": want, "reads": reads, "items": items}
        kids = sorted(c.name for c in recs if c.parent == r.sid)
        assert kids == (["route.device"] if want == "fused" else [])
        if want == "fused":
            (dev,) = [c for c in recs if c.parent == r.sid and c.name == "route.device"]
            # on the CPU the store hands the router its tables there: the
            # kernel's plain version over them
            assert dev.tags == {"layout": "ragged", "variant": "ragged_plain", "slots": items,
                                "reads": reads, "layers": store.lg.n_layers}
    assert {"fused", "numpy", "scalar"} <= {r.tags["path"] for r in expands}
    slots = {k: v for k, v in tracer.counters.items() if k[0] == "route.device_slots"}
    assert slots == {("route.device_slots", (("variant", "ragged_plain"),)):
                     sum(r.tags["items"] for r in expands if r.tags["path"] == "fused")}
    for r in recs:
        if r.name in ("route.prologue", "route.epilogue"):
            assert route_of[r.parent].tags["reads"] > 1
    assert {r.name for r in recs} == ({"facade.serve_batch", "shard.route", "route.expand",
                                       "route.device", "route.prologue", "route.epilogue"}
                                      | FACADE_CHILDREN)
    assert all(by_sid.get(r.parent) is not None for r in recs if r is not root)

    # the same batch with the tracer off: the same results, no span
    store.tracer = Tracer(enabled=False)
    again = store.serve_batch(reqs)
    assert len(store.tracer) == 0
    for a, b in zip(got, again):
        assert np.array_equal(a.served_by, b.served_by) and a.latency_s == b.latency_s
        assert (a.wan_bytes, a.layers_used, a.n_missing) == (b.wan_bytes, b.layers_used,
                                                              b.n_missing)
        assert a.per_dc_latency == b.per_dc_latency


def test_sub_batch_over_the_gate_folds_its_bytes_on_the_card():
    """A traced sharded run on the CPU: the sub-batch over the item gate
    takes the kernel's sums (``route.epilogue`` tagged ``fold="card"``,
    ``route.fold`` counted once), the numpy sub-batches fold on the host,
    and the results equal the host fold's."""
    tracer = Tracer(clock=time.perf_counter, enabled=True)
    store, pats = _sharded(tracer, None)
    assert store.route_tables.shift is not None
    reqs = _mixed_requests(pats)
    tracer.reset()
    got = store.serve_batch(reqs)
    recs = list(tracer.records)
    expand_of = {r.parent: r.tags["path"] for r in recs if r.name == "route.expand"}
    folds = {expand_of[r.parent]: r.tags["fold"] for r in recs if r.name == "route.epilogue"}
    assert folds == {"fused": "card", "numpy": "host"}
    counts = {k: v for k, v in tracer.counters.items() if k[0] == "route.fold"}
    assert counts == {("route.fold", (("where", "card"),)): 1}

    # the same batch over the host fold: the tables' shift forgotten
    rt = store.route_tables
    shift = rt.shift
    for dev, t in list(rt.device_tables.items()):
        rt.device_tables[dev] = t._replace(shift=None)
    tracer.reset()
    try:
        again = store.serve_batch(reqs)
    finally:
        for dev, t in list(rt.device_tables.items()):
            rt.device_tables[dev] = t._replace(shift=shift)
    counts = {k: v for k, v in tracer.counters.items() if k[0] == "route.fold"}
    assert counts == {("route.fold", (("where", "host"),)): 1}
    for a, b in zip(got, again):
        assert np.array_equal(a.served_by, b.served_by) and a.latency_s == b.latency_s
        assert (a.wan_bytes, a.n_missing) == (b.wan_bytes, b.n_missing)
        assert a.per_dc_latency == b.per_dc_latency


def test_flat_store_router_spans_nest_under_its_serve_batch():
    env = make_paper_env()
    g, wl, pats = _inputs(9, env)
    tracer = Tracer(enabled=True)
    store = GeoGraphStore(g, env, wl, config=PlacementConfig(precache=False, dhd_steps=4),
                          device="cpu", tracer=tracer)
    tracer.reset()
    reqs = _mixed_requests(pats)[:40]
    store.serve_batch(reqs)
    recs = list(tracer.records)
    (root,) = [r for r in recs if r.name == "store.serve_batch"]
    assert sorted(r.name for r in recs if r.parent == root.sid) == [
        "route.epilogue", "route.expand", "route.prologue"]
    (expand,) = [r for r in recs if r.name == "route.expand"]
    items = sum(len(it) for it, _ in reqs)
    want = "fused" if items >= FUSED_MIN_ITEMS else "numpy"
    assert expand.tags == {"path": want, "reads": 40, "items": items}


# ------------------------------------------------- the controller's counters
def _controller_run(registry, wall_clock=time.perf_counter):
    env = make_paper_env()
    g, wl, pats = _inputs(11, env)
    store = GeoGraphStore(g, env, wl, config=PlacementConfig(precache=False, dhd_steps=4),
                          device="cpu")
    tracer = Tracer(enabled=True)
    ctl = AdmissionController(store, AdmissionConfig(initial_batch=4, max_batch=32),
                              tracer=tracer, registry=registry, wall_clock=wall_clock)
    live = [p for p in pats if len(p.items)]
    for i in range(150):
        p = live[i % len(live)]
        ctl.submit(p.items, int(np.argmax(p.r_py)), at=1e-4 * i)
    wall = 0.0
    while ctl.pending or ctl.n_scheduled:
        t = time.perf_counter()
        ctl.step()
        wall += time.perf_counter() - t
    return ctl, tracer, wall


def test_controller_counters_go_to_the_injected_registry_only():
    old = set_default_registry(MetricsRegistry(enabled=True))
    try:
        reg = MetricsRegistry(enabled=True)
        ctl, tracer, wall = _controller_run(reg)
        snap = reg.snapshot()
        phases = sum(snap[f"controller.{p}_s"]["-"]["value"] for p in ("admit", "form", "book"))
        assert 0.0 < phases <= wall
        assert {k for k in snap if k.startswith("controller.")} == {
            "controller.admit_s", "controller.form_s", "controller.book_s"}
        assert ctl.completed == 150
        assert not any(k.startswith("controller.") for k in get_registry().snapshot())
        assert not any(r.name.startswith("controller.") for r in tracer.records)

        # none injected: the default registry, though enabled, gets nothing
        bare, bare_tracer, _ = _controller_run(None)
        assert not any(k.startswith("controller.") for k in get_registry().snapshot())
    finally:
        set_default_registry(old)
    assert list(bare.history) == list(ctl.history)
    assert bare.metrics() == ctl.metrics()
    assert export_chrome_trace(bare_tracer) == export_chrome_trace(tracer)


def test_controller_counters_off_leave_the_wall_clock_alone():
    """A disabled registry reads the injected wall clock no more often than
    none at all."""
    calls = []

    def counting_clock():
        calls.append(1)
        return float(len(calls))

    _controller_run(MetricsRegistry(enabled=False), counting_clock)
    n_off = len(calls)
    calls.clear()
    _controller_run(None, counting_clock)
    assert len(calls) == n_off
