"""The port's ShardedGeoGraphStore against the JAX package's, on the CPU.

Each test builds its stores from fresh seeded inputs (stores mutate their
graph in place): the JAX package's sharded store, the port's sharded store
(``device="cpu"``, every shard on the host) and, where stated, the port's
unsharded ``GeoGraphStore``.  Exact unless stated:

  * at 1, 2, 4 and 5 shards: replica sets, the shard partitions' route
    table, ``state.route`` and served results, before and after churn;
  * through churn, ``flush_migrations`` and ``begin_flush`` wave by wave
    (payload blocks bit-equal to the JAX package's after every wave: fp32
    exact, int8 with q and scale bit-equal, held rows within 1/127), the
    per-link wire bytes, ``maintain`` evictions, ``delete_items``,
    ``compact`` and the ``insert_patterns`` rebind;
  * merged metrics count every request; parallel dispatch equals serial;
    by default shards that share one device route on the calling thread,
    and only shards over two or more devices get the pool;
  * ``per_shard_aimd`` targets and straggler attribution, on a stub and on
    the real store behind the admission controller;
  * the single-origin sub-batches with the route fast path pinned, through
    the route-expansion kernel's wrapper (its plain version on the CPU);
  * a request alone in its origin's sub-batch takes the scalar router in
    both packages, whose f32 byte sums differ from the batch fold's f64
    ones in the low bits (within rtol 1e-5).
"""
import numpy as np
import pytest
import torch

from repro.core.graph import Graph as JGraph
from repro.core.graph import build_csr as j_build_csr
from repro.core.latency import make_paper_env as j_paper_env
from repro.core.patterns import Workload as JWorkload
from repro.core.patterns import generate_khop_patterns as j_khop
from repro.core.placement import PlacementConfig as JPlacementConfig
from repro.core.routing import RouteResult as JRouteResult
from repro.distributed import ShardedGeoGraphStore as JSharded
from repro.distributed.fault import StragglerDetector as JStragglerDetector
from repro.distributed.geo_sharding import mesh_env as j_mesh_env
from repro.serve import AdmissionConfig as JAdmissionConfig
from repro.serve import AdmissionController as JAdmissionController
from repro.streaming import DeltaGraph as JDeltaGraph
from repro.streaming import random_churn_batch as j_churn_batch
from repro_torch.core.graph import Graph, build_csr
from repro_torch.core.latency import make_paper_env
from repro_torch.core.patterns import Workload, generate_khop_patterns
from repro_torch.core.placement import PlacementConfig
from repro_torch.core.routing import RouteResult
from repro_torch.core.store import GeoGraphStore
from repro_torch.distributed import ShardedGeoGraphStore, payload_for_uids
from repro_torch.distributed import sharded_store
from repro_torch.distributed.fault import StragglerDetector
from repro_torch.distributed.geo_sharding import mesh_env
from repro_torch.serve import AdmissionConfig, AdmissionController
from repro_torch.streaming import DeltaGraph, random_churn_batch

PORT = dict(Graph=Graph, csr=build_csr, khop=generate_khop_patterns, Workload=Workload,
            Config=PlacementConfig, Sharded=ShardedGeoGraphStore, DeltaGraph=DeltaGraph,
            churn=random_churn_batch, kw=dict(device="cpu"))
JAX = dict(Graph=JGraph, csr=j_build_csr, khop=j_khop, Workload=JWorkload,
           Config=JPlacementConfig, Sharded=JSharded, DeltaGraph=JDeltaGraph,
           churn=j_churn_batch, kw={})


# --------------------------------------------------------------- scaffolding
def _inputs(pkg, seed, env, part_dcs=None):
    rng = np.random.default_rng(seed)
    src, dst = rng.integers(0, 220, 1400), rng.integers(0, 220, 1400)
    keep = src != dst
    g = pkg["Graph"].from_edges(220, src[keep], dst[keep],
                                partition=rng.integers(0, part_dcs or env.n_dcs, 220))
    csr = pkg["csr"](g.n_nodes, g.src, g.dst, symmetrize=True)
    pats = pkg["khop"](g, csr, 24, seed=seed + 1, n_dcs=env.n_dcs)
    return g, pkg["Workload"].from_patterns(pats, g.n_items, env.n_dcs), pats


def _sharded(pkg, seed, env, n_shards, part_dcs=None, **kw):
    g, wl, pats = _inputs(pkg, seed, env, part_dcs)
    cfg = pkg["Config"](precache=False, dhd_steps=4)
    return pkg["Sharded"](g, env, wl, config=cfg, n_shards=n_shards, **kw, **pkg["kw"]), pats


def _unsharded(seed, env, part_dcs=None):
    g, wl, _ = _inputs(PORT, seed, env, part_dcs)
    return GeoGraphStore(g, env, wl, config=PlacementConfig(precache=False, dhd_steps=4),
                         device="cpu")


def _churn(store, pkg, seed, n_batches=2, rate=0.02):
    rng = np.random.default_rng(seed + 100)
    store._delta_graph = pkg["DeltaGraph"](store.g)
    for _ in range(n_batches):
        store.apply_updates(pkg["churn"](store._delta_graph, rate, rng))


def _requests(pats, n_dcs, n, seed):
    """65% home-origin / 35% uniform request mix."""
    rng = np.random.default_rng(seed)
    live = [p for p in pats if len(p.items)]
    out = []
    for _ in range(n):
        p = live[int(rng.integers(0, len(live)))]
        home = int(np.argmax(p.r_py))
        out.append((p.items, home if rng.random() < 0.65 else int(rng.integers(0, n_dcs))))
    return out


def _same_results(r1, r2):
    assert len(r1) == len(r2)
    for a, b in zip(r1, r2):
        assert np.array_equal(a.served_by, b.served_by)
        assert a.latency_s == b.latency_s  # float-identical, not approx
        assert a.per_dc_latency == b.per_dc_latency
        assert (a.wan_bytes, a.layers_used, a.n_missing) == (b.wan_bytes, b.layers_used,
                                                              b.n_missing)
        assert np.array_equal(np.sort(a.dcs), np.sort(b.dcs))


def _same_state(port, ref):
    assert np.array_equal(port.state.delta, ref.state.delta)
    assert np.array_equal(port.route_table(), ref.route_table())
    assert np.array_equal(port.state.route, ref.state.route)
    assert np.array_equal(port.route_table(), port.state.route)
    assert port.verify_partitions() and ref.verify_partitions()


def _same_payloads(port, ref):
    """Every shard's payload block bit-equal to the JAX package's."""
    assert [s.dcs for s in port.shards] == [s.dcs for s in ref.shards]
    for ps, js in zip(port.shards, ref.shards):
        assert ps.payload.dtype.itemsize == 4 and ps.payload.device.type == "cpu"
        assert ps.payload.numpy().tobytes() == np.asarray(js.payload, np.float32).tobytes()
    assert port.verify_payloads() == ref.verify_payloads()


def _tight_window(store, n_items_per_wave=3.0):
    med = float(np.median(store.g.item_size()))
    return n_items_per_wave * med / float(store.env.bw_Bps_safe().min())


# ------------------------------------------------- identity at shard counts
@pytest.mark.parametrize("n_shards", [1, 2, 4, 5])
def test_identity_across_shard_counts(n_shards):
    """The port's sharded store at 1/2/4/5 shards == the JAX package's at the
    same count == the port's unsharded store, before and after churn."""
    env = make_paper_env()
    port, pats = _sharded(PORT, 20, env, n_shards, part_dcs=4)
    ref, _ = _sharded(JAX, 20, j_paper_env(), n_shards, part_dcs=4)
    flat = _unsharded(20, env, part_dcs=4)
    assert port.origin_shard == ref.origin_shard == {d: d % n_shards for d in range(5)}
    _same_state(port, ref)
    assert np.array_equal(port.state.delta, flat.state.delta)
    reqs = _requests(pats, env.n_dcs, 96, seed=21)
    got = port.serve_batch(reqs)
    _same_results(got, ref.serve_batch(reqs))
    _same_results(got, flat.serve_batch(reqs))
    for s, pkg in ((port, PORT), (ref, JAX), (flat, PORT)):
        _churn(s, pkg, 22)
    _same_state(port, ref)
    assert np.array_equal(port.state.route, flat.state.route)
    _same_payloads(port, ref)
    got = port.serve_batch(reqs)
    _same_results(got, ref.serve_batch(reqs))
    _same_results(got, flat.serve_batch(reqs))
    for o in range(env.n_dcs):  # both observe paths deposit the same heat
        assert np.array_equal(port.caches[o].heat, flat.caches[o].heat)


def test_mesh_env_grouping_and_devices():
    """A 3-shard store on an 8-DC mesh groups DCs round-robin; every shard
    lives on the host when the store runs there."""
    env = mesh_env(8, shards_per_pod=4)
    port, pats = _sharded(PORT, 30, env, 3)
    ref, _ = _sharded(JAX, 30, j_mesh_env(8, shards_per_pod=4), 3)
    assert port.origin_shard == {d: d % 3 for d in range(8)}
    assert sorted(d for s in port.shards for d in s.dcs) == list(range(8))
    assert all(s.device.type == "cpu" for s in port.shards)
    assert port.device.type == "cpu"  # the coordinator's device, delegated
    reqs = _requests(pats, 8, 32, seed=31)
    r = port.serve_batch(reqs)
    assert all(isinstance(x, RouteResult) for x in r)
    _same_results(r, ref.serve_batch(reqs))


# ------------------------------------------ identity: full mutation cycle
@pytest.mark.parametrize("n_shards,compress", [(2, "int8"), (5, None)])
def test_identity_through_churn_flush_maintain_delete_compact(n_shards, compress):
    env = make_paper_env()
    kw = dict(telemetry=True, compress=compress)
    port, pats = _sharded(PORT, 6, env, n_shards, part_dcs=4, **kw)
    ref, _ = _sharded(JAX, 6, j_paper_env(), n_shards, part_dcs=4, **kw)
    _churn(port, PORT, 6), _churn(ref, JAX, 6)
    _same_state(port, ref)
    assert port.verify_payloads() == 0.0
    _same_payloads(port, ref)

    plan_kw = dict(theta_add=0.3, theta_drop=0.15)
    window = _tight_window(ref)
    p1 = ref.flush_migrations(window_s=window, **plan_kw)
    p2 = port.flush_migrations(window_s=window, **plan_kw)
    assert p1.n_adds == p2.n_adds > 0
    assert p1.schedule.n_waves == p2.schedule.n_waves >= 1
    _same_state(port, ref)
    tol = 0.0 if compress is None else 1.0 / 127.0
    assert 0 <= port.verify_payloads() <= tol
    _same_payloads(port, ref)
    assert port.merged_metrics()["migration.device_bytes_link"] == ref.merged_metrics()[
        "migration.device_bytes_link"]
    moved = sum(v["value"] for v in port.merged_metrics()["migration.device_bytes_link"].values())
    if compress is None:
        assert moved == p2.n_adds * port.payload_width * 4
    else:
        assert 0 < moved < p2.n_adds * port.payload_width * 4

    reqs = _requests(pats, env.n_dcs, 64, seed=61)
    _same_results(port.serve_batch(reqs), ref.serve_batch(reqs))

    assert port.maintain() == ref.maintain()
    _same_state(port, ref)
    _same_payloads(port, ref)

    ids = np.arange(0, ref.g.n_items, 5)
    port.delete_items(ids), ref.delete_items(ids)
    _same_state(port, ref)
    _same_payloads(port, ref)
    fired = (port.compact(), ref.compact())
    assert fired[0] == fired[1] is True
    _same_state(port, ref)
    assert port.verify_payloads() == 0.0  # re-materialised from the uids
    _same_payloads(port, ref)
    reqs2 = [(np.clip(it, 0, ref.g.n_items - 1), o) for it, o in reqs]
    _same_results(port.serve_batch(reqs2), ref.serve_batch(reqs2))


@pytest.mark.parametrize("compress", [None, "int8"])
def test_begin_flush_wave_by_wave(compress):
    """After every wave each shard's block is bit-equal to the JAX
    package's, and the held rows match their uid content (fp32 exactly,
    int8 within 1/127)."""
    env = make_paper_env()
    port, _ = _sharded(PORT, 7, env, 3, part_dcs=4, telemetry=True, compress=compress)
    ref, _ = _sharded(JAX, 7, j_paper_env(), 3, part_dcs=4, telemetry=True, compress=compress)
    _churn(port, PORT, 7), _churn(ref, JAX, 7)
    plan_kw = dict(theta_add=0.3, theta_drop=0.15)
    window = _tight_window(ref)
    p1, a1 = ref.begin_flush(window_s=window, **plan_kw)
    p2, a2 = port.begin_flush(window_s=window, **plan_kw)
    assert a1.n_remaining == a2.n_remaining >= 2
    assert port.verify_payloads() == 0.0
    while a2.n_remaining:
        w1, w2 = a1.apply_next(), a2.apply_next()
        assert [(b.src, b.dst, b.items.tolist()) for b in w1.links] == [
            (b.src, b.dst, b.items.tolist()) for b in w2.links]
        _same_payloads(port, ref)
        assert port.verify_payloads() <= (0.0 if compress is None else 1.0 / 127.0)
        assert np.array_equal(ref.state.route, port.route_table())
    a1.finish(), a2.finish()
    _same_state(port, ref)
    _same_payloads(port, ref)
    waves = port.registry.snapshot()["migration.device_waves"]["-"]["value"]
    assert waves == p2.schedule.n_waves == p1.schedule.n_waves


def test_insert_patterns_rebinds_partitions_and_payload():
    env, jenv = mesh_env(4), j_mesh_env(4)
    port, pats = _sharded(PORT, 40, env, 2)
    ref, _ = _sharded(JAX, 40, jenv, 2)

    def fresh(store, pkg):
        csr = pkg["csr"](store.g.n_nodes, store.g.src, store.g.dst, symmetrize=True)
        return pkg["khop"](store.g, csr, 10, seed=41, n_dcs=4)

    pn, rn = fresh(port, PORT), fresh(ref, JAX)
    old_index = port.route_index
    port.insert_patterns(pn[:6]), ref.insert_patterns(rn[:6])
    assert port.route_index is not old_index  # the facade re-bound to the new index
    _same_state(port, ref)
    assert port.verify_payloads() == 0.0
    _same_payloads(port, ref)
    assert port.insert_patterns_incremental(pn[6:10])["rows_changed"] == \
        ref.insert_patterns_incremental(rn[6:10])["rows_changed"]
    _same_state(port, ref)
    reqs = _requests(pats, 4, 48, seed=42)
    _same_results(port.serve_batch(reqs), ref.serve_batch(reqs))


def test_constructor_rejects_bad_configs():
    env = mesh_env(4)
    g, wl, _ = _inputs(PORT, 60, env)
    cfg = PlacementConfig(precache=False, dhd_steps=4)
    for kw, match in ((dict(routing="flat"), "route index"), (dict(n_shards=9), "n_shards"),
                      (dict(compress="zstd"), "compression")):
        with pytest.raises(ValueError, match=match):
            ShardedGeoGraphStore(g, env, wl, config=cfg, device="cpu", **kw)


def test_payload_for_uids_equal_to_reference():
    from repro.distributed import payload_for_uids as j_payload

    uids = np.array([0, 1, 2**40, 7, 123456789])
    for width in (4, 8):
        rows = payload_for_uids(uids, width=width)
        assert rows.dtype == np.float32 and (0 <= rows).all() and (rows < 1).all()
        assert rows.tobytes() == j_payload(uids, width=width).tobytes()


# ------------------------------------------------------------------ metrics
def test_merged_metrics_account_every_request():
    env = mesh_env(8, shards_per_pod=4)
    port, pats = _sharded(PORT, 70, env, 4, telemetry=True)
    ref, _ = _sharded(JAX, 70, j_mesh_env(8, shards_per_pod=4), 4, telemetry=True)
    reqs = _requests(pats, 8, 80, seed=71)
    for s in (port, ref):
        s.serve_batch(reqs)
        s.serve_batch(reqs[:20])
    merged, jmerged = port.merged_metrics(), ref.merged_metrics()
    assert merged["serving.requests"]["-"]["value"] == 100.0
    assert merged["serving.requests"] == jmerged["serving.requests"]
    per_shard = [s.registry.snapshot().get("serving.requests", {}).get("-", {})
                 .get("value", 0.0) for s in port.shards]
    assert per_shard == [s.registry.snapshot().get("serving.requests", {}).get("-", {})
                         .get("value", 0.0) for s in ref.shards]
    assert sum(per_shard) == 100.0 and sum(1 for v in per_shard if v) > 1
    assert merged["serving.request_latency_s"]["-"]["count"] == 100.0
    assert merged["serving.wan_bytes"] == jmerged["serving.wan_bytes"]
    # fetch path: serving with payload reads changes no result
    port.fetch_payload = True
    assert "fetch_payload" not in port._store.__dict__  # the facade owns it
    _same_results(port.serve_batch(reqs[:8], observe=False), ref.serve_batch(reqs[:8]))


def test_parallel_dispatch_matches_serial():
    env = mesh_env(8, shards_per_pod=4)
    serial, pats = _sharded(PORT, 50, env, 4, parallel=False)
    threaded, _ = _sharded(PORT, 50, env, 4, parallel=True)
    assert serial._pool is None and threaded._pool is not None
    reqs = _requests(pats, 8, 128, seed=51)
    _same_results(serial.serve_batch(reqs), threaded.serve_batch(reqs))
    for o in range(env.n_dcs):
        assert np.array_equal(serial.caches[o].heat, threaded.caches[o].heat)
    assert set(threaded.last_shard_seconds) == set(serial.last_shard_seconds)
    assert threaded.last_serve_seconds == max(threaded.last_shard_seconds.values())


def test_default_dispatch_on_one_device_routes_inline(monkeypatch):
    asked, rule = [], sharded_store._dispatch_on_pool

    def spy(devices):
        asked.append(list(devices))
        return rule(devices)

    monkeypatch.setattr(sharded_store, "_dispatch_on_pool", spy)
    env = mesh_env(8, shards_per_pod=4)
    inline, pats = _sharded(PORT, 50, env, 4)
    threaded, _ = _sharded(PORT, 50, env, 4, parallel=True)
    assert asked == [[torch.device("cpu")] * 4]  # parallel=True asks nothing
    assert inline._pool is None and threaded._pool is not None
    reqs = _requests(pats, 8, 128, seed=51)
    _same_results(inline.serve_batch(reqs), threaded.serve_batch(reqs))
    for o in range(env.n_dcs):
        assert np.array_equal(inline.caches[o].heat, threaded.caches[o].heat)
    assert set(inline.last_shard_seconds) == set(threaded.last_shard_seconds)
    assert len(inline.last_shard_seconds) > 1
    assert inline.last_serve_seconds == max(inline.last_shard_seconds.values())


@pytest.mark.parametrize("devices, pooled", [
    (["cpu"] * 5, False),
    (["cuda:0"] * 5, False),
    (["cuda:0", "cuda:1", "cuda:2", "cuda:3", "cuda:0"], True),
    (["cuda:0", "cuda:1"], True),
    (["cpu", "cuda:0"], True),
])
def test_dispatch_rule_pools_only_across_devices(devices, pooled):
    assert sharded_store._dispatch_on_pool([torch.device(d) for d in devices]) is pooled


# --------------------------------------------------- per-shard admission
class _StubShardStore:
    """Two-shard stub with a slow shard, feeding the detector as the sharded
    store feeds measured times; ``result`` builds each package's result."""

    def __init__(self, detector, result, slow_factor=20.0):
        self.origin_shard = {0: 0, 1: 1}
        self.straggler = detector(2, threshold=1.8)
        self.result = result
        self.slow_factor = slow_factor

    def serve_batch(self, reqs):
        out = []
        for items, origin in reqs:
            shard = self.origin_shard[origin]
            base = 0.002 if shard == 0 else 0.002 * self.slow_factor
            self.straggler.observe(shard, base)
            out.append(self.result(
                served_by=np.zeros(len(items), dtype=np.int64), dcs=np.array([origin]),
                latency_s=base, per_dc_latency={origin: base}, layers_used=0,
                n_missing=0, wan_bytes=0.0))
        return out


def test_per_shard_aimd_straggler_attribution_equal_to_reference():
    metrics = []
    for Controller, Config, Det, Res in (
        (AdmissionController, AdmissionConfig, StragglerDetector, RouteResult),
        (JAdmissionController, JAdmissionConfig, JStragglerDetector, JRouteResult),
    ):
        cfg = Config(per_shard_aimd=True, initial_batch=4, max_batch=64,
                     default_deadlines=(0.012,))
        ctl = Controller(_StubShardStore(Det, Res), cfg)
        rng = np.random.default_rng(0)
        for i in range(200):
            ctl.submit(np.arange(3), origin=int(rng.integers(0, 2)), at=1e-3 * i)
        ctl.run_until_idle()
        metrics.append((ctl.metrics(), [tuple(vars(b).values()) for b in ctl.history]))
    (m, hist), (jm, jhist) = metrics
    assert m == jm and hist == jhist
    assert m["completed"] == 200
    assert sum(m["misses_by_cause"].values()) == m["deadline_misses"]
    targets = m["batch_target_by_shard"]
    assert targets[1] < targets[0] and targets[0] > 4
    assert 1 in m["straggler_shards"] and m["straggler_misses_by_shard"].get(1, 0) > 0


def test_controller_drives_sharded_store_end_to_end():
    """Controller -> sharded serve -> straggler feed -> per-shard targets on
    the real data plane; the formed batches and every result equal the JAX
    package's (miss causes read wall-clock shard times, so they are not
    compared)."""
    runs = []
    for pkg, env, Controller, Config in (
        (PORT, mesh_env(8, shards_per_pod=4), AdmissionController, AdmissionConfig),
        (JAX, j_mesh_env(8, shards_per_pod=4), JAdmissionController, JAdmissionConfig),
    ):
        store, pats = _sharded(pkg, 80, env, 4, telemetry=True)
        ctl = Controller(store, Config(per_shard_aimd=True, initial_batch=4, max_batch=32))
        for i, (items, o) in enumerate(_requests(pats, 8, 120, seed=81)):
            ctl.submit(items, o, at=2e-4 * i)
        done = ctl.run_until_idle()
        m = ctl.metrics()
        assert m["completed"] == len(done) == 120
        assert sum(m["misses_by_cause"].values()) == m["deadline_misses"]
        assert (store.straggler.lat > 0).sum() == len(m["batch_target_by_shard"])
        assert store.merged_metrics()["serving.requests"]["-"]["value"] == 120.0
        runs.append((done, [(b.t_dispatch, b.size, b.target) for b in ctl.history],
                     m["batch_target_by_shard"], m["p99_s"]))
    (done, hist, targets, p99), (jdone, jhist, jtargets, jp99) = runs
    assert hist == jhist and targets == jtargets and p99 == jp99
    assert [h.rid for h in done] == [h.rid for h in jdone]
    _same_results([h.result for h in done], [h.result for h in jdone])


# ------------------------------------------------- kernels fast-path parity
@pytest.mark.parametrize("n_shards", [2, 5])
def test_single_origin_fast_path_through_the_kernel_wrapper(n_shards, monkeypatch):
    """The item gate opened from 1 item up: every sub-batch of two or more
    requests goes through the ragged route-expansion kernel's wrapper over
    the coordinator's route tables (its plain version on CPU tensors),
    float-identical to the JAX package's unsharded store on the numpy
    path."""
    from repro.core.store import GeoGraphStore as JStore
    from repro_torch.core import routing
    from repro_torch.kernels import ops

    env = make_paper_env()
    port, pats = _sharded(PORT, 60, env, n_shards, part_dcs=4)
    g, wl, _ = _inputs(JAX, 60, j_paper_env(), 4)
    ref = JStore(g, j_paper_env(), wl, config=JPlacementConfig(precache=False, dhd_steps=4))
    reqs = _requests(pats, env.n_dcs, 96, seed=61)
    want = ref.serve_batch(reqs)
    calls = []
    wrapper = ops._route_expand_ragged_kernel
    monkeypatch.setattr(ops, "_route_expand_ragged_kernel",
                        lambda *a, **kw: calls.append(a[0].shape) or wrapper(*a, **kw))
    monkeypatch.setattr(routing, "FUSED_MIN_ITEMS", 1)
    got = port.serve_batch(reqs)
    _same_results(got, want)
    sub_batches = {o for _, o in reqs}
    assert len(calls) == len(sub_batches)  # one ragged launch per origin sub-batch
    assert port.last_serve_seconds == max(port.last_shard_seconds.values())


def test_request_alone_in_its_origin_takes_the_scalar_router():
    """A behaviour of the JAX package that the port keeps: a request alone
    in its origin's sub-batch goes through the scalar router, which sums
    item bytes in f32, where the batch router's fold sums them in f64.  Its
    latency then matches the unsharded batch to f32 summation, not to the
    bit.  Port and JAX sharded stores agree exactly, both equal the scalar
    router, and in both packages some latencies differ from the batch fold
    within rtol 1e-5."""
    from repro.core.routing import route_online as j_route_online
    from repro.core.store import GeoGraphStore as JStore
    from repro.data.synthetic import community_graph as j_community
    from repro_torch.core.routing import route_online
    from repro_torch.data.synthetic import community_graph

    def build(pkg, community, Store, sharded):
        g = community(400, n_communities=8, p_in=0.04, p_out=0.001, seed=0, n_dcs=5)
        env = make_paper_env() if pkg is PORT else j_paper_env()
        csr = pkg["csr"](g.n_nodes, g.src, g.dst, symmetrize=True)
        pats = pkg["khop"](g, csr, 24, seed=1, n_dcs=5)
        wl = pkg["Workload"].from_patterns(pats, g.n_items, 5)
        cfg = pkg["Config"](precache=False, dhd_steps=4)
        if sharded:
            return pkg["Sharded"](g, env, wl, config=cfg, parallel=False, **pkg["kw"]), pats
        return Store(g, env, wl, config=cfg, **pkg["kw"]), pats

    port, pats = build(PORT, community_graph, None, True)
    ref, _ = build(JAX, j_community, None, True)
    flat, _ = build(PORT, community_graph, GeoGraphStore, False)
    jflat, _ = build(JAX, j_community, JStore, False)
    live = [p for p in pats if len(p.items)]
    differ = {"port": 0, "jax": 0}
    for i, p in enumerate(live):
        reqs = [(p.items, 0), (live[(i + 1) % len(live)].items, 1),
                (live[(i + 2) % len(live)].items, 1)]
        got, want = port.serve_batch(reqs, observe=False), ref.serve_batch(reqs, observe=False)
        _same_results(got, want)
        _same_results(got[:1], [route_online(port.lg, port.state, p.items, 0)])
        _same_results(want[:1], [j_route_online(ref.lg, ref.state, p.items, 0)])
        for name, sharded, batch in (("port", got, flat.serve_batch(reqs, observe=False)),
                                     ("jax", want, jflat.serve_batch(reqs, observe=False))):
            a, b = sharded[0], batch[0]
            assert np.array_equal(a.served_by, b.served_by)
            assert a.latency_s == pytest.approx(b.latency_s, rel=1e-5, abs=0)
            assert a.wan_bytes == pytest.approx(b.wan_bytes, rel=1e-5, abs=0)
            differ[name] += a.latency_s != b.latency_s
            _same_results(sharded[1:], batch[1:])  # two requests: the batch fold
    assert differ["port"] == differ["jax"] > 0
