"""The router's fused form, item ids over route tables keyed by item id,
on the CPU.

* the id-keyed plain version (``ops.route_expand_flat_ids``, the kernel's
  plain version) equals the numpy router bit for bit: picks, layers used
  and missing counts, and through ``route_online_batch`` every
  ``RouteResult`` field, on reads a warp walks (up to 256 items), reads a
  block walks, and the 26,182-item read of ``snb-sf3-5shard-nbr``;
  ``fast=True`` without tables raises;
* a store's ``RouteTables`` follow each ``RouteIndex`` event kind (``rows``
  through ``maintain()``, ``delete_items`` and a migration wave, ``grow``
  through ``apply_updates()``, ``take`` through a compaction, ``rebuild``
  through a re-derived index and a full re-place): after each, the bitmask
  table equals the bit-packed ``state.delta``, the byte tables equal
  ``g.item_size()``, and routing with the tables equals the numpy router on
  the fresh ``state.delta``.  A store keeps its tables on its own device,
  the CPU here, where they follow the events by the code a card's do;
* who takes which path: the store hands its tables with its current index
  on any device, so a flat or sharded store on the CPU routes a batch over
  the gate in the fused form over its own tables; without a route index, or
  past the kernel's DC or layer limits, no tables are handed and the router
  routes on numpy.
"""
import types

import numpy as np
import pytest
import torch

from repro_torch.core.graph import build_csr
from repro_torch.core.latency import make_paper_env
from repro_torch.core.layered_graph import build_layered_graph
from repro_torch.core.patterns import Pattern, Workload, generate_khop_patterns
from repro_torch.core.placement import PlacementConfig
from repro_torch.core import routing
from repro_torch.core.route_tables import RouteTables, _bit_pack
from repro_torch.core.routing import _expand_numpy, route_online_batch
from repro_torch.core.store import GeoGraphStore
from repro_torch.data.synthetic import community_graph
from repro_torch.distributed.sharded_store import ShardedGeoGraphStore
from repro_torch.kernels import ops
from repro_torch.obs import MetricsRegistry, Tracer
from repro_torch.streaming import DeltaGraph, random_churn_batch

# reads a warp walks (<= 256 slots), reads a block walks, and the longest
# whole 2-hop neighbourhood of snb-sf3-5shard-nbr
LENS = (2, 31, 32, 33, 255, 256, 257, 4_000, 26_182)
N_ITEMS = 60_000


class _State:
    def __init__(self, delta):
        self.delta = delta


def _problem(seed: int, one_origin: bool):
    rng = np.random.default_rng(seed)
    env = make_paper_env()
    D = env.n_dcs
    g = community_graph(300, n_communities=6, p_in=0.05, p_out=0.002, seed=seed, n_dcs=D)
    lg = build_layered_graph(g, env)
    delta = rng.random((N_ITEMS, D)) < 0.3
    delta[rng.integers(0, N_ITEMS, 500)] = False  # items no DC holds: misses
    sizes = (rng.random(N_ITEMS) * 200 + 16).astype(np.float32)
    reqs = [(rng.choice(N_ITEMS, n, replace=False), 1 if one_origin else int(rng.integers(0, D)))
            for n in LENS]
    tables = (torch.as_tensor(_bit_pack(delta)), torch.as_tensor(sizes))
    return lg, _State(delta), sizes, reqs, tables


def _same_results(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.served_by, b.served_by)
        np.testing.assert_array_equal(a.dcs, b.dcs)
        assert a.latency_s == b.latency_s  # float-identical, not approx
        assert a.per_dc_latency == b.per_dc_latency
        assert (a.layers_used, a.n_missing, a.wan_bytes) == (b.layers_used, b.n_missing,
                                                            b.wan_bytes)


@pytest.mark.parametrize("one_origin", [False, True], ids=["mixed origins", "one origin"])
def test_id_form_equals_rows_form_and_numpy_router(one_origin):
    """The ids form against the numpy router (the name keeps the rows form,
    which the ids form replaced)."""
    lg, state, sizes, reqs, tables = _problem(3 + one_origin, one_origin)
    items = np.concatenate([it for it, _ in reqs]).astype(np.int64)
    bounds = np.concatenate([[0], np.cumsum([len(it) for it, _ in reqs])])
    origin = np.array([o for _, o in reqs], np.int64)
    comp, rtt = lg.comp_of_dc, lg.env.rtt_s
    ibw = 1.0 / lg.env.bw_Bps_safe()
    ids = ops.route_expand_flat_ids(items, bounds, origin, tables, comp, rtt, ibw, device="cpu")
    req_id = np.repeat(np.arange(len(reqs)), np.diff(bounds))
    served, layers = _expand_numpy(lg, state.delta[items], req_id, origin, MetricsRegistry(),
                                   False)
    np.testing.assert_array_equal(ids[0], served)
    np.testing.assert_array_equal(ids[1], layers)
    assert (ids[0] < 0).any() and ids[2][:, -1].sum() == (ids[0] < 0).sum()

    want = route_online_batch(lg, state, reqs, sizes=sizes, fast=False)
    tracer = Tracer(enabled=True)
    got = route_online_batch(lg, state, reqs, sizes=sizes, fast=True, device="cpu",
                             tables=tables, tracer=tracer)
    _same_results(got, want)
    (dev,) = [r for r in tracer.records if r.name == "route.device"]
    assert dev.tags == {"layout": "ragged", "variant": "ragged_plain", "slots": len(items),
                        "reads": len(reqs), "layers": lg.n_layers}


def test_fast_without_tables_raises():
    lg, state, sizes, reqs, tables = _problem(6, False)
    with pytest.raises(ValueError, match="route tables"):
        route_online_batch(lg, state, reqs, sizes=sizes, fast=True, device="cpu")
    with pytest.raises(ValueError, match="route tables"):
        route_online_batch(lg, state, reqs[:1], sizes=sizes, fast=True, device="cpu")
    # the numpy router and the gate need none
    want = route_online_batch(lg, state, reqs, sizes=sizes, fast=False)
    _same_results(route_online_batch(lg, state, reqs, sizes=sizes, device="cpu"), want)


def test_id_form_refuses_ids_outside_the_tables():
    lg, state, sizes, reqs, tables = _problem(5, False)
    items = np.array([0, N_ITEMS], np.int64)
    with pytest.raises(ValueError, match="item ids"):
        ops.route_expand_flat_ids(items, np.array([0, 1, 2]), np.array([0, 1]), tables,
                                  lg.comp_of_dc, lg.env.rtt_s, 1.0 / lg.env.bw_Bps_safe(),
                                  device="cpu")


# ------------------------------------------------------ the tables follow
def _store(tracer=None, seed=0, **kw):
    """A store on the CPU, whose route tables keep their set there."""
    g = community_graph(400, n_communities=8, p_in=0.04, p_out=0.001, seed=seed, n_dcs=5)
    env = make_paper_env()
    csr = build_csr(g.n_nodes, g.src, g.dst, symmetrize=True)
    pats = generate_khop_patterns(g, csr, 24, seed=seed + 1, n_dcs=env.n_dcs)
    wl = Workload.from_patterns(pats, g.n_items, env.n_dcs)
    store = GeoGraphStore(g, env, wl, config=PlacementConfig(precache=True, dhd_steps=4),
                          device="cpu", tracer=tracer, demand_window_s=6.0, **kw)
    return store


def _requests(store, one_origin: bool):
    pats = [p for p in store.workload.patterns if len(p.items)]
    return [(p.items, 2 if one_origin else i % store.env.n_dcs) for i, p in enumerate(pats)]


def _check_tables(store):
    """The tables equal what they follow, and route as the numpy router
    routes the fresh placement."""
    rt = store.route_tables
    assert rt.index is store.route_index
    want_sizes = store.g.item_size()
    assert rt.host_bytes.dtype == want_sizes.dtype
    np.testing.assert_array_equal(rt.host_bytes, want_sizes)
    (tb, tz), = rt.device_tables.values()
    np.testing.assert_array_equal(tb.numpy(), _bit_pack(store.state.delta))
    np.testing.assert_array_equal(tz.numpy(), want_sizes.astype(np.float32))
    for one_origin in (False, True):
        reqs = _requests(store, one_origin)
        want = route_online_batch(store.lg, store.state, reqs, fast=False)
        got = route_online_batch(store.lg, store.state, reqs, sizes=rt.host_bytes, fast=True,
                                 device="cpu", tables=(tb, tz))
        _same_results(got, want)


def _events(tracer):
    return {dict(k[1])["event"]: v for k, v in tracer.counters.items()
            if k[0] == "route.table_rows"}


def _maintain(store):
    store.serve_batch(_requests(store, False))
    return store.maintain()["evicted"]


def _delete(store):
    store.delete_items(np.arange(0, 40, 3))


def _grow(store):
    store._delta_graph = DeltaGraph(store.g)
    batch = random_churn_batch(store._delta_graph, 0.05, np.random.default_rng(4))
    n0 = store.g.n_items
    store.apply_updates(batch)
    assert store.g.n_items > n0


def _migrate(store):
    _grow(store)
    store.serve_batch(_requests(store, False))
    plan = store.flush_migrations()
    assert plan.moves  # replicas moved: each group patched through the index


def _compact(store):
    _grow(store)
    assert store.tombstone_ratio() > 0.0 and store.compact()


def _rederive(store):
    store.state.route_nearest(store.env)  # orphans the index's alias
    store.maintain(evict=False)


def _replace(store):
    old = store.route_index
    store.insert_patterns([Pattern(pid=999, items=np.arange(5, 60), r_py=np.ones(5),
                                   w_py=np.zeros(5), eta=1.0)])
    assert store.route_index is not old
    assert store.route_tables.handed(old, torch.device("cpu")) == (None, None)
    old.patch_rows(store.state.delta, np.arange(3))  # the old index's event is ignored


# mutation -> the event kinds it must send the tables
MUTATIONS = {
    "maintain": (_maintain, {"rows"}),
    "delete_items": (_delete, {"rows"}),
    "apply_updates": (_grow, {"grow", "rows"}),
    "migration wave": (_migrate, {"grow", "rows"}),
    "compaction": (_compact, {"grow", "rows", "take"}),
    "re-derived index": (_rederive, {"rebuild"}),
    "full re-place": (_replace, set()),
}


@pytest.mark.parametrize("name", list(MUTATIONS))
def test_tables_follow_each_route_index_event(name):
    tracer = Tracer(enabled=True)
    store = _store(tracer)
    _check_tables(store)
    assert _events(tracer) == {}  # the first derivation is no event
    mutate, kinds = MUTATIONS[name]
    out = mutate(store)
    if name == "maintain":
        assert out > 0  # some replicas were evicted
    assert set(_events(tracer)) == kinds
    _check_tables(store)


def test_host_table_is_the_grown_graphs_item_bytes():
    store = _store()
    before = store.route_tables.host_bytes
    _grow(store)
    rt = store.route_tables
    assert len(rt.host_bytes) == store.g.n_items > len(before)
    np.testing.assert_array_equal(rt.host_bytes, store.g.item_size())
    n = store.g.n_nodes
    np.testing.assert_array_equal(rt.host_bytes[:n], store.g.node_size)
    (tb, tz), = rt.device_tables.values()
    assert tb.shape == tz.shape == (store.g.n_items,)


# ------------------------------------------------------- who takes which path
def _device_variants(store, reqs, monkeypatch):
    """``serve_batch`` with the item gate open: its results and the
    ``variant`` of each ``route.device`` span."""
    store.tracer.reset()
    monkeypatch.setattr(routing, "FUSED_MIN_ITEMS", 1)
    got = store.serve_batch(reqs, observe=False)
    return got, [r.tags["variant"] for r in store.tracer.records if r.name == "route.device"]


def test_cpu_store_and_store_without_index_take_the_rows_form(monkeypatch):
    """A store on the CPU hands its own tables and routes in the fused form
    over them; without a route index it hands none and routes on numpy (the
    name keeps the rows form, which the ids form replaced)."""
    tracer = Tracer(enabled=True)
    store = _store(tracer)
    reqs = _requests(store, False)
    want = route_online_batch(store.lg, store.state, reqs, fast=False)
    host, tables = store.route_tables.handed(store.route_index, store.device)
    assert host is store.route_tables.host_bytes
    assert tables is store.route_tables.device_tables[torch.device("cpu")]
    got, variants = _device_variants(store, reqs, monkeypatch)
    _same_results(got, want)
    assert variants == ["ragged_plain"]

    store.route_index = None
    assert store.route_tables.handed(None, store.device) == (None, None)
    got, variants = _device_variants(store, reqs, monkeypatch)
    _same_results(got, want)
    assert variants == []
    (expand,) = [r for r in tracer.records if r.name == "route.expand"]
    assert expand.tags["path"] == "numpy"


def test_tables_are_handed_on_a_card_with_the_current_index():
    """Tables are handed on any device they are kept on, a card as the
    CPU, with the current index alone."""
    store = _store()
    rt = store.route_tables
    card = torch.device("cuda", 0)
    cpu_tables = rt.device_tables[torch.device("cpu")]
    assert rt.handed(store.route_index, "cpu") == (rt.host_bytes, cpu_tables)
    rt.device_tables[card] = cpu_tables  # stands in for a set on the card
    try:
        host, tables = rt.handed(store.route_index, card)
        assert host is rt.host_bytes and tables is cpu_tables
        assert rt.handed(None, card) == (None, None)
    finally:
        del rt.device_tables[card]
    assert rt.handed(store.route_index, card) == (rt.host_bytes, None)  # none kept there


def test_sharded_store_on_the_cpu_routes_its_sub_batches_in_the_rows_form(monkeypatch):
    """Each sub-batch of a sharded store on the CPU routes in the fused
    form over the coordinator's tables on the CPU (the name keeps the rows
    form, which the ids form replaced)."""
    g = community_graph(400, n_communities=8, p_in=0.04, p_out=0.001, seed=0, n_dcs=5)
    env = make_paper_env()
    csr = build_csr(g.n_nodes, g.src, g.dst, symmetrize=True)
    pats = generate_khop_patterns(g, csr, 24, seed=1, n_dcs=env.n_dcs)
    wl = Workload.from_patterns(pats, g.n_items, env.n_dcs)
    tracer = Tracer(enabled=True)
    store = ShardedGeoGraphStore(g, env, wl, config=PlacementConfig(precache=False, dhd_steps=4),
                                 device="cpu", tracer=tracer)
    assert list(store.route_tables.device_tables) == [torch.device("cpu")]
    reqs = [(p.items, o) for o in (0, 3) for p in pats if len(p.items)]
    want = route_online_batch(store.lg, store.state, reqs, fast=False)
    got, variants = _device_variants(store, reqs, monkeypatch)
    _same_results(got, want)
    assert variants == ["ragged_plain"] * 2  # one a sub-batch


@pytest.mark.parametrize("n_dcs,n_layers", [(32, 3), (5, 128)], ids=["32 DCs", "128 layers"])
def test_no_tables_past_the_kernel_limits(n_dcs, n_layers):
    """A store of more DCs than an int32 bitmask holds, or more layers than
    the kernel walks, keeps no device tables: its router routes on numpy."""
    delta = np.random.default_rng(0).random((50, n_dcs)) < 0.5
    sizes = np.ones(50)
    rt = RouteTables(lambda: delta, lambda: sizes, lambda: n_layers, devices=["cpu"])
    late = RouteTables(lambda: delta, lambda: sizes, lambda: n_layers)
    fit = RouteTables(lambda: delta[:, :5], lambda: sizes, lambda: 3, devices=["cpu"])
    index = types.SimpleNamespace(subscribe=lambda fn: None)
    for tables in (rt, late, fit):
        tables.bind(index)
    late.add_device("cpu")  # asked for after binding
    for tables in (rt, late):
        assert not tables.fits() and tables.device_tables == {}
        assert tables.handed(index, "cpu") == (sizes, None)
    assert fit.fits() and list(fit.device_tables) == [torch.device("cpu")]


@pytest.mark.parametrize("fault,error", [
    ("table_sizes", ValueError), ("ids", TypeError), ("offsets", ValueError)])
def test_id_form_wrapper_refuses_what_the_launch_cannot_take(fault, error):
    """The CUDA wrapper's checks, run before a launch: the tables must be
    one length and the stream int32 with its offsets."""
    from repro_torch.kernels import route_expand as tre

    i32 = dict(dtype=torch.int32)
    args = dict(ids=torch.zeros(6, **i32), table_bits=torch.zeros(10, **i32),
                table_sizes=torch.zeros(10), offsets=torch.tensor([0, 2, 6], **i32),
                origin=torch.zeros(2, **i32), order=torch.zeros(2, **i32),
                comp=torch.zeros((4, 5), **i32), rtt=torch.zeros((5, 5)),
                ibw=torch.zeros((5, 5)))
    tre._check_ragged(**args)
    args[fault] = {"table_sizes": torch.zeros(9), "ids": torch.zeros(6, dtype=torch.int64),
                   "offsets": torch.tensor([0, 6], **i32)}[fault]
    with pytest.raises(error):
        tre._check_ragged(**args)
