"""The router's fused form, item ids over route tables keyed by item id,
on the CPU.

* the id-keyed plain version (``ops.route_expand_flat_ids``, the kernel's
  plain version) equals the numpy router bit for bit: picks, layers used
  and missing counts, and through ``route_online_batch`` every
  ``RouteResult`` field, on reads a warp walks (up to 256 items), reads a
  block walks, and the 26,182-item read of ``snb-sf3-5shard-nbr``;
  ``fast=True`` without tables raises;
* the fold of each read's bytes per DC on the card (int64 units at the
  tables' shift, ``fold_shift``) gives every ``RouteResult`` field the
  host's fold gives, bit for bit, with mixed origins and one, unresolved
  items and a read its origin serves whole; tables no shift fits and a
  batch whose sums reach ``2**53`` units take the host's fold, with the
  same results; ``route.fold`` and ``route.epilogue``'s ``fold`` tag say
  which ran;
* a store's ``RouteTables`` follow each ``RouteIndex`` event kind (``rows``
  through ``maintain()``, ``delete_items`` and a migration wave, ``grow``
  through ``apply_updates()``, ``take`` through a compaction, ``rebuild``
  through a re-derived index and a full re-place): after each, the bitmask
  table equals the bit-packed ``state.delta``, the byte tables equal
  ``g.item_size()``, their shift ``fold_shift(g.item_size())``, and routing
  with the tables (folding on the card) equals the numpy router on the
  fresh ``state.delta``; the shift follows bytes that change its value
  through growth, a compaction and a rebuild.  A store keeps its tables on its own device,
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
from repro_torch.core.route_tables import (
    FOLD_MAX_ITEMS,
    UNITS_LIMIT,
    DeviceTables,
    RouteTables,
    _bit_pack,
    fold_shift,
)
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
    ids = ops.route_expand_flat_ids(items, bounds, origin, tables, lg.comp_of_dc, device="cpu")
    req_id = np.repeat(np.arange(len(reqs)), np.diff(bounds))
    served, layers = _expand_numpy(lg, state.delta[items], req_id, origin, MetricsRegistry(),
                                   False)
    np.testing.assert_array_equal(ids[0], served)
    np.testing.assert_array_equal(ids[1], layers)
    assert (ids[0] < 0).any() and ids[2][:, -1].sum() == (ids[0] < 0).sum()
    np.testing.assert_array_equal(ids[5], np.bincount(req_id[served < 0], minlength=len(reqs)))

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
                                  lg.comp_of_dc, device="cpu")


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
    assert rt.shift is not None and rt.shift == fold_shift(want_sizes)
    (tables,) = rt.device_tables.values()
    tb, tz, shift = tables
    assert shift == rt.shift
    np.testing.assert_array_equal(tb.numpy(), _bit_pack(store.state.delta))
    np.testing.assert_array_equal(tz.numpy(), want_sizes.astype(np.float32))
    for one_origin in (False, True):
        reqs = _requests(store, one_origin)
        want = route_online_batch(store.lg, store.state, reqs, fast=False)
        tracer = Tracer(enabled=True)
        got = route_online_batch(store.lg, store.state, reqs, sizes=rt.host_bytes, fast=True,
                                 device="cpu", tables=tables, tracer=tracer)
        _same_results(got, want)
        assert _folds(tracer) == {"card": 1}


def _folds(tracer):
    """``route.fold`` counts by ``where``."""
    return {dict(k[1])["where"]: v for k, v in tracer.counters.items() if k[0] == "route.fold"}


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
    (tb, tz, shift), = rt.device_tables.values()
    assert tb.shape == tz.shape == (store.g.n_items,)
    assert shift == rt.shift == fold_shift(store.g.item_size())


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
                comp=torch.zeros((4, 5), **i32))
    tre._check_ragged(**args)
    args[fault] = {"table_sizes": torch.zeros(9), "ids": torch.zeros(6, dtype=torch.int64),
                   "offsets": torch.tensor([0, 6], **i32)}[fault]
    with pytest.raises(error):
        tre._check_ragged(**args)


# ------------------------------------------------------ the fold on the card
def _routes(lg, state, sizes, reqs, tables):
    """``route_online_batch`` over ``tables`` (``None``: the numpy router),
    and the ``fold`` tags of its ``route.epilogue`` spans and its
    ``route.fold`` counts."""
    tracer = Tracer(enabled=True)
    got = route_online_batch(lg, state, reqs, sizes=sizes, fast=tables is not None,
                             device="cpu", tables=tables, tracer=tracer)
    tags = [r.tags["fold"] for r in tracer.records if r.name == "route.epilogue"]
    return got, tags, _folds(tracer)


@pytest.mark.parametrize("one_origin", [False, True], ids=["mixed origins", "one origin"])
def test_card_fold_equals_the_host_fold(one_origin):
    """Reads a warp walks, reads a block walks and a 26,182-item read, with
    unresolved items and a read its origin serves whole: the card's int64
    sums give every ``RouteResult`` field the host's f64 fold gives."""
    lg, state, sizes, reqs, (bits, sz) = _problem(11 + one_origin, one_origin)
    o = 1 if one_origin else 3
    whole = np.random.default_rng(2).choice(np.flatnonzero(state.delta[:, o]), 300,
                                            replace=False)
    reqs = reqs + [(whole, o)]
    shift = fold_shift(sizes)
    assert shift is not None and shift > 0  # sizes with fractional bytes
    want, tags, folds = _routes(lg, state, sizes, reqs, None)
    assert tags == ["host"] and folds == {}
    host, tags, folds = _routes(lg, state, sizes, reqs, (bits, sz))
    assert tags == ["host"] and folds == {"host": 1}
    card, tags, folds = _routes(lg, state, sizes, reqs, DeviceTables(bits, sz, shift))
    assert tags == ["card"] and folds == {"card": 1}
    _same_results(host, want)
    _same_results(card, want)
    assert any(r.n_missing > 0 for r in card)
    assert list(card[-1].dcs) == [o] and card[-1].n_missing == 0
    assert card[-1].latency_s == 0.0 and card[-1].wan_bytes == 0.0


def _grown_sums_problem():
    """Sizes whose shift holds (one item of 2**-20 bytes, the rest just
    under 2**20), and a read of 12,000 items its origin holds, whose sum
    there passes 2**53 units."""
    lg, state, sizes, reqs, _ = _problem(7, False)
    sizes = np.full(N_ITEMS, 2.0 ** 20 - 64, np.float32)
    sizes[0] = 2.0 ** -20
    held = np.flatnonzero(state.delta[:, 2])[:12_000]
    return lg, state, sizes, reqs + [(held, 2)]


@pytest.mark.parametrize("case", ["subnormal size", "sizes too far apart", "sums past 2**53"])
def test_no_exact_scale_takes_the_host_fold(case):
    """Tables no shift fits, and a batch whose sums reach ``2**53`` units,
    take the host's fold: the same results as the numpy router."""
    lg, state, sizes, reqs, _ = _problem(9, False)
    if case == "subnormal size":
        sizes = sizes.copy()
        sizes[5] = 1e-40
    elif case == "sizes too far apart":
        sizes = sizes.copy()
        sizes[5] = 2.0 ** 40
    else:
        lg, state, sizes, reqs = _grown_sums_problem()
    rt = RouteTables(lambda: state.delta, lambda: sizes, lambda: lg.n_layers, devices=["cpu"])
    index = types.SimpleNamespace(subscribe=lambda fn: None)
    rt.bind(index)
    _, tables = rt.handed(index, "cpu")
    if case == "sums past 2**53":
        assert tables.shift == 20
        assert 12_000 * (2.0 ** 20 - 64) * 2.0 ** 20 >= 2.0 ** 53
    else:
        assert rt.shift is None and tables.shift is None
    want, _, _ = _routes(lg, state, sizes, reqs, None)
    got, tags, folds = _routes(lg, state, sizes, reqs, tables)
    _same_results(got, want)
    assert tags == ["host"] and folds == {"host": 1}


@pytest.mark.parametrize("units_max,longest,exact", [
    ((1 << 53) - 1, 4, True), (1 << 53, 4, False), (5, FOLD_MAX_ITEMS, True),
    (5, FOLD_MAX_ITEMS + 1, False)])
def test_card_fold_refuses_sums_that_may_not_be_exact(units_max, longest, exact):
    units = np.array([[units_max, 0], [3, 4]], np.int64)
    card = (units, np.array([1, 3], np.int32), np.array([0, 2], np.int32))
    fold = routing._card_fold(card, 3, np.array([longest, 2]), 2)
    assert (fold is not None) == exact
    if exact:
        bytes_rd, mask, n_miss = fold
        np.testing.assert_array_equal(bytes_rd, units / 8.0)
        np.testing.assert_array_equal(mask, [[True, False], [True, True]])
        np.testing.assert_array_equal(n_miss, [0, 2])


@pytest.mark.parametrize("sizes,want", [
    ([1.0, 2.0, 3.0], 0), ([64.0, 128.0, 192.0], -6), ([0.5, 1.25], 2), ([0.0, 3.0], 0),
    ([], 0), ([0.0], 0), ([1.0, 2.0 ** 39], 0), ([1.0, 2.0 ** 40], None),
    ([1e-40], None), ([-1.0, 2.0], None), ([np.nan], None), ([np.inf], None)],
    ids=["whole", "multiples of 64", "quarters", "a zero", "none", "all zero",
         "2**39 apart", "2**40 apart", "subnormal", "negative", "nan", "inf"])
def test_fold_shift_is_the_least_whole_scale(sizes, want):
    s = fold_shift(np.array(sizes, np.float32))
    assert s == want
    if s is not None and any(sizes):
        units = np.array(sizes, np.float64) * 2.0 ** s
        assert (units == np.floor(units)).all() and units.max() < UNITS_LIMIT
        assert (np.array(sizes) * 2.0 ** (s - 1) % 1).any()  # none less will do


def test_fold_shift_of_lognormal_bytes_and_of_non_float32_sizes():
    """The benchmark's record bytes (lognormal float32) fit with room; float64
    sizes fit only where each is its own float32 image."""
    rng = np.random.default_rng(0)
    sizes = np.concatenate([rng.lognormal(np.log(256.0), 0.5, 27_000),
                            rng.lognormal(np.log(64.0), 0.4, 540_000)]).astype(np.float32)
    s = fold_shift(sizes)
    assert s is not None and float(sizes.max()) * 2.0 ** s < UNITS_LIMIT / 2 ** 8
    assert fold_shift(np.array([0.5, 3.0])) == 1  # float64 images of float32 values
    assert fold_shift(np.array([0.1, 3.0])) is None  # 0.1 is no float32


def test_scale_follows_the_bytes_through_each_event():
    """The shift is re-derived where the bytes change (growth, a take, a
    rebuild), on the host and on every device set, and only there."""
    delta = np.random.default_rng(1).random((12, 5)) < 0.5
    state = {"delta": delta[:10], "sizes": np.arange(1, 11, dtype=np.float32)}
    fire = []
    index = types.SimpleNamespace(subscribe=fire.append)
    rt = RouteTables(lambda: state["delta"], lambda: state["sizes"], lambda: 3,
                     devices=["cpu"])
    rt.bind(index)
    (on_cpu,) = rt.device_tables
    assert rt.shift == 0 and rt.device_tables[on_cpu].shift == 0

    # growth: a new vertex of half a byte (after the 4 old vertices), a new edge
    grown = np.concatenate([np.arange(1, 5), [0.5], np.arange(5, 11), [7.0]])
    state["delta"], state["sizes"] = delta, grown.astype(np.float32)
    fire[0]("grow", (4, 1, 1))
    assert rt.shift == 1 and rt.device_tables[on_cpu].shift == 1
    np.testing.assert_array_equal(rt.device_tables[on_cpu].sizes.numpy(), state["sizes"])

    fire[0]("rows", np.arange(3))  # bitmasks only: the shift stays
    assert rt.shift == 1

    keep = np.array([0, 1, 2, 3, 5, 6, 7, 8, 9, 10, 11])  # a take drops the half byte
    state["delta"], state["sizes"] = delta[keep], state["sizes"][keep]
    fire[0]("take", keep)
    assert rt.shift == 0 and rt.device_tables[on_cpu].shift == 0
    np.testing.assert_array_equal(rt.host_bytes, state["sizes"])

    state["sizes"] = np.where(np.arange(11) == 2, 2.0 ** 45, state["sizes"]).astype(np.float32)
    fire[0]("rebuild", None)
    assert rt.shift is None and rt.device_tables[on_cpu].shift is None
