"""The competitor strategies (paper §VII-A, Figs. 7 and 16): the port's
GeoGraphStore vs the JAX package's on the ``tests/conftest.py`` fixture
(wiki graph, 40 k-hop patterns), all on the CPU.

For each competitor placement, with its paper routing (Random-3 and Top-3:
random; ADP and DCD: greedy set cover) and with stepwise routing:

* ``state.delta`` and ``state.route`` are identical to the JAX store's;
* ``serve_online`` and ``serve_batch`` are request-identical, and the
  ``serving.*`` instruments of an injected registry are equal;
* ``maintain()`` evicts the same replicas and leaves the same routes;
* ``insert_patterns_incremental`` falls back to the full re-place, as the
  reference does.

Besides: the three offline layouts (RAGraph, RAGraph+, GrapH) are identical,
and a JAX table-routed store crosses over through ``convert`` and serves
identically.
"""
import numpy as np
import pytest

from repro.core import baselines as jax_baselines
from repro.core.placement import PlacementConfig as JaxPlacementConfig
from repro.core.store import GeoGraphStore as JaxStore
from repro.obs import MetricsRegistry as JaxRegistry
from repro_torch.convert import store_arrays, store_from_numpy
from repro_torch.core import baselines
from repro_torch.core.placement import PlacementConfig
from repro_torch.core.store import GeoGraphStore
from repro_torch.kernels.cuda_lib import launch_counters, reset_launch_counters
from repro_torch.obs import MetricsRegistry

PAPER_ROUTING = {"random": "random", "top": "random", "adp": "greedy", "dcd": "greedy"}
PAIRS = [(p, r) for p in PAPER_ROUTING for r in (PAPER_ROUTING[p], "stepwise")]


@pytest.fixture(scope="module")
def port_setup():
    """The fixture's graph, environment and workload from the port's own
    generators (equal to the JAX package's, see ``test_torch_store.py``)."""
    from repro_torch.core.graph import build_csr
    from repro_torch.core.latency import make_paper_env
    from repro_torch.core.patterns import Workload, generate_khop_patterns
    from repro_torch.data.synthetic import make_benchmark_graph

    g = make_benchmark_graph("wiki", n_dcs=4, seed=0)
    env = make_paper_env()
    csr = build_csr(g.n_nodes, g.src, g.dst, symmetrize=True)
    pats = generate_khop_patterns(g, csr, 40, seed=1, n_dcs=env.n_dcs)
    return g, env, csr, Workload.from_patterns(pats, g.n_items, env.n_dcs), pats


def _request_ix(pats, n_dcs, n, seed):
    """(pattern index, origin) pairs, 65% from the pattern's home DC: the
    indices pick the same pattern from either package's list."""
    rng = np.random.default_rng(seed)
    reqs = []
    for _ in range(n):
        i = int(rng.integers(0, len(pats)))
        home = int(np.argmax(pats[i].r_py))
        origin = home if rng.random() < 0.65 else int(rng.integers(0, n_dcs))
        reqs.append((i, origin))
    return reqs


def _assert_same_results(got, want):
    assert len(got) == len(want)
    for x, y in zip(got, want):
        np.testing.assert_array_equal(x.served_by, y.served_by)
        np.testing.assert_array_equal(x.dcs, y.dcs)
        assert x.latency_s == y.latency_s
        assert x.per_dc_latency == y.per_dc_latency
        assert x.wan_bytes == y.wan_bytes
        assert x.layers_used == y.layers_used and x.n_missing == y.n_missing


def _serving(reg):
    return {k: v for k, v in reg.snapshot().items() if k.startswith("serving.")}


def _twin(small_setup, port_setup, placement, routing, seed=0):
    g, env, _, wl, _ = small_setup
    pg, penv, _, pwl, _ = port_setup
    jreg, preg = JaxRegistry().enable(), MetricsRegistry().enable()
    want = JaxStore(g, env, wl, config=JaxPlacementConfig(precache=False, dhd_steps=8),
                    placement=placement, routing=routing, seed=seed, registry=jreg)
    got = GeoGraphStore(pg, penv, pwl, config=PlacementConfig(precache=False, dhd_steps=8),
                        placement=placement, routing=routing, seed=seed, registry=preg,
                        device="cpu")
    return got, want, preg, jreg


@pytest.mark.parametrize("placement,routing", PAIRS)
def test_competitor_store_matches_jax(small_setup, port_setup, placement, routing):
    reset_launch_counters()
    got, want, preg, jreg = _twin(small_setup, port_setup, placement, routing)
    assert got.stats.placement_stats == want.stats.placement_stats
    np.testing.assert_array_equal(got.state.delta, want.state.delta)
    np.testing.assert_array_equal(got.state.route, want.state.route)
    assert (got.route_index is None) == (want.route_index is None) == (routing != "stepwise")

    pats = port_setup[4]
    jpats = small_setup[4]
    reqs = _request_ix(pats, got.env.n_dcs, 80, seed=3)
    for i, origin in reqs[:20]:
        _assert_same_results([got.serve_online(pats[i], origin)],
                             [want.serve_online(jpats[i], origin)])
    _assert_same_results(
        got.serve_batch([(pats[i], o) for i, o in reqs]),
        want.serve_batch([(jpats[i], o) for i, o in reqs]),
    )
    assert _serving(preg) == _serving(jreg)
    assert _serving(preg)["serving.requests"]["-"]["value"] == len(reqs)
    np.testing.assert_array_equal(got.demand.heat, want.demand.heat)

    assert got.maintain() == want.maintain()
    np.testing.assert_array_equal(got.state.delta, want.state.delta)
    np.testing.assert_array_equal(got.state.route, want.state.route)
    assert all(c.n == 0 for c in launch_counters().values())


@pytest.mark.parametrize("placement,routing", PAIRS)
def test_insert_patterns_incremental_falls_back(small_setup, port_setup, placement, routing):
    """A competitor store has no incremental structure: both packages
    re-place from scratch (``seed=0``) and re-derive the routing table."""
    got, want, _, _ = _twin(small_setup, port_setup, placement, routing, seed=3)
    new = slice(0, 6)
    rep_got = got.insert_patterns_incremental(port_setup[4][new])
    rep_want = want.insert_patterns_incremental(small_setup[4][new])
    assert rep_got == rep_want == {"fallback": "full", "n_new": 6}
    assert len(got.workload.patterns) == len(want.workload.patterns) == 46
    np.testing.assert_array_equal(got.state.delta, want.state.delta)
    np.testing.assert_array_equal(got.state.route, want.state.route)
    for cache in got.caches.values():
        assert cache.state is got.state


def test_rp_sr_batch_through_the_kernel_wrapper(small_setup, port_setup, monkeypatch):
    """RP+SR (random placement, stepwise routing) with the item gate opened,
    so every batch takes the route-expansion kernel's wrapper over the
    store's route tables, as on the card: Random-3 puts replicas at up to
    four DCs, tiles the GeoLayer store never makes.  On CPU tensors the
    wrapper runs its plain version."""
    from repro.core.routing import route_online_batch as jax_route_online_batch
    from repro_torch.core import routing as trouting

    got, want, _, _ = _twin(small_setup, port_setup, "random", "stepwise")
    assert got.state.delta.sum(axis=1).max() == 4
    monkeypatch.setattr(trouting, "FUSED_MIN_ITEMS", 1)
    reset_launch_counters()
    for n, seed in ((64, 1), (200, 2)):
        reqs = _request_ix(port_setup[4], got.env.n_dcs, n, seed)
        _assert_same_results(
            got.serve_batch([(port_setup[4][i], o) for i, o in reqs], observe=False),
            jax_route_online_batch(want.lg, want.state,
                                   [(small_setup[4][i].items, o) for i, o in reqs],
                                   fast=False),
        )
    assert all(c.n == 0 for c in launch_counters().values())


@pytest.mark.parametrize("traffic", [True, False], ids=["traffic", "uniform"])
@pytest.mark.parametrize("layout", ["layout_ragraph", "layout_ragraph_plus", "layout_graph_h"])
def test_offline_layouts_match_jax(small_setup, port_setup, layout, traffic):
    g, env, _, wl, _ = small_setup
    pg, penv, _, pwl, _ = port_setup
    args = {}
    if layout != "layout_ragraph" and traffic:
        args = dict(traffic=wl.r_xy[: g.n_nodes].sum(axis=1))
    want = getattr(jax_baselines, layout)(g, env, **args)
    got = getattr(baselines, layout)(pg, penv, **args)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    if layout == "layout_ragraph_plus":
        assert (got != pg.partition).any()  # the layout migrated something


@pytest.mark.parametrize("placement,routing", [("random", "random"), ("adp", "greedy")])
def test_table_routed_store_crosses_over(small_setup, placement, routing):
    """``store_arrays`` / ``store_from_numpy`` carry a JAX store whose
    routing is a table: ``state.route`` is adopted as it is (no re-draw),
    and the port serves identically."""
    g, env, _, wl, pats = small_setup
    jax_store = JaxStore(g, env, wl, config=JaxPlacementConfig(precache=False, dhd_steps=8),
                         placement=placement, routing=routing, seed=5)
    arrays = store_arrays(jax_store)
    assert (arrays["placement"], arrays["routing"]) == (placement, routing)
    port = store_from_numpy(arrays, device="cpu")
    assert port.route_index is None
    assert (port.placement_name, port.routing_name) == (placement, routing)
    np.testing.assert_array_equal(port.state.route, jax_store.state.route)
    reqs = _request_ix(pats, env.n_dcs, 70, seed=9)
    _assert_same_results(
        port.serve_batch([(pats[i].items, o) for i, o in reqs]),
        jax_store.serve_batch([(pats[i], o) for i, o in reqs]),
    )


def test_stepwise_crossing_still_checks_the_route_table(small_store):
    """Under stepwise routing a carried table that is not the
    nearest-replica table of the carried replica sets is refused."""
    arrays = store_arrays(small_store)
    arrays["state.route"] = np.roll(arrays["state.route"], 1, axis=1)
    with pytest.raises(ValueError, match="nearest-replica"):
        store_from_numpy(arrays, device="cpu")


def test_unknown_strategy_names_raise(port_setup):
    g, env, _, wl, _ = port_setup
    with pytest.raises(ValueError, match="placement"):
        GeoGraphStore(g, env, wl, placement="metis", device="cpu")
    with pytest.raises(ValueError, match="routing"):
        GeoGraphStore(g, env, wl, placement="top", routing="nearest", device="cpu")
