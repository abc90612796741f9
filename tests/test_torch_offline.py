"""Offline routing (paper §VI, Fig. 6, Eq. 14) and the BSP execution model
(Figs. 13-15): the port vs the JAX package on the ``tests/conftest.py``
fixture, all on the CPU.

* ``plan_offline`` gives identical ``OfflineLayout`` fields (sites, item
  sites, migrated items, assembly WAN bytes, excluded DCs) for all vertices,
  a seeded subset, vertices and edges together, and on a competitor store;
* ``simulate_execution`` gives identical ``ExecStats`` for the layouts the
  offline benchmark prices.
"""
import dataclasses

import numpy as np
import pytest

from repro.core import analytics as jax_analytics
from repro.core import baselines as jax_baselines
from repro.core.placement import PlacementConfig as JaxPlacementConfig
from repro.core.routing import route_offline as jax_route_offline
from repro.core.store import GeoGraphStore as JaxStore
from repro_torch.convert import store_arrays, store_from_numpy
from repro_torch.core import analytics
from repro_torch.core.placement import PlacementConfig
from repro_torch.core.routing import OfflineLayout, route_offline

LAYOUT_FIELDS = ("sites", "item_site", "migrated", "excluded")


@pytest.fixture(scope="module")
def twins(small_store):
    port = store_from_numpy(
        store_arrays(small_store), config=PlacementConfig(precache=True, dhd_steps=8),
        device="cpu",
    )
    return port, small_store


def _required(g, which):
    if which == "all vertices":
        return np.arange(g.n_nodes)
    rng = np.random.default_rng(11)
    if which == "seeded subset":
        return np.sort(rng.choice(g.n_nodes, size=g.n_nodes // 5, replace=False))
    # vertices and edges: edges take their source's primary DC
    return np.sort(rng.choice(g.n_items, size=g.n_items // 4, replace=False))


def _assert_same_layout(got: OfflineLayout, want) -> None:
    for f in LAYOUT_FIELDS:
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f), err_msg=f)
        assert getattr(got, f).dtype == getattr(want, f).dtype, f
    assert got.wan_bytes == want.wan_bytes


@pytest.mark.parametrize("msg_bytes", [16.0, 192.0])
@pytest.mark.parametrize("which", ["all vertices", "seeded subset", "vertices and edges"])
def test_plan_offline_matches_jax(twins, which, msg_bytes):
    port, jax_store = twins
    req = _required(port.g, which)
    got = port.plan_offline(req, n_iters=15, msg_bytes=msg_bytes)
    want = jax_store.plan_offline(req, n_iters=15, msg_bytes=msg_bytes)
    _assert_same_layout(got, want)
    assert len(got.sites) >= 1
    # route_offline is what the store calls
    _assert_same_layout(
        route_offline(port.lg, port.state, req, n_iters=15, msg_bytes=msg_bytes),
        jax_route_offline(jax_store.lg, jax_store.state, req, n_iters=15,
                          msg_bytes=msg_bytes),
    )


@pytest.mark.parametrize("xi_frac", [0.0, 0.2, 5.0])
def test_route_offline_eq14_threshold_matches_jax(twins, xi_frac):
    """Eq. 14's threshold from everything excluded (the degenerate keep of
    the largest local volume) to everything retained."""
    port, jax_store = twins
    req = np.arange(port.g.n_nodes)
    _assert_same_layout(
        route_offline(port.lg, port.state, req, xi_frac=xi_frac),
        jax_route_offline(jax_store.lg, jax_store.state, req, xi_frac=xi_frac),
    )


def test_plan_offline_on_a_competitor_store_matches_jax(small_setup):
    """RP+SR, the ablation's random placement with stepwise routing, plans
    offline over its own replica sets."""
    g, env, _, wl, _ = small_setup
    jax_store = JaxStore(g, env, wl, config=JaxPlacementConfig(precache=False, dhd_steps=8),
                         placement="random", routing="stepwise")
    port = store_from_numpy(store_arrays(jax_store), device="cpu")
    req = np.arange(g.n_nodes)
    _assert_same_layout(port.plan_offline(req), jax_store.plan_offline(req))


def _layouts(g, env, wl, plan_site):
    traffic = wl.r_xy[: g.n_nodes].sum(axis=1)
    return {
        "geolayer": plan_site,
        "ragraph": jax_baselines.layout_ragraph(g, env),
        "ragraph+": jax_baselines.layout_ragraph_plus(g, env, traffic),
        "graph_h": jax_baselines.layout_graph_h(g, env, traffic),
        "one site": np.zeros(g.n_nodes, dtype=np.int64),
    }


@pytest.mark.parametrize("n_iters,msg_bytes,edge_rate,assembly", [
    (15, 192.0, 5e8, True),   # PageRank as bench_offline prices it
    (10, 16.0, 5e7, False),   # the simulator's defaults
    (20, 192.0, 5e8, False),  # HITS
])
def test_simulate_execution_matches_jax(twins, small_setup, n_iters, msg_bytes, edge_rate,
                                        assembly):
    port, jax_store = twins
    g, env, _, wl, _ = small_setup
    plan = jax_store.plan_offline(np.arange(g.n_nodes), n_iters=15, msg_bytes=192.0)
    site = plan.item_site[: g.n_nodes].copy()
    site[site < 0] = g.partition[site < 0]
    for name, layout in _layouts(g, env, wl, site).items():
        extra = plan.wan_bytes if assembly and name == "geolayer" else 0.0
        got = analytics.simulate_execution(port.env, port.g, layout, n_iters, msg_bytes=msg_bytes,
                                           edge_rate=edge_rate, assembly_bytes=extra)
        want = jax_analytics.simulate_execution(env, g, layout, n_iters, msg_bytes=msg_bytes,
                                                edge_rate=edge_rate, assembly_bytes=extra)
        assert dataclasses.asdict(got) == dataclasses.asdict(want), name
    assert dataclasses.asdict(got)["wan_bytes"] == 0.0  # one site ships nothing
