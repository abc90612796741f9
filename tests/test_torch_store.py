"""The slice as a whole: the port's GeoGraphStore vs the JAX package's on the
``tests/conftest.py`` fixture (wiki graph, 40 k-hop patterns,
``PlacementConfig(precache=True, dhd_steps=8)``), all on the CPU.

* the port's own build gives the JAX store's replica sets and routing table;
* on a ``store_from_numpy`` copy of the JAX store, ``serve_batch`` is
  request-for-request identical to JAX's on every impl of the fast path
  (subset histogram, the tile version pinned through the autotuner, the
  kernel wrapper pinned through the autotuner) and on the numpy path — the
  contract of ``tests/test_route_kernel.py``;
* ``maintain()`` leaves identical replica sets.

The competitor strategies and offline planning have their own files
(``test_torch_baselines.py``, ``test_torch_offline.py``).
"""
import numpy as np
import pytest

from repro.core.placement import PlacementConfig as JaxPlacementConfig
from repro.core.routing import route_online_batch as jax_route_online_batch
from repro.core.store import GeoGraphStore as JaxStore
from repro_torch.convert import store_arrays, store_from_numpy
from repro_torch.core.placement import PlacementConfig
from repro_torch.core.routing import route_online_batch
from repro_torch.kernels.cuda_lib import launch_counters, reset_launch_counters
from repro_torch.obs import MetricsRegistry, set_default_registry


def _requests(store, n, seed):
    """Sampled pattern requests, 65% from the pattern's home DC."""
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
def jax_store(small_setup):
    """A JAX store of this module's own (serving and maintenance mutate the
    demand plane and the replica sets, so the session fixture stays clean)."""
    g, env, csr, wl, pats = small_setup
    return JaxStore(g, env, wl, config=JaxPlacementConfig(precache=True, dhd_steps=8))


def test_cpu_build_matches_jax(small_store):
    """The port builds the fixture from its own generators on the CPU and
    lands on the JAX store's replica sets and nearest-replica table."""
    from repro_torch.core.graph import build_csr
    from repro_torch.core.latency import make_paper_env
    from repro_torch.core.patterns import Workload, generate_khop_patterns
    from repro_torch.core.store import GeoGraphStore
    from repro_torch.data.synthetic import make_benchmark_graph

    g = make_benchmark_graph("wiki", n_dcs=4, seed=0)
    env = make_paper_env()
    csr = build_csr(g.n_nodes, g.src, g.dst, symmetrize=True)
    pats = generate_khop_patterns(g, csr, 40, seed=1, n_dcs=env.n_dcs)
    wl = Workload.from_patterns(pats, g.n_items, env.n_dcs)
    reset_launch_counters()
    store = GeoGraphStore(
        g, env, wl, config=PlacementConfig(precache=True, dhd_steps=8), device="cpu"
    )
    assert store.g.n_items == small_store.g.n_items
    np.testing.assert_array_equal(store.state.delta, small_store.state.delta)
    np.testing.assert_array_equal(
        store.route_index.nearest, small_store.route_index.nearest
    )
    assert store.stats.placement_stats["competitions"] == (
        small_store.stats.placement_stats["competitions"]
    )
    assert all(c.n == 0 for c in launch_counters().values())


def _pin_route_impl(monkeypatch, impl):
    """Pin the fast path's impl for every signature through the autotuner."""
    from repro.kernels import autotune as jtune
    from repro_torch.kernels import autotune as ttune

    for mod in (jtune, ttune):
        tuner = mod.Autotuner()
        monkeypatch.setattr(mod, "_AUTOTUNER", tuner)
        monkeypatch.setattr(
            tuner, "lookup", lambda op, sig, device=None, _impl=impl: {"impl": _impl}
        )


@pytest.mark.parametrize("n_req", [64, 200])
@pytest.mark.parametrize("path", ["subsets", "tile", "kernel", "numpy"])
def test_serve_batch_matches_jax(jax_store, monkeypatch, path, n_req):
    port = store_from_numpy(
        store_arrays(jax_store), config=PlacementConfig(precache=True, dhd_steps=8),
        device="cpu",
    )
    reqs = _requests(jax_store, n_req, seed=n_req)
    fast = None
    if path in ("tile", "kernel"):
        # the JAX side has no CUDA kernel: both packages pin their tile
        # version; the port's kernel wrapper takes it on CPU tensors
        _pin_route_impl(monkeypatch, "ref")
        if path == "kernel":
            from repro_torch.kernels import autotune as ttune

            monkeypatch.setattr(
                ttune.get_autotuner(), "lookup",
                lambda op, sig, device=None: {"impl": "kernel"},
            )
    elif path == "numpy":
        fast = False
    reset_launch_counters()
    if fast is None:
        want = jax_store.serve_batch(reqs, observe=False)
    else:
        want = jax_route_online_batch(jax_store.lg, jax_store.state, reqs, fast=False)
    reg = MetricsRegistry().enable()
    old = set_default_registry(reg)
    try:
        if fast is None:
            got = port.serve_batch(reqs, observe=False)
        else:
            got = route_online_batch(port.lg, port.state, reqs, fast=False, device="cpu")
    finally:
        set_default_registry(old)
    _assert_same_results(got, want)
    assert all(c.n == 0 for c in launch_counters().values())
    # the batch really took the path under test (a "kernel" pin on CPU
    # tensors runs the kernel wrapper's plain version, booked as "ref")
    taken = {
        impl: reg.counter("kernels.dispatch", op="route_expand", path=impl).value
        for impl in ("subsets", "ref", "kernel")
    }
    expect = {"subsets": "subsets", "tile": "ref", "kernel": "ref"}.get(path)
    assert taken == {i: float(i == expect) for i in taken}


def test_maintain_matches_jax(jax_store):
    """Same served traffic into both demand planes, then one maintenance
    pass each: the same replicas are evicted and the heat agrees."""
    port = store_from_numpy(
        store_arrays(jax_store), config=PlacementConfig(precache=True, dhd_steps=8),
        device="cpu",
    )
    reqs = _requests(jax_store, 128, seed=5)
    _assert_same_results(port.serve_batch(reqs), jax_store.serve_batch(reqs))
    np.testing.assert_array_equal(port.demand.heat, jax_store.demand.heat)
    got = port.maintain()
    want = jax_store.maintain()
    assert got["evicted"] == want["evicted"] > 0
    np.testing.assert_array_equal(port.state.delta, jax_store.state.delta)
    np.testing.assert_array_equal(port.route_index.nearest, jax_store.route_index.nearest)
    np.testing.assert_allclose(
        port.demand.heat, jax_store.demand.heat, atol=1e-5, rtol=1e-4
    )
    assert port.cost().as_dict() == pytest.approx(jax_store.cost().as_dict(), rel=1e-9)
    assert port.constraints() == jax_store.constraints()
    # demand-driven pre-caching from the measured demand of the same traffic
    np.testing.assert_array_equal(port.precache(), jax_store.precache())
    np.testing.assert_array_equal(port.state.delta, jax_store.state.delta)
    np.testing.assert_array_equal(port.route_index.nearest, jax_store.route_index.nearest)
