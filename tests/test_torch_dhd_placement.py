"""The port's DHD diffusion (placement, pre-caching, maintenance) vs the JAX
package, on the edge path and on the ELL path (the kernels' plain version on
CPU tensors).  Tolerance atol 1e-5, rtol 1e-4 as ``tests/test_kernels.py``:
the summation order differs."""
import numpy as np
import pytest

from repro.core import dhd as jdhd
from repro_torch.core import dhd as tdhd
from repro_torch.kernels.cuda_lib import launch_counters, reset_launch_counters

TOL = dict(atol=1e-5, rtol=1e-4)


def _problem(n, m, B, per_seed, seed):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, m)
    dst = rng.integers(0, n, m)
    keep = src != dst
    src, dst = src[keep], dst[keep]
    w = (rng.random(len(src)) + 0.1).astype(np.float32)
    if per_seed:
        w = np.repeat(w[None], B, axis=0) * (rng.random((B, len(src))) > 0.3)
        w = w.astype(np.float32)
    seeds = np.zeros((B, n), np.float32)
    for b in range(B):
        seeds[b, rng.integers(0, n, 3)] = 1.0
    base = rng.random(n).astype(np.float32)
    return src, dst, w, seeds, base


CASES = [
    # n, m, B, per-seed weights, base heat, n_steps
    (40, 120, 4, False, False, 32),
    (33, 90, 3, True, False, 8),
    (64, 200, 5, False, True, 4),
    (25, 60, 2, True, True, 48),
]


@pytest.mark.parametrize("use_kernel", [False, True], ids=["edges", "ell"])
@pytest.mark.parametrize("n,m,B,per_seed,with_base,n_steps", CASES)
def test_diffuse_affinity_batch_matches_jax(n, m, B, per_seed, with_base, n_steps,
                                            use_kernel):
    src, dst, w, seeds, base = _problem(n, m, B, per_seed, seed=n + m)
    base_heat = base if with_base else None
    want = jdhd.diffuse_affinity_batch(
        n, src, dst, w, seeds, base_heat=base_heat, n_steps=n_steps,
        use_kernel=use_kernel,
    )
    reset_launch_counters()
    got = tdhd.diffuse_affinity_batch(
        n, src, dst, w, seeds, base_heat=base_heat, n_steps=n_steps,
        use_kernel=use_kernel, device="cpu",
    )
    assert got.dtype == np.float32 and got.shape == (B, n)
    np.testing.assert_allclose(got, np.asarray(want), **TOL)
    assert all(c.n == 0 for c in launch_counters().values())


def test_diffuse_affinity_single_matches_jax():
    src, dst, w, seeds, base = _problem(30, 80, 1, False, seed=7)
    want = jdhd.diffuse_affinity(30, src, dst, w, seeds[0], base_heat=base, n_steps=16)
    got = tdhd.diffuse_affinity(
        30, src, dst, w, seeds[0], base_heat=base, n_steps=16, device="cpu"
    )
    np.testing.assert_allclose(got, np.asarray(want), **TOL)


def test_dense_step_and_steady_state_match_jax():
    import jax.numpy as jnp
    import torch

    rng = np.random.default_rng(11)
    n = 12
    adj = rng.random((n, n)) * (rng.random((n, n)) < 0.4)
    adj = np.triu(adj, 1)
    adj = (adj + adj.T).astype(np.float32)
    h = rng.random(n).astype(np.float32)
    q = (rng.random(n) * 0.1).astype(np.float32)
    want = jdhd.dhd_step_dense(jnp.asarray(h), jnp.asarray(adj), jnp.asarray(q))
    got = tdhd.dhd_step_dense(torch.from_numpy(h), torch.from_numpy(adj), torch.from_numpy(q))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)

    l_dir = tdhd.build_l_dir(torch.from_numpy(h), torch.from_numpy(adj))
    np.testing.assert_allclose(
        l_dir.numpy(), np.asarray(jdhd.build_l_dir(jnp.asarray(h), jnp.asarray(adj))),
        **TOL,
    )
    assert tdhd.convergence_alpha_bound(l_dir) == pytest.approx(
        jdhd.convergence_alpha_bound(jnp.asarray(l_dir.numpy())), rel=1e-6
    )

    def step_t(x, qq):
        return tdhd.dhd_step_dense(x, torch.from_numpy(adj), qq)

    def step_j(x, qq):
        return jdhd.dhd_step_dense(x, jnp.asarray(adj), qq)

    h_t, k_t = tdhd.steady_state(
        torch.from_numpy(h), step_t, lambda k: torch.from_numpy(q), tol=1e-6,
        max_iters=200,
    )
    h_j, k_j = jdhd.steady_state(
        jnp.asarray(h), step_j, lambda k: jnp.asarray(q), tol=1e-6, max_iters=200
    )
    assert int(k_t) == int(k_j)
    np.testing.assert_allclose(h_t.numpy(), np.asarray(h_j), **TOL)


@pytest.mark.parametrize("use_kernel", [False, True], ids=["edges", "ell"])
def test_placement_arena_and_precache_match_jax(small_setup, monkeypatch, use_kernel):
    """The placement arena's batched heat table and the pre-cached hot set
    on the fixture graph, port (edge or ELL path) vs JAX."""
    from repro.core import placement as jpl
    from repro.core.cost import PlacementState as JState
    from repro.core.patterns import decompose_overlap_regions
    from repro_torch.core import placement as tpl
    from repro_torch.core.cost import PlacementState as TState
    from repro_torch.kernels import ops

    plain = ops.diffuse_batch
    monkeypatch.setattr(
        ops, "diffuse_batch", lambda *a, **k: plain(*a, **{**k, "use_kernel": use_kernel})
    )
    g, env, csr, wl, pats = small_setup
    regions = decompose_overlap_regions(pats[:12], g.n_items)
    cand = [
        (d, np.asarray([d]), [p.items for p in pats[12 + 3 * d : 15 + 3 * d]])
        for d in range(env.n_dcs)
    ]
    want_h, want_v = jpl.CompetitionArena._build(regions, g, cand, jdhd.DHDParams(), 8)
    got_h, got_v = tpl.CompetitionArena._build(
        regions, g, cand, tdhd.DHDParams(), 8, device="cpu"
    )
    assert want_h is not None and want_v.any()
    np.testing.assert_array_equal(got_v, want_v)
    np.testing.assert_allclose(got_h, want_h, **TOL)

    js = JState.empty(g.n_items, env.n_dcs)
    ts = TState.empty(g.n_items, env.n_dcs)
    hot_j = jpl.precache_hot_regions(g, wl, js, 0.55, jdhd.DHDParams(), n_steps=16)
    hot_t = tpl.precache_hot_regions(
        g, wl, ts, 0.55, tdhd.DHDParams(), n_steps=16, device="cpu"
    )
    np.testing.assert_array_equal(hot_t, hot_j)
    np.testing.assert_array_equal(ts.delta, js.delta)
