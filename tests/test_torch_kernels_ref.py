"""The port's plain kernel versions and kernel wrappers vs the JAX package.

Same seeded numpy inputs through ``repro_torch.kernels`` (CPU tensors) and
through the JAX oracles and Pallas kernels (interpret mode, as the JAX
package's own tests run them).  DHD tolerances are those of
``tests/test_kernels.py`` (atol 1e-5, rtol 1e-4: summation order differs);
route expansion integer outputs must be exactly equal, its floats use the
tolerances of ``tests/test_route_kernel.py``.  The port's route expansion
gives each read's bytes per DC as exact int64 units; the JAX oracle's bytes,
straggler latency and WAN bytes are held to those bytes and to Eq. 1 over
them, as the port's host epilogue folds them.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.graph import build_csr, build_ell
from repro.kernels import ref as jref
from repro.kernels.dhd_spmv import dhd_ell_step as jax_dhd_single_kernel
from repro.kernels.dhd_spmv import dhd_ell_step_batch as jax_dhd_kernel
from repro.kernels.route_expand import route_expand as jax_route_kernel
from repro_torch.core.route_tables import fold_shift
from repro_torch.kernels import ref as tref
from repro_torch.kernels.cuda_lib import launch_counters, reset_launch_counters
from repro_torch.kernels.dhd_spmv import dhd_ell_step as torch_dhd_single_wrapper
from repro_torch.kernels.dhd_spmv import dhd_ell_step_batch as torch_dhd_wrapper
from repro_torch.kernels.embedding_bag import embedding_bag as torch_bag_wrapper
from repro_torch.kernels.flash_attention import flash_attention as torch_attn_wrapper
from repro_torch.kernels.route_expand import route_expand_ragged as torch_ragged_wrapper

DHD_TOL = dict(atol=1e-5, rtol=1e-4)

DHD_CASES = [
    # n, kmax, B, per-field vals (the cases of tests/test_kernels.py)
    (64, 8, 4, False),
    (57, 6, 3, True),
    (128, 4, 2, True),
]


def _dhd_problem(n, kmax, B, per_field):
    rng = np.random.default_rng(6)
    m = n * kmax // 4
    src, dst = rng.integers(0, n, m), rng.integers(0, n, m)
    keep = src != dst
    a, b = np.minimum(src, dst)[keep], np.maximum(src, dst)[keep]
    _, i = np.unique(a.astype(np.int64) * n + b, return_index=True)
    a, b = a[i], b[i]
    w = (rng.random(len(a)) + 0.1).astype(np.float32)
    csr = build_csr(n, a, b, weights=w, symmetrize=True)
    ell = build_ell(csr, max_degree=int(csr.degree().max()))
    heat = rng.random((B, n)).astype(np.float32)
    q = (rng.random((B, n)) * 0.1).astype(np.float32)
    vals = ell.vals.astype(np.float32)
    if per_field:
        vals = np.repeat(vals[None], B, axis=0)
        vals *= rng.random(vals.shape) > 0.2  # drop edges per field
    return heat, np.asarray(ell.cols, np.int32), vals.astype(np.float32), q


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


@pytest.mark.parametrize("n,kmax,B,per_field", DHD_CASES)
def test_dhd_ref_batch_matches_jax(n, kmax, B, per_field):
    heat, cols, vals, q = _dhd_problem(n, kmax, B, per_field)
    got = tref.dhd_ell_ref_batch(_t(heat), _t(cols), _t(vals), _t(q)).numpy()
    want_ref = jref.dhd_ell_ref_batch(
        jnp.asarray(heat), jnp.asarray(cols), jnp.asarray(vals), jnp.asarray(q)
    )
    want_kernel = jax_dhd_kernel(
        jnp.asarray(heat), jnp.asarray(cols), jnp.asarray(vals), jnp.asarray(q),
        block_n=16, interpret=True,
    )
    np.testing.assert_allclose(got, np.asarray(want_ref), **DHD_TOL)
    np.testing.assert_allclose(got, np.asarray(want_kernel), **DHD_TOL)
    # single-field form == row b of the batch
    for k in range(B):
        vk = vals[k] if per_field else vals
        single = tref.dhd_ell_ref(_t(heat[k]), _t(cols), _t(vk), _t(q[k])).numpy()
        np.testing.assert_allclose(single, got[k], **DHD_TOL)


@pytest.mark.parametrize("n,kmax,B,per_field", DHD_CASES)
def test_dhd_count_pass_is_exact(n, kmax, B, per_field):
    """The count pass (the CUDA count kernel's plain version) is exact:
    |N_u^out| from numpy loops."""
    heat, cols, vals, _ = _dhd_problem(n, kmax, B, per_field)
    got = tref.dhd_ell_count_ref(_t(heat), _t(cols), _t(vals)).numpy()
    vb = vals if per_field else np.broadcast_to(vals, (B, n, kmax))
    want = ((vb > 0) & (heat[:, :, None] > heat[:, cols])).sum(axis=-1)
    np.testing.assert_array_equal(got, want.astype(np.float32))


# ------------------------------------------------------------ route expansion
def _rand_problem(rng, R, k_lo, k_hi, D, L, p_rep=0.35, all_ties=False,
                  single_origin=False, empty_layers=False):
    """Random packed batch + layer hierarchy (as tests/test_route_kernel.py)."""
    lens = rng.integers(k_lo, k_hi + 1, R)
    K = int(lens.max())
    bits = np.zeros((R, K), np.int32)
    sizes = np.zeros((R, K), np.float32)
    pow2 = 1 << np.arange(D)
    for r in range(R):
        k = int(lens[r])
        rep = np.ones((k, D), bool) if all_ties else rng.random((k, D)) < p_rep
        bits[r, :k] = (rep * pow2).sum(axis=1)
        sizes[r, :k] = (rng.random(k) + 0.25).astype(np.float32)
    origin = np.zeros(R, np.int64) if single_origin else rng.integers(0, D, R)
    comp = np.zeros((L + 1, D), np.int64)
    comp[0] = np.arange(D)
    prev = np.arange(D)
    for layer in range(1, L + 1):
        if empty_layers and layer == 1:
            comp[layer] = prev
            continue
        groups = max(1, D // (layer + 1))
        prev = rng.integers(0, groups, int(prev.max()) + 1)[prev]
        comp[layer] = prev
    rtt = rng.random((D, D)).astype(np.float32) * 0.2
    rtt = rtt + rtt.T
    np.fill_diagonal(rtt, 0.0)
    ibw = (1.0 / (rng.random((D, D)) * 1e9 + 1e8)).astype(np.float32)
    np.fill_diagonal(ibw, 0.0)
    return (bits, sizes, lens.astype(np.int32), origin.astype(np.int32),
            comp.astype(np.int32), rtt, ibw)


def _assert_route_match(got, want, lens):
    served_g, bytes_g, layers_g, miss_g, strag_g, wan_g = got
    served_w, bytes_w, layers_w, miss_w, strag_w, wan_w = (np.asarray(w) for w in want)
    for r, k in enumerate(lens):
        np.testing.assert_array_equal(served_g[r, :k], served_w[r, :k])
    np.testing.assert_array_equal(layers_g, layers_w)
    np.testing.assert_array_equal(miss_g, miss_w)
    np.testing.assert_allclose(bytes_g, bytes_w, rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(strag_g, strag_w, rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(wan_g, wan_w, rtol=1e-5, atol=1e-4)


SWEEP = [
    # R, k_lo, k_hi, D, L, p_rep, all_ties, single_origin, empty_layers
    (8, 1, 24, 5, 3, 0.35, False, False, False),
    (16, 2, 40, 4, 1, 0.5, False, False, False),
    (8, 1, 16, 8, 5, 0.2, False, False, False),
    (8, 4, 20, 5, 3, 0.0, True, False, False),  # all ties -> lowest DC id
    (8, 1, 24, 5, 3, 0.35, False, True, False),  # single-origin batch
    (8, 1, 24, 6, 4, 0.3, False, False, True),  # empty first layer
    (4, 1, 8, 5, 2, 0.05, False, False, False),  # mostly-unresolvable items
]


def _flat(prob):
    """A padded batch's requests as the flat item stream, as CPU tensors
    ``(bits, sizes, offsets, origin, comp)``, and the sizes' shift."""
    bits, sizes, lens = prob[:3]
    keep = np.arange(bits.shape[1])[None, :] < lens[:, None]
    offsets = np.concatenate([[0], np.cumsum(lens)]).astype(np.int32)
    shift = fold_shift(sizes[keep])
    assert shift is not None
    return (_t(bits[keep]), _t(sizes[keep]), _t(offsets), _t(prob[3]), _t(prob[4])), shift


def _ragged_on_tiles(fn, prob):
    """``fn`` (the ragged wrapper or its plain version) on a padded batch,
    its picks laid back out as ``[R, K]`` (-1 past each request's length),
    and its exact sums as the JAX oracle's ``(bytes_rd, straggler, wan)``:
    the bytes ``units * 2**-shift``, Eq. 1 over them.  Its served-DC masks
    and unresolved counts must be those of its picks."""
    flat, shift = _flat(prob)
    served_f, units, layers, miss, served_dcs, n_miss = (o.numpy() for o in fn(*flat, shift))
    bits, _, lens, origin, _, rtt, ibw = prob
    D = units.shape[1]
    served = np.full(bits.shape, -1, np.int32)
    served[np.arange(bits.shape[1])[None, :] < lens[:, None]] = served_f
    for r, k in enumerate(lens):
        picks = served[r, :k]
        assert served_dcs[r] == sum(1 << int(d) for d in np.unique(picks[picks >= 0]))
        assert n_miss[r] == (picks < 0).sum()
    b = np.ldexp(units.astype(np.float64), -shift)
    o = np.asarray(origin, np.int64)
    mask = ((served_dcs[:, None] >> np.arange(D)) & 1).astype(bool)
    away = np.arange(D)[None, :] != o[:, None]
    lat = np.where(mask & away, rtt[:, o].T + b * ibw[:, o].T, 0.0)
    return served, b, layers, miss, lat.max(axis=1), np.where(away, b, 0.0).sum(axis=1)


def _route_both(prob):
    got = _ragged_on_tiles(tref.route_expand_ragged_ref, prob)
    want_ref = jref.route_expand_ref(*(jnp.asarray(x) for x in prob))
    want_kernel = jax_route_kernel(*(jnp.asarray(x) for x in prob), block_r=8,
                                   interpret=True)
    return got, want_ref, want_kernel


@pytest.mark.parametrize("R,k_lo,k_hi,D,L,p_rep,ties,single,empty", SWEEP)
def test_route_expand_ref_matches_jax(R, k_lo, k_hi, D, L, p_rep, ties, single, empty):
    rng = np.random.default_rng(R * 1000 + D * 10 + L)
    prob = _rand_problem(rng, R, k_lo, k_hi, D, L, p_rep, all_ties=ties,
                         single_origin=single, empty_layers=empty)
    got, want_ref, want_kernel = _route_both(prob)
    _assert_route_match(got, want_ref, prob[2])
    _assert_route_match(got, want_kernel, prob[2])


@pytest.mark.parametrize("k_hi", [500, 600])
def test_route_expand_field_word_boundary(k_hi):
    """K around the JAX kernel's 512-slot field-word gate."""
    rng = np.random.default_rng(99 + k_hi)
    prob = _rand_problem(rng, 4, k_hi - 4, k_hi, 5, 3)
    got, want_ref, want_kernel = _route_both(prob)
    _assert_route_match(got, want_ref, prob[2])
    _assert_route_match(got, want_kernel, prob[2])


def test_wrappers_take_plain_version_on_cpu():
    """On CPU tensors the kernel wrappers return the plain versions' results
    and launch nothing."""
    reset_launch_counters()
    heat, cols, vals, q = _dhd_problem(57, 6, 3, True)
    got = torch_dhd_wrapper(_t(heat), _t(cols), _t(vals), _t(q))
    want = tref.dhd_ell_ref_batch(_t(heat), _t(cols), _t(vals), _t(q))
    assert torch.equal(got, want)
    prob = _rand_problem(np.random.default_rng(3), 8, 1, 24, 5, 3)
    ragged, shift = _flat(prob)
    # the wrapper takes item ids over tables: slot k's id perm[k] keys its row
    bits, sizes, rest = ragged[0], ragged[1], ragged[2:]
    perm = torch.randperm(len(bits), generator=torch.Generator().manual_seed(3))
    tables = (torch.empty_like(bits), torch.empty_like(sizes))
    tables[0][perm], tables[1][perm] = bits, sizes
    got_r = torch_ragged_wrapper(perm.to(torch.int32), *tables, *rest, shift)
    for a, b in zip(got_r, tref.route_expand_ragged_ref(*ragged, shift)):
        assert torch.equal(a, b)
    got_s = torch_dhd_single_wrapper(_t(heat[0]), _t(cols), _t(vals[0]), _t(q[0]))
    assert torch.equal(got_s, tref.dhd_ell_ref(_t(heat[0]), _t(cols), _t(vals[0]), _t(q[0])))
    rng = np.random.default_rng(4)
    qkv = [_t(rng.standard_normal((1, 2, 9, 8)).astype(np.float32)) for _ in range(3)]
    assert torch.equal(torch_attn_wrapper(*qkv), tref.attention_ref(*qkv))
    tab = _t(rng.standard_normal((30, 4)).astype(np.float32))
    idx = _t(rng.integers(0, 30, (5, 3)).astype(np.int32))
    assert torch.equal(torch_bag_wrapper(tab, idx, mode="mean"),
                       tref.embedding_bag_ref(tab, idx, mode="mean"))
    counts = {k: c.n for k, c in launch_counters().items()}
    assert set(counts) == {
        "dhd_count", "dhd_flow", "dhd_count_single", "dhd_flow_single",
        "route_expand_ragged", "flash_attention", "embedding_bag",
    }
    assert all(n == 0 for n in counts.values()), counts


def test_dhd_step_batch_dispatch_matches_jax():
    """``ops.dhd_step_batch``: the exact edge form over ELL + COO tail, and
    the ELL path (kernel wrapper's plain version on CPU) without a tail."""
    from repro.kernels import ops as jops
    from repro_torch.kernels import ops as tops

    rng = np.random.default_rng(8)
    n, B = 48, 3
    src, dst = rng.integers(0, n, 300), rng.integers(0, n, 300)
    keep = src != dst
    a, b = np.minimum(src, dst)[keep], np.maximum(src, dst)[keep]
    _, i = np.unique(a.astype(np.int64) * n + b, return_index=True)
    a, b = a[i], b[i]
    w = (rng.random(len(a)) + 0.1).astype(np.float32)
    csr = build_csr(n, a, b, weights=w, symmetrize=True)
    heat = rng.random((B, n)).astype(np.float32)
    q = (rng.random((B, n)) * 0.1).astype(np.float32)
    for max_degree in (3, int(csr.degree().max())):
        ell = build_ell(csr, max_degree=max_degree)
        tail = (ell.tail_src, ell.tail_dst, ell.tail_val)
        assert (len(ell.tail_src) > 0) == (max_degree == 3)
        want = jops.dhd_step_batch(
            jnp.asarray(heat), jnp.asarray(ell.cols), jnp.asarray(ell.vals),
            jnp.asarray(q), *(jnp.asarray(t) for t in tail),
        )
        got = tops.dhd_step_batch(
            _t(heat), _t(np.asarray(ell.cols, np.int32)),
            _t(np.asarray(ell.vals, np.float32)), _t(q), *(_t(t) for t in tail),
        )
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **DHD_TOL)


# ------------------------------------------------------- single-field DHD
SINGLE_CASES = [
    # n, ELL width beyond the max degree (self-pad slots of weight 0)
    (256, 0),  # a multiple of the JAX kernel's 256-row block
    (300, 8),  # not a multiple: the JAX wrapper pads, the port masks
    (57, 3),
]


def _single_problem(n, extra, seed=11):
    rng = np.random.default_rng(seed + n)
    m = 3 * n
    src, dst = rng.integers(0, n, m), rng.integers(0, n, m)
    keep = src != dst
    a, b = np.minimum(src, dst)[keep], np.maximum(src, dst)[keep]
    _, i = np.unique(a.astype(np.int64) * n + b, return_index=True)
    a, b = a[i], b[i]
    w = (rng.random(len(a)) + 0.1).astype(np.float32)
    csr = build_csr(n, a, b, weights=w, symmetrize=True)
    ell = build_ell(csr, max_degree=int(csr.degree().max()) + extra)
    heat = rng.random(n).astype(np.float32)
    q = (rng.random(n) * 0.1).astype(np.float32)
    return heat, np.asarray(ell.cols, np.int32), np.asarray(ell.vals, np.float32), q, csr


@pytest.mark.parametrize("n,extra", SINGLE_CASES)
def test_dhd_single_step_matches_jax(n, extra):
    """The port's ``dhd_ell_step`` and ``ops.dhd_step`` (CPU: the plain
    version) against the JAX Pallas kernel in interpret mode and its
    oracle, with the streaming path's alpha."""
    from repro_torch.kernels import ops as tops

    reset_launch_counters()
    heat, cols, vals, q, _ = _single_problem(n, extra)
    if extra:
        assert (vals == 0).any(axis=1).all()  # every row has a pad slot
        pad = vals == 0
        assert (cols[pad] == np.nonzero(pad)[0]).all()  # pad = self
    p = dict(alpha=0.013, gamma=0.1, beta=0.3)
    args = (jnp.asarray(heat), jnp.asarray(cols), jnp.asarray(vals), jnp.asarray(q))
    want_kernel = np.asarray(jax_dhd_single_kernel(*args, **p, interpret=True))
    want_ref = np.asarray(jref.dhd_ell_ref(*args, **p))
    targs = (_t(heat), _t(cols), _t(vals), _t(q))
    for got in (
        torch_dhd_single_wrapper(*targs, **p),
        tops.dhd_step(*targs, **p),
        tops.dhd_step(*targs, **p, use_kernel=False),
    ):
        np.testing.assert_allclose(got.numpy(), want_kernel, **DHD_TOL)
        np.testing.assert_allclose(got.numpy(), want_ref, **DHD_TOL)
    # the count pass alone is exact
    n_out = tref.dhd_ell_count_ref(_t(heat)[None], _t(cols), _t(vals))[0].numpy()
    want_n = ((vals > 0) & (heat[:, None] > heat[cols])).sum(axis=1)
    np.testing.assert_array_equal(n_out, want_n.astype(np.float32))
    assert all(c.n == 0 for c in launch_counters().values())


def test_dhd_single_step_coo_tail_matches_jax():
    """A COO tail: the port's edge form over the cached edge list against
    the JAX ``ops.dhd_step`` tail path, and against the tail-free ELL."""
    from repro.kernels import ops as jops
    from repro_torch.kernels import ops as tops

    heat, _, _, q, csr = _single_problem(120, 0)
    full = build_ell(csr, max_degree=int(csr.degree().max()))
    ell = build_ell(csr, max_degree=3)
    assert len(ell.tail_src) > 0
    tail = (ell.tail_src, ell.tail_dst, ell.tail_val)
    want = jops.dhd_step(
        jnp.asarray(heat), jnp.asarray(ell.cols), jnp.asarray(ell.vals),
        jnp.asarray(q), *(jnp.asarray(t) for t in tail),
    )
    got = tops.dhd_step(
        _t(heat), _t(np.asarray(ell.cols, np.int32)),
        _t(np.asarray(ell.vals, np.float32)), _t(q), *(_t(t) for t in tail),
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **DHD_TOL)
    no_tail = tops.dhd_step(
        _t(heat), _t(np.asarray(full.cols, np.int32)),
        _t(np.asarray(full.vals, np.float32)), _t(q),
    )
    np.testing.assert_allclose(got.numpy(), no_tail.numpy(), **DHD_TOL)


def test_dhd_single_wrapper_checks_its_inputs():
    """What the kernel does not take raises before any launch: a device
    other than cpu/cuda, and (checked for CUDA tensors) wrong shapes and
    types."""
    from repro_torch.kernels.dhd_spmv import _check_inputs

    heat, cols, vals, q, _ = _single_problem(57, 3)
    h, c, v, qq = _t(heat), _t(cols), _t(vals), _t(q)
    _check_inputs(h, c, v, qq, single=True)
    with pytest.raises(ValueError, match="heat must be"):
        _check_inputs(h[None], c, v, qq, single=True)
    with pytest.raises(ValueError, match="vals must be"):
        _check_inputs(h, c, v[None], qq, single=True)
    with pytest.raises(ValueError, match="q must be"):
        _check_inputs(h, c, v, qq[:-1], single=True)
    with pytest.raises(TypeError, match="cols must be"):
        _check_inputs(h, c.long(), v, qq, single=True)
    with pytest.raises(ValueError, match="runs on cpu or cuda"):
        torch_dhd_single_wrapper(h.to("meta"), c.to("meta"), v.to("meta"), qq.to("meta"))
