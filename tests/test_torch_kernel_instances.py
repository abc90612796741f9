"""The instances of the port's route-expansion and embedding-bag kernels.

``route_expand.ragged_order`` says which reads a warp walks and which a
block, and ``embedding_bag.instance`` names the instance the CUDA entry
point runs; here they are checked against the documented rule, and the
port's plain versions (what the wrappers run for CPU tensors, and what the
kernels are held to on the card) against the JAX package's Pallas kernels
in interpret mode and its oracles at the shapes where one instance hands
over to the next.  Integer route outputs must be equal; the JAX oracle's
route floats are held to the port's exact bytes per DC and Eq. 1 over them
within the tolerances of ``tests/test_route_kernel.py``, bags to those of
``tests/test_kernels.py`` (1e-4 in f32, 3e-2 in bf16).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.embedding_bag import embedding_bag as jax_bag
from repro.kernels.route_expand import route_expand as jax_route_kernel
from repro_torch.core.route_tables import fold_shift
from repro_torch.kernels import embedding_bag as teb
from repro_torch.kernels import ref as tref
from repro_torch.kernels import route_expand as tre
from repro_torch.kernels.cuda_lib import launch_counters, reset_launch_counters


# ------------------------------------------------------------ route expansion
@pytest.mark.parametrize(
    "K,walker",
    [(0, "warp"), (1, "warp"), (32, "warp"), (33, "warp"), (64, "warp"), (65, "warp"),
     (128, "warp"), (129, "warp"), (256, "warp"), (257, "block"), (1100, "block"),
     (25_825, "block")],
)
def test_read_walked_by_a_warp_or_a_block(K, walker):
    """A read of up to a warp's share of slots gets a warp, a longer one a
    block of its own, listed first."""
    lens = np.array([3, K, 3])
    order, n_long = tre.ragged_order(lens)
    assert sorted(order.tolist()) == [0, 1, 2] and order.dtype == np.int32
    assert n_long == (walker == "block")
    if walker == "block":
        assert order[0] == 1


def test_ragged_takes_reads_past_a_warps_shared_memory():
    """No bound on a read's length: 40,000 slots in one read, more than the
    232,448 bytes of a block's shared memory held at 9 bytes a slot."""
    assert 9 * 40_000 > 232_448
    tre._check_ragged(*_ragged_shaped(40_000, 3, 5))


def _route_problem(seed, R, K, D, L, p_rep):
    """Random packed batch with row 0 exactly K long, one empty row, and a
    layer hierarchy of L layers over D DCs."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(1, K + 1, R)
    lens[0], lens[1] = K, 0
    bits = np.zeros((R, K), np.int32)
    sizes = np.zeros((R, K), np.float32)
    pow2 = 1 << np.arange(D, dtype=np.int64)
    for r in range(R):
        k = int(lens[r])
        bits[r, :k] = ((rng.random((k, D)) < p_rep) * pow2).sum(axis=1)
        sizes[r, :k] = rng.random(k) + 0.25
    comp = np.zeros((L + 1, D), np.int32)
    comp[0] = np.arange(D)
    prev = np.arange(D)
    for layer in range(1, L + 1):
        prev = rng.integers(0, max(1, D // (layer + 1)), int(prev.max()) + 1)[prev]
        comp[layer] = prev
    rtt = (rng.random((D, D)) * 0.2).astype(np.float32)
    rtt = rtt + rtt.T
    np.fill_diagonal(rtt, 0.0)
    ibw = (1.0 / (rng.random((D, D)) * 1e9 + 1e8)).astype(np.float32)
    np.fill_diagonal(ibw, 0.0)
    origin = rng.integers(0, D, R).astype(np.int32)
    return bits, sizes, lens.astype(np.int32), origin, comp, rtt, ibw


def _flat(prob):
    """A padded batch's requests as the flat item stream, as CPU tensors
    ``[bits, sizes, offsets, origin, comp]``."""
    bits, sizes, lens = prob[:3]
    keep = np.arange(bits.shape[1])[None, :] < lens[:, None]
    offsets = np.concatenate([[0], np.cumsum(lens)]).astype(np.int32)
    return [torch.from_numpy(np.ascontiguousarray(x))
            for x in (bits[keep], sizes[keep], offsets, *prob[3:5])]


@pytest.mark.parametrize("K,D,L,p_rep", [(256, 5, 3, 0.35), (257, 5, 3, 0.35),
                                         (256, 31, 4, 0.1), (257, 31, 4, 0.1)])
def test_route_expand_at_instance_boundary_matches_jax(K, D, L, p_rep):
    """The longest read a warp walks (256 slots) and the shortest a block
    walks (257), at the lane's 5 DCs and at 31 (every mask bit)."""
    prob = _route_problem(K + D, 6, K, D, L, p_rep)
    t = _flat(prob)
    shift = fold_shift(t[1].numpy())
    # the wrapper (on the CPU its plain version) takes item ids over tables:
    # slot k's id perm[k] keys its row
    perm = torch.randperm(len(t[0]), generator=torch.Generator().manual_seed(K))
    tables = (torch.empty_like(t[0]), torch.empty_like(t[1]))
    tables[0][perm], tables[1][perm] = t[0], t[1]
    reset_launch_counters()
    got = [o.numpy() for o in tre.route_expand_ragged(perm.to(torch.int32), *tables, *t[2:],
                                                      shift)]
    assert launch_counters()["route_expand_ragged"].n == 0
    for o, w in zip(got, tref.route_expand_ragged_ref(*t, shift)):
        np.testing.assert_array_equal(o, w.numpy())
    served_f, units, layers_g, miss_g, served_dcs, n_miss = got
    # the JAX oracle's floats from the exact sums: bytes, then Eq. 1 over them
    _, _, _, origin, _, rtt, ibw = prob
    o = origin.astype(np.int64)
    b = np.ldexp(units.astype(np.float64), -shift)
    mask = ((served_dcs[:, None] >> np.arange(D)) & 1).astype(bool)
    away = np.arange(D)[None, :] != o[:, None]
    strag_g = np.where(mask & away, rtt[:, o].T + b * ibw[:, o].T, 0.0).max(axis=1)
    wan_g = np.where(away, b, 0.0).sum(axis=1)
    j = [jnp.asarray(x) for x in prob]
    lens = prob[2]
    bounds = np.concatenate([[0], np.cumsum(lens)])
    for want in (jref.route_expand_ref(*j), jax_route_kernel(*j, block_r=8, interpret=True)):
        served, bytes_rd, layers, miss, strag, wan = (np.asarray(w) for w in want)
        for r, k in enumerate(lens):
            np.testing.assert_array_equal(served_f[bounds[r]:bounds[r + 1]], served[r, :k])
            picks = served[r, :k]
            assert served_dcs[r] == sum(1 << int(d) for d in np.unique(picks[picks >= 0]))
            assert n_miss[r] == (picks < 0).sum()
        np.testing.assert_array_equal(layers_g, layers)
        np.testing.assert_array_equal(miss_g, miss)
        np.testing.assert_allclose(b, bytes_rd, rtol=1e-5, atol=1e-4)
        np.testing.assert_allclose(strag_g, strag, rtol=1e-5, atol=1e-7)
        np.testing.assert_allclose(wan_g, wan, rtol=1e-5, atol=1e-4)
    assert lens[1] == 0 and miss_g[1].sum() == 0  # the empty read


def _ragged_shaped(N, n_layers, D):
    """Tensors of a one-read ragged batch's shapes (on the CPU: only their
    shapes, dtypes and contiguity reach the wrapper's checks)."""
    z = torch.zeros
    i32 = dict(dtype=torch.int32)
    return (z(N, **i32), z(N, **i32), z(N), torch.tensor([0, N], **i32), z(1, **i32),
            z(1, **i32), z((n_layers + 1, D), **i32))


@pytest.mark.parametrize("n_layers,D,match", [(tre.MAX_LAYERS + 1, 5, "layers"),
                                              (3, tre.MAX_DCS + 1, "DCs")])
def test_route_expand_shapes_no_instance_takes_raise(n_layers, D, match):
    """The CUDA wrapper refuses what the kernel cannot take before a launch."""
    with pytest.raises(ValueError, match=match):
        tre._check_ragged(*_ragged_shaped(8, n_layers, D))
    tre._check_ragged(*_ragged_shaped(8, min(n_layers, tre.MAX_LAYERS), min(D, tre.MAX_DCS)))


# ------------------------------------------------------------- embedding bag
def _misaligned(t):
    """The same values one element past a 16-byte-aligned base."""
    flat = torch.empty(t.numel() + 1, dtype=t.dtype)
    return flat[1:].view(t.shape).copy_(t)


@pytest.mark.parametrize(
    "dtype,D,L,aligned,want",
    [
        (torch.float32, 32, 20, True, ("float32", 16, 8, 5)),  # BST: 4 rows a load
        (torch.bfloat16, 32, 20, True, ("bfloat16", 16, 4, 3)),
        (torch.float32, 16, 64, True, ("float32", 16, 4, 4)),
        (torch.float32, 48, 33, True, ("float32", 16, 16, 8)),  # 12 loads on 16 lanes
        (torch.bfloat16, 48, 33, True, ("bfloat16", 16, 8, 8)),
        (torch.float32, 128, 1, True, ("float32", 16, 32, 1)),
        (torch.float32, 256, 20, True, ("float32", 16, 32, 8)),  # two passes of 32 loads
        (torch.float32, 33, 20, True, ("float32", 4, 32, 8)),  # not whole 16-byte pieces
        (torch.bfloat16, 33, 20, True, ("bfloat16", 2, 32, 8)),
        (torch.float32, 32, 20, False, ("float32", 4, 32, 8)),  # misaligned base
        (torch.float32, 4, 0, True, ("float32", 16, 1, 0)),
    ],
)
def test_bag_instance(dtype, D, L, aligned, want):
    table = torch.zeros((64, D), dtype=dtype)
    if not aligned:
        table = _misaligned(table)
    assert teb.instance(table, torch.zeros((3, L), dtype=torch.int32)) == want


def _bag_inputs(V, D, B, L, dtype, weights, seed):
    rng = np.random.default_rng(seed)
    tab = rng.standard_normal((V, D)).astype(np.float32)
    idx = rng.integers(0, V, (B, L)).astype(np.int32)
    w = None
    if weights == "rand":
        w = rng.random((B, L)).astype(np.float32)
    elif weights == "zero":
        w = np.zeros((B, L), np.float32)
    jt = jnp.asarray(tab, getattr(jnp, dtype))
    tt = torch.from_numpy(tab).to(getattr(torch, dtype))
    jw = None if w is None else jnp.asarray(w, getattr(jnp, dtype))
    tw = None if w is None else torch.from_numpy(w)
    return (jt, jnp.asarray(idx), jw), (tt, torch.from_numpy(idx), tw)


@pytest.mark.parametrize(
    "V,D,B,L,dtype,mode,weights",
    [
        (256, 48, 64, 33, "bfloat16", "sum", "rand"),  # L past one chunk of 32 ids
        (256, 48, 64, 33, "bfloat16", "mean", "none"),
        (256, 32, 64, 33, "float32", "sum", "none"),
        (256, 32, 64, 20, "float32", "mean", "zero"),  # 0 / max(0, 1e-9) = 0
        (256, 48, 64, 20, "bfloat16", "mean", "zero"),
    ],
)
def test_bag_at_new_shapes_matches_jax(V, D, B, L, dtype, mode, weights):
    (jt, ji, jw), (tt, ti, tw) = _bag_inputs(V, D, B, L, dtype, weights, seed=L + D)
    tol = 1e-4 if dtype == "float32" else 3e-2
    want_kernel = np.asarray(
        jax_bag(jt, ji, jw, mode=mode, interpret=True, block_b=32, block_v=128), np.float32)
    want_ref = np.asarray(jref.embedding_bag_ref(jt, ji, jw, mode=mode), np.float32)
    reset_launch_counters()
    got = teb.embedding_bag(tt, ti, tw, mode=mode)  # CPU: the plain version
    assert launch_counters()["embedding_bag"].n == 0
    assert got.dtype == tt.dtype and tuple(got.shape) == (B, D)
    assert torch.equal(got, tref.embedding_bag_ref(tt, ti, tw, mode=mode))
    for want in (want_kernel, want_ref):
        np.testing.assert_allclose(got.float().numpy(), want, atol=tol, rtol=tol)
    if weights == "zero":
        assert not got.float().any()
