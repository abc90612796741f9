"""The instances of the port's route-expansion and embedding-bag kernels.

``route_expand.slots_instance`` and ``embedding_bag.instance`` name the
instance the CUDA entry point runs; here they are checked against the
documented rule, and the port's plain versions (what the wrappers run for
CPU tensors, and what the kernels are held to on the card) against the JAX
package's Pallas kernels in interpret mode and its oracles at the shapes
where one instance hands over to the next.  Integer route outputs must be
equal; route floats use the tolerances of ``tests/test_route_kernel.py``,
bags those of ``tests/test_kernels.py`` (1e-4 in f32, 3e-2 in bf16).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.embedding_bag import embedding_bag as jax_bag
from repro.kernels.route_expand import route_expand as jax_route_kernel
from repro_torch.kernels import embedding_bag as teb
from repro_torch.kernels import ref as tref
from repro_torch.kernels import route_expand as tre
from repro_torch.kernels.cuda_lib import launch_counters, reset_launch_counters


# ------------------------------------------------------------ route expansion
@pytest.mark.parametrize(
    "K,slots",
    [(0, 1), (1, 1), (32, 1), (33, 2), (64, 2), (65, 4), (128, 4), (129, 8), (256, 8),
     (257, 0), (1100, 0), (tre.MAX_SLOTS, 0)],
)
def test_slots_instance(K, slots):
    """Slots a lane: the smallest register instance with 32 * S >= K, shared
    memory (0) past 256."""
    assert tre.slots_instance(K) == slots


def test_slots_instance_past_shared_memory_raises():
    assert 9 * tre.MAX_SLOTS <= 232448 < 9 * (tre.MAX_SLOTS + 4)
    for K in (-1, tre.MAX_SLOTS + 1):
        with pytest.raises(ValueError, match="item slots"):
            tre.slots_instance(K)


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


@pytest.mark.parametrize("K,D,L,p_rep", [(256, 5, 3, 0.35), (257, 5, 3, 0.35),
                                         (256, 31, 4, 0.1), (257, 31, 4, 0.1)])
def test_route_expand_at_instance_boundary_matches_jax(K, D, L, p_rep):
    """The last register instance (256 slots) and the first shared-memory
    one (257), at the lane's 5 DCs and at 31 (every mask bit)."""
    prob = _route_problem(K + D, 6, K, D, L, p_rep)
    t = [torch.from_numpy(np.ascontiguousarray(x)) for x in prob]
    reset_launch_counters()
    got = [o.numpy() for o in tre.route_expand(*t)]  # CPU: the plain version
    assert launch_counters()["route_expand"].n == 0
    for o, w in zip(got, tref.route_expand_ref(*t)):
        np.testing.assert_array_equal(o, w.numpy())
    j = [jnp.asarray(x) for x in prob]
    lens = prob[2]
    for want in (jref.route_expand_ref(*j), jax_route_kernel(*j, block_r=8, interpret=True)):
        served, bytes_rd, layers, miss, strag, wan = (np.asarray(w) for w in want)
        for r, k in enumerate(lens):
            np.testing.assert_array_equal(got[0][r, :k], served[r, :k])
        np.testing.assert_array_equal(got[2], layers)
        np.testing.assert_array_equal(got[3], miss)
        np.testing.assert_allclose(got[1], bytes_rd, rtol=1e-5, atol=1e-4)
        np.testing.assert_allclose(got[4], strag, rtol=1e-5, atol=1e-7)
        np.testing.assert_allclose(got[5], wan, rtol=1e-5, atol=1e-4)
    assert (got[0][1] == -1).all() and got[3][1].sum() == 0  # the empty row


def _cuda_shaped(K, n_layers):
    """Tensors of a route batch's shapes (on the CPU: only their shapes,
    dtypes and contiguity reach the wrapper's checks)."""
    z = torch.zeros
    return (z((1, K), dtype=torch.int32), z((1, K)), z(1, dtype=torch.int32),
            z(1, dtype=torch.int32), z((n_layers + 1, 5), dtype=torch.int32), z((5, 5)),
            z((5, 5)))


@pytest.mark.parametrize("K,n_layers,match", [(tre.MAX_SLOTS + 1, 3, "item slots"),
                                              (8, tre.MAX_LAYERS + 1, "layers")])
def test_route_expand_shapes_no_instance_takes_raise(K, n_layers, match):
    """The CUDA wrapper refuses what no instance takes before a launch."""
    with pytest.raises(ValueError, match=match):
        tre._check_inputs(*_cuda_shaped(K, n_layers))
    tre._check_inputs(*_cuda_shaped(min(K, tre.MAX_SLOTS), min(n_layers, tre.MAX_LAYERS)))


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
