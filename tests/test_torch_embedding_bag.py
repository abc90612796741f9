"""The port's embedding bag (kernel wrapper, dispatch, plain version and
``models.recsys.embedding``) against the JAX package on the same seeded
inputs: the Pallas kernel in interpret mode and the oracle
``embedding_bag_ref``.  Tolerances are the reference's own
(``tests/test_kernels.py``): 1e-4 in f32, 3e-2 in bf16.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.embedding_bag import embedding_bag as jax_bag
from repro.models.recsys import embedding as jemb
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref
from repro_torch.kernels.cuda_lib import launch_counters, reset_launch_counters
from repro_torch.kernels.embedding_bag import _check_inputs, embedding_bag
from repro_torch.models.recsys import embedding as temb

# the reference's BAG_SWEEP (tests/test_kernels.py), then B and V that its
# 32-bag and 256-row tiles do not divide
BAG_SWEEP = [
    (2048, 32, 256, 20, "sum", "float32"),
    (4096, 64, 128, 8, "mean", "float32"),
    (1024, 16, 64, 5, "sum", "float32"),
    (512, 8, 32, 3, "sum", "bfloat16"),
]
RAGGED = [
    (1000, 32, 77, 20, "sum", "float32"),
    (777, 40, 33, 7, "mean", "float32"),
    (300, 24, 50, 4, "mean", "bfloat16"),
]
TOL = {"float32": 1e-4, "bfloat16": 3e-2}


def _bags(V, D, B, L, dtype, seed=2):
    rng = np.random.default_rng(seed)
    tab = rng.standard_normal((V, D)).astype(np.float32)
    idx = rng.integers(0, V, (B, L)).astype(np.int32)
    w = rng.random((B, L)).astype(np.float32)
    jx = (jnp.asarray(tab, getattr(jnp, dtype)), jnp.asarray(idx),
          jnp.asarray(w, getattr(jnp, dtype)))
    tx = (torch.from_numpy(tab).to(getattr(torch, dtype)), torch.from_numpy(idx),
          torch.from_numpy(w).to(getattr(torch, dtype)))
    return jx, tx


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("weighted", [True, False], ids=["weighted", "ones"])
@pytest.mark.parametrize("case", BAG_SWEEP + RAGGED, ids=str)
def test_bag_matches_jax_kernel_and_ref(case, weighted):
    V, D, B, L, mode, dtype = case
    (jt, ji, jw), (tt, ti, tw) = _bags(V, D, B, L, dtype)
    jw = jw if weighted else None
    tw = tw if weighted else None
    blocks = dict(block_b=32, block_v=256) if (B % 32, V % 256) == (0, 0) else \
        dict(block_b=B, block_v=V)
    want_kernel = jax_bag(jt, ji, jw, mode=mode, interpret=True, **blocks)
    want_ref = jref.embedding_bag_ref(jt, ji, jw, mode=mode)
    reset_launch_counters()
    for got in (
        ops.bag_lookup(tt, ti, tw, mode=mode),
        ops.bag_lookup(tt, ti.long(), tw, mode=mode),  # int64 ids are cast
        tref.embedding_bag_ref(tt, ti, None if tw is None else tw.float(), mode=mode),
        embedding_bag(tt, ti, None if tw is None else tw.float(), mode=mode),
    ):
        assert got.dtype == tt.dtype and tuple(got.shape) == (B, D)
        _close(got, want_kernel, TOL[dtype])
        _close(got, want_ref, TOL[dtype])
    assert launch_counters()["embedding_bag"].n == 0  # CPU tensors take the plain version


@pytest.mark.parametrize("mode", ["sum", "mean"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_recsys_bag_lookup_casts_like_jax(mode, dtype):
    """``embedding.bag_lookup`` (the model-facing entry point) returns the
    bag in the requested dtype, bf16 by default, as the JAX package's."""
    (jt, ji, jw), (tt, ti, tw) = _bags(2048, 32, 64, 20, "float32", seed=3)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    want = jemb.bag_lookup(jt, ji, jw, mode=mode, dtype=jdt)
    got = temb.bag_lookup(tt, ti, tw, mode=mode, dtype=dtype)
    assert got.dtype == dtype
    _close(got, want, TOL["bfloat16" if dtype == torch.bfloat16 else "float32"])
    if dtype == torch.bfloat16:
        assert temb.bag_lookup(tt, ti, tw, mode=mode).dtype == torch.bfloat16


def test_lookup_and_table_init():
    (jt, ji, _), (tt, ti, _) = _bags(100, 8, 4, 3, "float32", seed=4)
    _close(temb.lookup(tt, ti.long()), jemb.lookup(jt, ji), 0.0)
    t = temb.table_init(torch.Generator().manual_seed(0), 4096, 32, device="cpu")
    assert t.shape == (4096, 32) and t.dtype == torch.float32
    assert abs(float(t.std()) - 0.05) < 0.002


def test_ids_past_the_end_clamp_like_the_jax_oracle():
    """Ids must lie in [0, V); one past the end reads the last row, as the
    JAX package's dense oracle does (the TPU kernel would drop it)."""
    (jt, ji, jw), (tt, ti, tw) = _bags(64, 8, 4, 5, "float32", seed=5)
    ji = ji.at[:, 0].set(64 + 7)
    ti = ti.clone()
    ti[:, 0] = 64 + 7
    _close(ops.bag_lookup(tt, ti, tw), jref.embedding_bag_ref(jt, ji, jw), 1e-4)


def _i(*shape, dtype=torch.int32):
    return torch.zeros(shape, dtype=dtype)


@pytest.mark.parametrize(
    "table,idx,w,err",
    [
        (_i(0, 4, dtype=torch.float32), _i(2, 3), None, ValueError),  # empty table
        (_i(8, 4, dtype=torch.float16), _i(2, 3), None, TypeError),
        (_i(8, 4, dtype=torch.float32), _i(2, 3, dtype=torch.int64), None, TypeError),
        (_i(8, 4, dtype=torch.float32), _i(6), None, ValueError),  # not [B, L]
        (_i(8, 4, dtype=torch.float32), _i(2, 3), _i(2, 4, dtype=torch.float32), ValueError),
        (_i(8, 4, dtype=torch.float32), _i(2, 3), _i(2, 3, dtype=torch.bfloat16), TypeError),
        (_i(4, 8, dtype=torch.float32).T, _i(2, 3), None, ValueError),  # not contiguous
    ],
)
def test_kernel_input_checks(table, idx, w, err):
    """What the CUDA wrapper refuses before a launch."""
    with pytest.raises(err):
        _check_inputs(table, idx, w)


def test_unknown_mode_raises():
    with pytest.raises(ValueError, match="mode"):
        embedding_bag(_i(8, 4, dtype=torch.float32), _i(2, 3), mode="max")
