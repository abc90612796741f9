"""The port's attention (flash-kernel wrapper, dispatch, plain version and
chunked path) against the JAX package on the same seeded inputs.

The JAX side runs as its own tests run it on the CPU: the Pallas kernel in
interpret mode and the dense oracle ``attention_ref``.  Tolerances are the
reference's own (``tests/test_kernels.py``): 2e-5 in f32, 2e-2 in bf16.
"""
import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention as jax_flash
from repro.models.attention import chunked_attention as jax_chunked
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref
from repro_torch.kernels.cuda_lib import launch_counters, reset_launch_counters
from repro_torch.kernels.flash_attention import (
    BF16_DV_WIDTHS,
    MAX_HEAD_DIM,
    _check_inputs,
    bf16_instance,
    flash_attention,
)
from repro_torch.models.attention import chunked_attention

# the reference's ATTN_SWEEP (tests/test_kernels.py)
ATTN_SWEEP = [
    # b, hq, hkv, sq, skv, d, causal, window, dtype
    (2, 4, 2, 128, 128, 64, True, None, "float32"),
    (1, 8, 8, 256, 256, 32, False, None, "float32"),
    (1, 4, 1, 128, 512, 64, True, 64, "float32"),
    (2, 4, 2, 8, 256, 64, True, None, "float32"),
    (1, 2, 2, 64, 64, 128, True, None, "bfloat16"),
]
# lengths no 64-row tile divides; one kernel block covers each on the JAX side
RAGGED = [
    # b, hq, hkv, sq, skv, d, causal, window, dtype
    (1, 4, 2, 100, 100, 32, True, None, "float32"),
    (2, 2, 1, 37, 130, 48, True, None, "float32"),
    (1, 3, 3, 77, 77, 64, False, None, "float32"),
    (1, 4, 4, 90, 150, 32, True, 40, "float32"),
    (1, 2, 2, 70, 70, 64, True, None, "bfloat16"),
]
TOL = {"float32": 2e-5, "bfloat16": 2e-2}


def _qkv(b, hq, hkv, sq, skv, dqk, dv, dtype, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, hq, sq, dqk)).astype(np.float32)
    k = rng.standard_normal((b, hkv, skv, dqk)).astype(np.float32)
    v = rng.standard_normal((b, hkv, skv, dv)).astype(np.float32)
    jx = tuple(jnp.asarray(x, getattr(jnp, dtype)) for x in (q, k, v))
    tx = tuple(torch.from_numpy(x).to(getattr(torch, dtype)) for x in (q, k, v))
    return jx, tx


def _np(x):
    return np.asarray(x.float().numpy() if isinstance(x, torch.Tensor) else x, np.float32)


def _close(got, want, tol):
    np.testing.assert_allclose(_np(got), _np(want), atol=tol, rtol=tol)


@pytest.mark.parametrize("case", ATTN_SWEEP + RAGGED, ids=str)
def test_attention_matches_jax_kernel_and_ref(case):
    b, hq, hkv, sq, skv, d, causal, window, dtype = case
    (jq, jk, jv), (tq, tk, tv) = _qkv(b, hq, hkv, sq, skv, d, d, dtype)
    ragged = sq % 64 or skv % 64
    blocks = dict(block_q=sq, block_kv=skv) if ragged else dict(block_q=64, block_kv=64)
    want_kernel = jax_flash(jq, jk, jv, causal=causal, window=window, interpret=True, **blocks)
    want_ref = jref.attention_ref(jq, jk, jv, causal=causal, window=window)
    tol = TOL[dtype]
    reset_launch_counters()
    for got in (
        ops.attention(tq, tk, tv, causal=causal, window=window),
        tref.attention_ref(tq, tk, tv, causal=causal, window=window),
        flash_attention(tq, tk, tv, causal=causal, window=window),
    ):
        assert got.dtype == tq.dtype and tuple(got.shape) == (b, hq, sq, d)
        _close(got, want_kernel, tol)
        _close(got, want_ref, tol)
    assert launch_counters()["flash_attention"].n == 0  # CPU tensors take the plain version


def test_mla_widths_follow_attention_ref_not_the_tpu_kernel():
    """q.k width 24, v width 16 (MLA's 192/128 in small): the port returns
    [B, H, S, Dv] equal to ``attention_ref``.  The TPU kernel takes its
    output width from q and reads past v; its first Dv columns are right."""
    (jq, jk, jv), (tq, tk, tv) = _qkv(1, 4, 4, 8, 8, 24, 16, "float32", seed=3)
    want = jref.attention_ref(jq, jk, jv, causal=True)
    got = ops.attention(tq, tk, tv, causal=True)
    assert tuple(got.shape) == (1, 4, 8, 16) and tuple(want.shape) == (1, 4, 8, 16)
    _close(got, want, 2e-5)
    tpu = jax_flash(jq, jk, jv, causal=True, block_q=8, block_kv=8, interpret=True)
    assert tuple(tpu.shape) == (1, 4, 8, 24)
    _close(got, np.asarray(tpu)[..., :16], 2e-5)


def test_fully_masked_rows_give_zero():
    """Causal with Sq > Skv: the first Sq - Skv query rows see no key.
    ``attention_ref`` and the port give 0 there; the TPU kernel averages v
    (every masked score is -1e30, so every weight is exp(0)).  The other
    rows agree."""
    (jq, jk, jv), (tq, tk, tv) = _qkv(1, 2, 2, 12, 4, 16, 16, "float32", seed=5)
    got = ops.attention(tq, tk, tv, causal=True)
    want = jref.attention_ref(jq, jk, jv, causal=True)
    _close(got, want, 2e-5)
    assert not got[:, :, :8].any()
    tpu = np.asarray(jax_flash(jq, jk, jv, causal=True, block_q=12, block_kv=4,
                               interpret=True))
    mean_v = np.asarray(jv).mean(axis=2, keepdims=True)
    np.testing.assert_allclose(tpu[:, :, :8], np.broadcast_to(mean_v, tpu[:, :, :8].shape),
                               atol=2e-5, rtol=2e-5)
    _close(got[:, :, 8:], tpu[:, :, 8:], 2e-5)


@pytest.mark.parametrize(
    "shape,causal,chunk_kv,chunk_q",
    [
        ((1, 4, 2, 256, 256, 32), True, 64, 128),  # the reference's own case
        ((2, 4, 4, 96, 200, 24), True, 64, 2048),  # kv padded to the chunk
        ((1, 2, 1, 40, 40, 16), False, 16, 2048),
    ],
)
def test_chunked_attention_matches_jax(shape, causal, chunk_kv, chunk_q):
    b, hq, hkv, sq, skv, d = shape
    (jq, jk, jv), (tq, tk, tv) = _qkv(b, hq, hkv, sq, skv, d, d, "float32", seed=4)
    want = jax_chunked(jq, jk, jv, causal=causal, chunk_kv=chunk_kv, chunk_q=chunk_q)
    got = chunked_attention(tq, tk, tv, causal=causal, chunk_kv=chunk_kv, chunk_q=chunk_q)
    _close(got, want, 2e-5)
    _close(got, jref.attention_ref(jq, jk, jv, causal=causal), 2e-5)


@pytest.mark.parametrize("dv", [24, 16])
def test_chunked_attention_kv_valid_matches_jax(dv):
    """Decode's path: one query per row against a cache valid up to
    ``kv_valid`` (per batch row), v narrower than q.k as in MLA."""
    (jq, jk, jv), (tq, tk, tv) = _qkv(3, 4, 4, 1, 300, 24, dv, "float32", seed=8)
    valid = np.array([1, 37, 300], np.int32)
    want = jax_chunked(jq, jk, jv, causal=False, chunk_kv=128, kv_valid=jnp.asarray(valid))
    got = chunked_attention(tq, tk, tv, causal=False, chunk_kv=128,
                            kv_valid=torch.from_numpy(valid))
    _close(got, want, 2e-5)
    for r, n in enumerate(valid):  # row r attends to its first n keys only
        _close(got[r:r + 1], tref.attention_ref(tq[r:r + 1], tk[r:r + 1, :, :n],
                                                tv[r:r + 1, :, :n], causal=False), 2e-5)


def _t(*shape, dtype=torch.float32):
    return torch.zeros(shape, dtype=dtype)


@pytest.mark.parametrize(
    "q,k,v,err",
    [
        (_t(1, 2, 4, 8), _t(1, 2, 4, 8), _t(1, 2, 5, 8), ValueError),  # Skv differs
        (_t(1, 3, 4, 8), _t(1, 2, 4, 8), _t(1, 2, 4, 8), ValueError),  # Hq % Hkv
        (_t(1, 2, 4, 8), _t(1, 2, 4, 9), _t(1, 2, 4, 8), ValueError),  # Dqk differs
        (_t(1, 2, 4, 300), _t(1, 2, 4, 300), _t(1, 2, 4, 8), ValueError),  # too wide
        (_t(1, 2, 4, 8, dtype=torch.float16),) * 3 + (TypeError,),
        (_t(1, 2, 4, 8), _t(1, 2, 4, 8, dtype=torch.bfloat16), _t(1, 2, 4, 8), TypeError),
        (_t(1, 2, 4, 8), _t(1, 2, 8, 4).transpose(2, 3), _t(1, 2, 4, 8), ValueError),
        (_t(2, 4, 8), _t(2, 4, 8), _t(2, 4, 8), ValueError),  # not 4-D
    ],
)
def test_kernel_input_checks(q, k, v, err):
    """What the CUDA wrapper refuses before a launch."""
    with pytest.raises(err):
        _check_inputs(q, k, v)


def test_kernel_input_checks_accept_a_transposed_v():
    """MLA's v is a transpose of the up-projection: strided, last axis unit."""
    v = _t(1, 8, 2, 16).transpose(1, 2)
    _check_inputs(_t(1, 2, 8, 24), _t(1, 2, 8, 24), v)
    np.testing.assert_array_equal(
        tref.attention_ref(_t(1, 2, 8, 24), _t(1, 2, 8, 24), v).shape, (1, 2, 8, 16)
    )


def test_kernel_input_checks_accept_a_transposed_v_in_bf16():
    """The bf16 kernel copies rows in 16-byte pieces; MLA's transposed v
    (strides multiples of 8 elements) qualifies as it is."""
    bf = torch.bfloat16
    v = _t(1, 8, 2, 128, dtype=bf).transpose(1, 2)
    _check_inputs(_t(1, 2, 8, 192, dtype=bf), _t(1, 2, 8, 192, dtype=bf), v)


def _aligned_buffer(n, dtype=torch.bfloat16):
    return torch.zeros(n, dtype=dtype)


@pytest.mark.parametrize(
    "which,view",
    [
        ("q", lambda: _t(1, 2, 8, 25, dtype=torch.bfloat16)[..., :24]),  # row stride 25
        ("k", lambda: _t(1, 2, 8, 25, dtype=torch.bfloat16)[..., :24]),
        ("v", lambda: _t(1, 2, 8, 25, dtype=torch.bfloat16)[..., :24]),
        ("q", lambda: _aligned_buffer(1000)[1:385].view(1, 2, 8, 24)),  # base 2 bytes off
        ("v", lambda: _aligned_buffer(1000).as_strided((1, 2, 8, 24), (0, 196, 24, 1))),
        ("k", lambda: _aligned_buffer(2000).as_strided((2, 2, 8, 24), (390, 192, 24, 1))),
    ],
    ids=["q row stride", "k row stride", "v row stride", "q base", "v head stride",
         "k batch stride"],
)
def test_kernel_input_checks_refuse_misaligned_bf16_views(which, view):
    """What cp.async cannot copy in 16-byte pieces is refused before a
    launch, with a message; it is never copied or sent to the plain version."""
    bf = torch.bfloat16
    args = {"q": _t(1, 2, 8, 24, dtype=bf), "k": _t(1, 2, 8, 24, dtype=bf),
            "v": _t(1, 2, 8, 24, dtype=bf)}
    t = view()
    if t.shape[0] != 1:
        args = {n: x.expand(2, -1, -1, -1) if n != which else x for n, x in args.items()}
    args[which] = t
    with pytest.raises(ValueError, match="16-byte pieces"):
        _check_inputs(args["q"], args["k"], args["v"])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_input_checks_ignore_strides_of_length_one_axes(dtype):
    """An axis of length 1 never moves the copy, so its stride may be
    anything; in f32 (the CUDA-core kernel) any stride is taken."""
    buf = _aligned_buffer(4000, dtype)
    q = buf.as_strided((1, 1, 8, 24), (7, 5, 24, 1))
    _check_inputs(q, q, q)
    if dtype == torch.float32:
        odd = _t(1, 2, 8, 25)[..., :24]
        _check_inputs(odd, odd, odd)


def _compiled_dv_widths():
    src = pathlib.Path(__file__).resolve().parents[1] / "src/repro_torch/csrc/flash_attention.cu"
    return sorted(int(w) for w in re.findall(r"^\s*FA_WG_CASE\((\d+)\)", src.read_text(), re.M))


def test_bf16_instances_are_the_ones_the_source_compiles():
    assert _compiled_dv_widths() == sorted(BF16_DV_WIDTHS)


@pytest.mark.parametrize("dv", range(1, MAX_HEAD_DIM + 1, 17))
def test_bf16_instance_holds_every_width(dv):
    """Every (Dqk, Dv) in 1..256 maps to an instance the C side compiles:
    q.k to the next multiple of 64 (a run-time chunk count, at most 4), v
    to the smallest compiled width that holds it."""
    widths = _compiled_dv_widths()
    for dv_ in range(dv, min(dv + 17, MAX_HEAD_DIM + 1)):
        for dqk in range(1, MAX_HEAD_DIM + 1):
            qk, dv_pad = bf16_instance(dqk, dv_)
            assert qk % 64 == 0 and dqk <= qk < dqk + 64 and qk <= MAX_HEAD_DIM
            assert dv_pad in widths and dv_pad >= dv_
            assert all(w < dv_ for w in widths if w < dv_pad)


@pytest.mark.parametrize("dqk,dv", [(0, 8), (8, 0), (257, 8), (8, 257)])
def test_bf16_instance_refuses_widths_out_of_range(dqk, dv):
    with pytest.raises(ValueError):
        bf16_instance(dqk, dv)
