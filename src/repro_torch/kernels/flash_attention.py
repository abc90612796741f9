"""Blocked online-softmax attention (forward): CUDA kernels for Hopper.

:func:`flash_attention` replaces ``_attn_kernel`` of the JAX package's
``kernels/flash_attention.py`` (Pallas, TPU): causal and sliding-window
masks, GQA (q head ``h`` reads kv head ``h // group``), query positions
suffix-aligned when ``Sq < Skv``, scale ``Dqk ** -0.5``, f32 running max,
denominator and numerator, output in q's dtype.  The kernels live in
``csrc/flash_attention.cu``; the wrapper dispatches on dtype, one kernel
each:

- **bf16** (the model path): a tensor-core kernel.  One warpgroup per
  (batch, q head, 64-row q tile), q tiles with the longest causal walk
  first; ``S = Q K^T`` and ``O += P V`` by ``wgmma`` m64n64k16 with f32
  accumulators (P in registers as the A operand, split into two bf16
  terms so it keeps about 16 bits; V an MN-major B); K/V
  tiles of 64 rows arrive by ``cp.async`` into a 2-stage ring in the
  128-byte swizzle.  Widths are zero-filled in shared memory up to the
  instance :func:`bf16_instance` picks.  ``cp.async`` copies 16-byte
  pieces, so the bases and the (b, h, s) strides of q, k and v must be
  multiples of 8 elements: :func:`_check_inputs` raises on other views.
- **f32**: the CUDA-core kernel (f32 products, each warp's rows
  accumulated in registers), which takes any stride.

Both mask ragged ``Sq`` and ``Skv``, so every shape launches.  They follow
the dense reference ``ref.attention_ref`` where the TPU kernel does not:

- ``v`` may be narrower than ``q``/``k`` (MLA attends with q.k width 192 and
  v width 128); the output is ``[B, Hq, Sq, Dv]``.  The TPU kernel takes one
  width from ``q`` for ``v``'s block and its output, so on MLA it reads past
  ``v``.
- A fully masked query row (a causal ``Sq > Skv``) gives 0; the TPU kernel
  averages ``v`` there.

Bound on an H100: ``max(flops / 989 TFLOP/s, bytes / 3.35 TB/s)`` with
``2 * B * Hq * (unmasked q.k pairs) * (Dqk + Dv)`` flops and q, k, v read and
the output written once; at an MLA prefill of 605 tokens (16 heads) that is
1.88 GFLOP against 12.4 MB in bf16, so bytes bound it (3.7 us).

For tensors on the CPU the wrapper takes the plain version
(:func:`repro_torch.kernels.ref.attention_ref`); for CUDA tensors it launches
the kernel or raises.
"""
from __future__ import annotations

from typing import Optional

import torch

from . import ref
from .cuda_lib import check, library, register_counter, stream_ptr

__all__ = ["BF16_DV_WIDTHS", "LAUNCHES", "MAX_HEAD_DIM", "bf16_instance", "flash_attention"]

LAUNCHES = register_counter("flash_attention")
MAX_HEAD_DIM = 256  # widest q.k or v head the kernels take
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
BF16_DV_WIDTHS = (64, 128, 256)  # the bf16 kernel's compiled v widths
_QK_CHUNK = 64  # the bf16 kernel runs q.k in chunks of 64 columns
_ALIGN = 8  # cp.async copies 16 bytes: 8 bf16 elements


def bf16_instance(dqk: int, dv: int) -> tuple:
    """``(q.k width, v width)`` the bf16 kernel computes at for these head
    widths: q.k rounded up to a multiple of 64 (a count of chunks the kernel
    takes at run time), v to the smallest compiled width that holds it; the
    columns in between are zero-filled in shared memory."""
    if not (1 <= dqk <= MAX_HEAD_DIM and 1 <= dv <= MAX_HEAD_DIM):
        raise ValueError(f"head widths must be in [1, {MAX_HEAD_DIM}], got {dqk}, {dv}")
    qk = -(-dqk // _QK_CHUNK) * _QK_CHUNK
    return qk, next(w for w in BF16_DV_WIDTHS if w >= dv)


def _check_inputs(q, k, v) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k, v must be [B, H, S, D]")
    B, Hq, _, dqk = q.shape
    _, Hkv, Skv, _ = k.shape
    if k.shape[0] != B or tuple(v.shape[:3]) != (B, Hkv, Skv) or k.shape[3] != dqk:
        raise ValueError(
            f"shapes do not agree: q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}"
        )
    if Hkv == 0 or Hq % Hkv != 0:
        raise ValueError(f"GQA needs Hq % Hkv == 0, got Hq={Hq}, Hkv={Hkv}")
    if not (1 <= dqk <= MAX_HEAD_DIM and 1 <= v.shape[3] <= MAX_HEAD_DIM):
        raise ValueError(f"head widths must be in [1, {MAX_HEAD_DIM}]")
    if q.dtype not in _DTYPES:
        raise TypeError(f"q must be float32 or bfloat16, got {q.dtype}")
    for name, t in (("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.dtype != q.dtype:
            raise TypeError(f"{name} must be {q.dtype}, got {t.dtype}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.shape[3] > 1 and t.stride(3) != 1:
            raise ValueError(f"{name} needs unit stride on its last axis")
        if t.dtype == torch.bfloat16:
            moving = [st for n, st in zip(t.shape[:3], t.stride()[:3]) if n > 1]
            if t.data_ptr() % (2 * _ALIGN) or any(st % _ALIGN for st in moving):
                raise ValueError(
                    f"{name}: the bf16 kernel copies rows in 16-byte pieces, so its base "
                    f"and its (b, h, s) strides must be multiples of {_ALIGN} elements; "
                    f"got strides {tuple(t.stride())} at byte offset "
                    f"{t.data_ptr() % (2 * _ALIGN)} (copy it into an aligned buffer)"
                )


def flash_attention(
    q: torch.Tensor,  # [B, Hq, Sq, Dqk]
    k: torch.Tensor,  # [B, Hkv, Skv, Dqk]
    v: torch.Tensor,  # [B, Hkv, Skv, Dv]
    causal: bool = True,
    window: Optional[int] = None,
) -> torch.Tensor:
    """Attention forward, ``[B, Hq, Sq, Dv]`` in q's dtype; same contract
    as ``ref.attention_ref``.  q, k and v may be strided views (MLA's v is a
    transpose) as long as their last axis is contiguous, and in bf16 their
    rows 16-byte aligned."""
    if q.device.type == "cpu":
        return ref.attention_ref(q, k, v, causal=causal, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cpu or cuda, not {q.device}")
    _check_inputs(q, k, v)
    B, Hq, Sq, dqk = q.shape
    _, Hkv, Skv, _ = k.shape
    dv = v.shape[3]
    out = torch.empty((B, Hq, Sq, dv), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    lib = library().get()
    with torch.cuda.device(q.device):
        check(
            lib.flash_attention_fwd(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                B, Hq, Hkv, Sq, Skv, dqk, dv,
                *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                float(dqk ** -0.5), int(causal), int(window is not None),
                int(window or 0), _DTYPES[q.dtype], stream_ptr(q.device),
            ),
            "flash_attention_fwd",
        )
        LAUNCHES.bump()
    return out
