"""Gradient and payload compression: int8 and top-k, with error feedback.

Two standard schemes, both with error feedback (residual carried in the
compression state so the bias vanishes over steps):

  * ``int8``  — per-tensor symmetric quantization: 1 byte per element plus
                one f32 scale on the wire.
  * ``topk``  — magnitude top-k sparsification (indices+values), k as a
                fraction of the tensor; the dense residual is fed back.

Tensor functions over ``torch.Tensor`` on any device; a compression state
is a dict of tensors in place of a pytree.  The sharded store's migration
transfers use the int8 pair (:func:`repro_torch.distributed.collectives.
transfer_rows`).  :func:`compressed_psum` composes quantize -> all-reduce ->
dequantize over one mesh axis (the pod axis), on each rank's local
gradients, where the JAX package runs it inside ``shard_map``.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

__all__ = [
    "init_compression_state",
    "compress_int8",
    "decompress_int8",
    "compress_topk",
    "apply_error_feedback",
    "compressed_psum",
]


def init_compression_state(grads: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Per-entry error-feedback residual (f32 zeros of each tensor's shape,
    on its device)."""
    return {
        k: torch.zeros(g.shape, dtype=torch.float32, device=g.device)
        for k, g in grads.items()
    }


# ------------------------------------------------------------------ int8
def compress_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(q int8, scale)`` with ``scale = max(max|x|, 1e-12) / 127`` (a
    scalar in x's dtype) and ``q = clip(round(x / scale), -127, 127)``.  The
    division is a true division, not a product with the reciprocal, and
    ``round`` goes half to even, as in the JAX package, so ``q`` and
    ``scale`` are bit-equal to its."""
    floor = torch.tensor(1e-12, dtype=x.dtype, device=x.device)
    scale = torch.maximum(x.abs().max(), floor) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def decompress_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


# ------------------------------------------------------------------ top-k
def compress_topk(x: torch.Tensor, frac: float = 0.05) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (dense sparsified tensor, kept mask).  Dense layout keeps the
    reduction's shape static; the WAN saving is modeled by the mask ratio."""
    flat = x.reshape(-1)
    k = max(1, int(frac * flat.shape[0]))
    thresh = torch.topk(flat.abs(), k).values[-1]
    mask = x.abs() >= thresh
    return torch.where(mask, x, torch.zeros_like(x)), mask


def apply_error_feedback(
    g: torch.Tensor, residual: torch.Tensor, method: str = "int8", topk_frac: float = 0.05
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(compressed-then-decompressed gradient, new residual)."""
    x = g.to(torch.float32) + residual
    if method == "int8":
        q, s = compress_int8(x)
        out = decompress_int8(q, s)
    elif method == "topk":
        out, _ = compress_topk(x, topk_frac)
    else:
        raise ValueError(method)
    return out.to(g.dtype), x - out


# ------------------------------------------------------- mesh-axis reduction
def compressed_psum(
    grads: Dict[str, torch.Tensor],
    residuals: Dict[str, torch.Tensor],
    mesh,
    axis: str = "pod",
    method: str = "int8",
    topk_frac: float = 0.05,
) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """Per entry: error-feedback compress, all-reduce over ``axis`` of
    ``mesh``, average.  Returns (averaged decompressed grads, new
    residuals).  ``int8`` re-quantizes so the wire payload is int8, sums the
    quantized values in int32 and the scales in f32, and takes
    ``qsum * (ssum / n) / n`` (the mean scale stands in for each rank's,
    the reference's arithmetic); ``topk`` is an f32 sum over ``n``."""
    from .collectives import _all_reduce

    group = mesh.get_group(axis)
    n = mesh.size(mesh.mesh_dim_names.index(axis))
    outs, new_res = {}, {}
    for k, g in grads.items():
        c, new_res[k] = apply_error_feedback(g, residuals[k], method, topk_frac)
        if method == "int8":
            q, s = compress_int8(c.to(torch.float32))
            qsum = _all_reduce(q.to(torch.int32), "sum", group)
            ssum = _all_reduce(s.reshape(1), "sum", group)[0]
            out = qsum.to(torch.float32) * (ssum / n) / n
        else:
            out = _all_reduce(c.to(torch.float32), "sum", group) / n
        outs[k] = out.to(g.dtype)
    return outs, new_res
