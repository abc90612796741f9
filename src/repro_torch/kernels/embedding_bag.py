"""Weighted EmbeddingBag (gather + per-bag reduce): CUDA kernel for Hopper.

:func:`embedding_bag` replaces ``_bag_kernel`` of the JAX package's
``kernels/embedding_bag.py`` (Pallas, TPU): ``out[b] = sum_l w[b, l] *
table[idx[b, l]]``, divided by ``max(sum_l w[b, l], 1e-9)`` in ``"mean"``
mode, with ``weights=None`` meaning ones; f32 sums, output in the table's
dtype.  The TPU kernel tiles the vocabulary through VMEM (a TPU has no fast
data-dependent HBM gather); the kernel in ``csrc/embedding_bag.cu`` gathers
directly, one warp per bag: the bag's ids and weights are read once,
coalesced, and each row is fetched by a group of lanes with 16-byte loads,
a chunk's rows loaded before the first FMA, 64 bags a SM resident
(:func:`instance` names the instance that runs).

Ids must lie in ``[0, V)``.  The kernel and the plain version clamp an id
past the end to the last row, as the JAX package's dense reference does, and
a negative id to row 0 (that reference wraps it); the TPU kernel drops
either with its weight.  Callers keep ids in range.

Bound on an H100: bytes.  Each distinct row gathered once plus ids, weights
and output, over 3.35 TB/s.  Rows that several bags share (Zipf ids) are
gathered again from L2, whose gather rate then sets the time.

For tensors on the CPU the wrapper takes the plain version
(:func:`repro_torch.kernels.ref.embedding_bag_ref`); for CUDA tensors it
launches the kernel or raises.
"""
from __future__ import annotations

from typing import Optional

import torch

from . import ref
from .cuda_lib import check, library, register_counter, stream_ptr

__all__ = ["LAUNCHES", "embedding_bag", "instance"]

LAUNCHES = register_counter("embedding_bag")
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MODES = ("sum", "mean")
_WARP = 32
_IN_FLIGHT = 8  # rows a lane has in flight at most


def instance(table: torch.Tensor, indices: torch.Tensor) -> tuple:
    """``(dtype, bytes a load, lanes a row, rows a lane has in flight)`` of
    the kernel that runs for ``table`` [V, D] and ``indices`` [B, L].

    16-byte loads where a row is a whole number of 16-byte pieces and the
    table's base is 16-byte aligned (the wrapper's output always is), one
    element a load otherwise.  A row's loads go to the smallest power of two
    of lanes that holds them, at most 32 (a wider row takes several passes);
    the warp's other lanes fetch other rows of the bag, each lane up to 8 at
    once."""
    if table.dtype not in _DTYPES:
        raise TypeError(f"table must be float32 or bfloat16, got {table.dtype}")
    esize = table.element_size()
    D, L = table.shape[1], indices.shape[1]
    vec = (D * esize) % 16 == 0 and table.data_ptr() % 16 == 0
    load = 16 if vec else esize
    chunks = D * esize // load
    lanes = min(1 << max(chunks - 1, 0).bit_length(), _WARP)
    groups = _WARP // lanes
    rows = min(lanes, _IN_FLIGHT, -(-min(L, _WARP) // groups))
    return str(table.dtype).removeprefix("torch."), load, lanes, rows


def _check_inputs(table, indices, weights) -> None:
    if table.dim() != 2 or table.shape[0] == 0:
        raise ValueError(f"table must be [V > 0, D], got {tuple(table.shape)}")
    if table.dtype not in _DTYPES:
        raise TypeError(f"table must be float32 or bfloat16, got {table.dtype}")
    if indices.dim() != 2:
        raise ValueError(f"indices must be [B, L], got {tuple(indices.shape)}")
    if indices.dtype != torch.int32:
        raise TypeError(f"indices must be int32, got {indices.dtype}")
    checks = [("table", table), ("indices", indices)]
    if weights is not None:
        if weights.shape != indices.shape:
            raise ValueError(
                f"weights must be {tuple(indices.shape)}, got {tuple(weights.shape)}"
            )
        if weights.dtype != torch.float32:
            raise TypeError(f"weights must be float32, got {weights.dtype}")
        checks.append(("weights", weights))
    for name, t in checks:
        if t.device != table.device:
            raise ValueError(f"{name} is on {t.device}, table on {table.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def embedding_bag(
    table: torch.Tensor,  # [V, D] f32 or bf16
    indices: torch.Tensor,  # [B, L] int32 in [0, V)
    weights: Optional[torch.Tensor] = None,  # [B, L] f32
    mode: str = "sum",
) -> torch.Tensor:
    """``[B, D]`` bag sums (or weighted means) in the table's dtype; same
    contract as ``ref.embedding_bag_ref``."""
    if mode not in _MODES:
        raise ValueError(f"mode must be one of {_MODES}, got {mode!r}")
    if table.device.type == "cpu":
        return ref.embedding_bag_ref(table, indices, weights, mode=mode)
    if table.device.type != "cuda":
        raise ValueError(f"embedding_bag runs on cpu or cuda, not {table.device}")
    _check_inputs(table, indices, weights)
    V, D = table.shape
    B, L = indices.shape
    out = torch.empty((B, D), dtype=table.dtype, device=table.device)
    if B == 0:
        return out
    lib = library().get()
    with torch.cuda.device(table.device):
        check(
            lib.embedding_bag_fwd(
                table.data_ptr(), indices.data_ptr(),
                None if weights is None else weights.data_ptr(), out.data_ptr(),
                B, L, V, D, int(mode == "mean"), _DTYPES[table.dtype],
                stream_ptr(table.device),
            ),
            "embedding_bag_fwd",
        )
        LAUNCHES.bump()
    return out
