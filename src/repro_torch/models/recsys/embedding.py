"""Sparse embedding substrate for recsys: big tables + bag lookups.

Port of ``repro/models/recsys/embedding.py``.  Lookups are row gathers;
bag reduces go through ``kernels.ops.bag_lookup`` (the CUDA embedding-bag
kernel on the card, its plain version on the CPU).
"""
from __future__ import annotations

from typing import Optional

import torch

from ...device import DeviceLike
from ...kernels import ops
from ..layers import normal, vocab_lookup

__all__ = ["bag_lookup", "lookup", "table_init"]


def table_init(
    generator: torch.Generator, vocab: int, dim: int, scale: float = 0.05,
    device: DeviceLike = None,
) -> torch.Tensor:
    """``[vocab, dim]`` f32 table, ``normal * scale``, drawn on ``device``."""
    return normal(generator, (vocab, dim), scale, device)


def lookup(
    table: torch.Tensor, ids: torch.Tensor, dtype: torch.dtype = torch.bfloat16
) -> torch.Tensor:
    """Plain row gather (single-id fields), cast to ``dtype`` after the
    gather (the JAX package casts the table first: the same values, without
    a copy of the whole table a call); vocab-parallel on a DTensor table."""
    return vocab_lookup(table, ids).to(dtype)


def bag_lookup(
    table: torch.Tensor,
    ids: torch.Tensor,  # [B, L] multi-hot bags, ids in [0, V)
    weights: Optional[torch.Tensor] = None,
    mode: str = "sum",
    dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    """EmbeddingBag via the kernel dispatcher, cast to ``dtype``."""
    return ops.bag_lookup(table, ids, weights, mode=mode).to(dtype)
