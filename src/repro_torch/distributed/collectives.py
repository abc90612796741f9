"""The explicit device-to-device transfer the sharded store's migration
waves and the GNN halo exchange (``halo_exec.py``) run through.

The collectives of the JAX package's module (``pmean_tree``,
``all_to_all_tokens``) run inside ``shard_map`` for training and are not
part of this module.
"""
from __future__ import annotations

from typing import Optional, Tuple, Union

import numpy as np
import torch

from .compression import compress_int8, decompress_int8

__all__ = ["transfer_rows"]


def transfer_rows(
    payload: torch.Tensor,
    rows: Union[np.ndarray, torch.Tensor],
    dst_device,
    compress: Optional[str] = None,
) -> Tuple[torch.Tensor, float]:
    """Ship ``payload[rows]`` to ``dst_device`` as an explicit
    device-to-device copy; returns ``(block on dst, wire bytes)``.
    ``rows`` may be a tensor already on the source device (no upload).

    The gather runs on the source device (where ``payload`` lives); only the
    gathered block crosses the link.  ``compress="int8"`` quantizes the block
    per-tensor symmetric before the hop and dequantizes on the destination —
    the wire then carries 1 byte/element plus the fp32 scale.
    """
    if compress not in (None, "int8"):
        raise ValueError(f"unknown compression {compress!r} (None or 'int8')")
    if isinstance(rows, torch.Tensor):
        idx = rows.to(payload.device, torch.int64)
    else:
        idx = torch.as_tensor(np.asarray(rows, dtype=np.int64), device=payload.device)
    block = payload.index_select(0, idx)
    if compress is None:
        out = block.to(dst_device)
        wire = out.numel() * out.element_size()
    else:
        q, scale = compress_int8(block)
        q = q.to(dst_device)
        scale = scale.to(dst_device)
        out = decompress_int8(q, scale)
        wire = q.numel() * q.element_size() + scale.numel() * 4
    return out, float(wire)
