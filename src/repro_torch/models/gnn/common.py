"""Shared GNN machinery: masked segment ops over edge lists + batch format.

Port of ``repro/models/gnn/common.py``.  Message passing is gather
(``x[edge_src]``) -> edge compute -> segment reduction back to the nodes: a
segment sum is ``index_add_`` into zeros, a segment max is
``scatter_reduce_(..., "amax")`` into ``-inf``, as ``core/analytics.py``
reduces.  All shapes static; padding controlled by masks.  The JAX
package's ``shard_ragged`` (a sharding constraint on the node/edge axis)
has no counterpart here: the port runs a model on one device.

Canonical batch (flat disjoint-union layout, works for single large graphs
and batched molecules alike):
    x          [N, F]   node features        node_mask  [N]
    pos        [N, 3]   (geometric models)   edge_mask  [E]
    edge_src   [E]      edge_dst [E]         edge_attr  [E, Fe] (optional)
    graph_id   [N]      graph membership for readout (zeros if one graph)
    labels     [N] or [G] target
"""
from __future__ import annotations

from typing import Optional

import torch

__all__ = [
    "masked_segment_sum",
    "masked_segment_mean",
    "masked_segment_max",
    "gather_src_dst",
    "graph_readout",
]


def _trail(mask: torch.Tensor, data: torch.Tensor) -> torch.Tensor:
    """``mask`` with a unit axis for each trailing axis of ``data``."""
    return mask.reshape(mask.shape + (1,) * (data.dim() - 1))


def _segment_sum(data: torch.Tensor, segment_ids: torch.Tensor, num_segments: int) -> torch.Tensor:
    out = data.new_zeros((num_segments,) + tuple(data.shape[1:]))
    return out.index_add_(0, segment_ids, data)


def masked_segment_sum(
    data: torch.Tensor, segment_ids: torch.Tensor, num_segments: int,
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    if mask is not None:
        data = torch.where(_trail(mask, data), data, data.new_zeros(()))
    return _segment_sum(data, segment_ids, num_segments)


def masked_segment_mean(
    data: torch.Tensor, segment_ids: torch.Tensor, num_segments: int,
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    s = masked_segment_sum(data, segment_ids, num_segments, mask)
    ones = (data.new_ones(data.shape[0]) if mask is None else mask.to(data.dtype))
    cnt = _segment_sum(ones, segment_ids, num_segments)
    return s / _trail(cnt.clamp_min(1.0), data)


def masked_segment_max(
    data: torch.Tensor, segment_ids: torch.Tensor, num_segments: int,
    mask: Optional[torch.Tensor] = None, neg: float = -1e30,
) -> torch.Tensor:
    if mask is not None:
        data = torch.where(_trail(mask, data), data, data.new_full((), neg))
    out = data.new_full((num_segments,) + tuple(data.shape[1:]), float("-inf"))
    idx = _trail(segment_ids.long(), data).expand_as(data)
    out = out.scatter_reduce_(0, idx, data, "amax", include_self=True)
    return out.clamp_min(neg)  # empty segments -> neg floor


def gather_src_dst(x: torch.Tensor, src: torch.Tensor, dst: torch.Tensor):
    return x[src], x[dst]


def graph_readout(
    h: torch.Tensor,  # [N, F]
    graph_id: torch.Tensor,  # [N]
    n_graphs: int,
    node_mask: Optional[torch.Tensor] = None,
    mode: str = "sum",
) -> torch.Tensor:
    if mode == "sum":
        return masked_segment_sum(h, graph_id, n_graphs, node_mask)
    if mode == "mean":
        return masked_segment_mean(h, graph_id, n_graphs, node_mask)
    raise ValueError(mode)
