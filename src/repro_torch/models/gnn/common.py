"""Shared GNN machinery: masked segment ops over edge lists + batch format.

Port of ``repro/models/gnn/common.py``.  Message passing is gather
(``x[edge_src]``) -> edge compute -> segment reduction back to the nodes: a
segment sum is ``index_add_`` into zeros, a segment max is
``scatter_reduce_(..., "amax")`` into ``-inf``, as ``core/analytics.py``
reduces.  All shapes static; padding controlled by masks.

On DTensors (a mesh in use) :func:`shard_ragged` pins the node/edge axis
over the whole mesh, as the JAX package's does, and each segment
reduction is a ``local_map`` region (DTensor has no sharding rule for
``index_add_`` or ``scatter_reduce_``): each rank reduces its edge slice
into all ``num_segments`` rows, a partial sum over the mesh that the next
``shard_ragged`` reduce-scatters; a max is all-reduced inside the region,
whose backward gives the gradient to the ranks that hold the maximum.

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

from ...distributed.constraints import constrain, is_dtensor
from ..layers import take_rows

__all__ = [
    "shard_ragged",
    "masked_segment_sum",
    "masked_segment_mean",
    "masked_segment_max",
    "gather_src_dst",
    "graph_readout",
]


def _trail(mask: torch.Tensor, data: torch.Tensor) -> torch.Tensor:
    """``mask`` with a unit axis for each trailing axis of ``data``."""
    return mask.reshape(mask.shape + (1,) * (data.dim() - 1))


_ALL = ("pod", "data", "model")


def shard_ragged(x: torch.Tensor) -> torch.Tensor:
    """Pin the leading (node/edge) axis to the full mesh; a no-op without
    one."""
    return constrain(x, _ALL, *([None] * (x.dim() - 1)))


def _segment_region(fn, reduce_op: str, data: torch.Tensor, segment_ids: torch.Tensor,
                    num_segments: int) -> torch.Tensor:
    """``fn(data, segment_ids)`` (a reduction of ``[E, ...]`` rows into
    ``num_segments`` rows) on DTensors as a ``local_map`` region: the rows
    split over every mesh dim that splits ``data``'s first axis.  A sum
    leaves a ``Partial`` over those dims; a max is all-reduced over them
    in the region (``all_reduce_region``), its result replicated."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    from ...distributed.collectives import all_reduce_region

    mesh = data.device_mesh
    rows = tuple(Shard(0) if isinstance(p, Shard) and p.dim == 0 else Replicate()
                 for p in data.placements)
    if reduce_op == "sum":
        out, region = tuple(Partial() if isinstance(p, Shard) else p for p in rows), fn
    else:
        split = [a for a, p in zip(mesh.mesh_dim_names, rows) if isinstance(p, Shard)]
        out = tuple(Replicate() for _ in rows)

        def region(d, ids):
            m = fn(d, ids)
            for a in split:
                m = all_reduce_region(m, reduce_op, mesh, a)
            return m
    return local_map(region, out_placements=(out,), in_placements=(rows, rows),
                     device_mesh=mesh, redistribute_inputs=True)(data, segment_ids)


def _segment_sum(data: torch.Tensor, segment_ids: torch.Tensor, num_segments: int) -> torch.Tensor:
    def local(d, ids):
        out = d.new_zeros((num_segments,) + tuple(d.shape[1:]))
        return out.index_add_(0, ids, d)

    if is_dtensor(data):
        return _segment_region(local, "sum", data, segment_ids, num_segments)
    return local(data, segment_ids)


def masked_segment_sum(
    data: torch.Tensor, segment_ids: torch.Tensor, num_segments: int,
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    if mask is not None:
        data = torch.where(_trail(mask, data), data, data.new_zeros(()))
    data = shard_ragged(data)
    return shard_ragged(_segment_sum(data, segment_ids, num_segments))


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
    def local(d, ids):
        out = d.new_full((num_segments,) + tuple(d.shape[1:]), float("-inf"))
        idx = _trail(ids.long(), d).expand_as(d)
        return out.scatter_reduce_(0, idx, d, "amax", include_self=True)

    if is_dtensor(data):
        out = _segment_region(local, "max", data, segment_ids, num_segments)
    else:
        out = local(data, segment_ids)
    return out.clamp_min(neg)  # empty segments -> neg floor


def gather_src_dst(x: torch.Tensor, src: torch.Tensor, dst: torch.Tensor):
    return take_rows(x, src), take_rows(x, dst)


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
