"""Collective helpers over one axis of a ``DeviceMesh``, plus the explicit
device-to-device transfer the sharded store's migration waves and the GNN
halo exchange (``halo_exec.py``) run through.

Port of ``repro/distributed/collectives.py``.  Where the reference's
``pmean_tree`` and ``all_to_all_tokens`` run inside ``shard_map`` on a
named axis, the port's take the local tensors of a rank and the mesh and
axis name, and issue functional collectives over that axis's process
group.  :func:`all_reduce_region` is the reduction a ``local_map`` region
ends with when its result is replicated: a sum's backward is the identity
(each rank's gradient of a replicated value is already whole), a max's
sends the gradient to the ranks that hold the maximum.
"""
from __future__ import annotations

from typing import Any, Optional, Tuple, Union

import numpy as np
import torch

from .compression import compress_int8, decompress_int8

__all__ = ["all_reduce_region", "all_to_all_tokens", "pmean_tree", "transfer_rows"]


def _group(mesh, axis: str):
    return mesh.get_group(axis)


def _all_reduce(x: torch.Tensor, op: str, group) -> torch.Tensor:
    import torch.distributed._functional_collectives as funcol

    return funcol.wait_tensor(funcol.all_reduce(x, op, group))


def pmean_tree(tree: Any, mesh, axis: str) -> Any:
    """Each leaf (nested dicts of local tensors) averaged over the ranks of
    ``axis``: a sum all-reduce, then divided by the group size (the
    reference's ``pmean``, a ``psum`` over ``n``)."""
    if isinstance(tree, dict):
        return {k: pmean_tree(v, mesh, axis) for k, v in tree.items()}
    n = mesh.size(mesh.mesh_dim_names.index(axis))
    return _all_reduce(tree, "sum", _group(mesh, axis)) / n


def all_to_all_tokens(x: torch.Tensor, mesh, axis: str, split_axis: int = 0,
                      concat_axis: int = 0) -> torch.Tensor:
    """Expert-parallel token exchange, ``jax.lax.all_to_all(..., tiled=True)``:
    ``x`` is cut into ``n`` equal chunks along ``split_axis``, chunk ``i``
    goes to rank ``i`` of ``axis``, and the chunks received are joined
    along ``concat_axis`` in rank order."""
    import torch.distributed._functional_collectives as funcol

    n = mesh.size(mesh.mesh_dim_names.index(axis))
    if x.shape[split_axis] % n:
        raise ValueError(f"dim {split_axis} of {tuple(x.shape)} does not split into {n}")
    send = torch.stack(x.chunk(n, dim=split_axis)).contiguous()  # [n, ...]
    recv = funcol.wait_tensor(funcol.all_to_all_single(send, None, None, _group(mesh, axis)))
    return torch.cat(list(recv.reshape(send.shape).unbind(0)), dim=concat_axis)


class _RegionAllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, op, group):
        out = _all_reduce(x, op, group)
        ctx.op, ctx.group = op, group
        if op == "max":
            ctx.save_for_backward(x, out)
        return out

    @staticmethod
    def backward(ctx, g):
        if ctx.op == "sum":
            return g, None, None
        x, out = ctx.saved_tensors
        hit = (x == out).to(g.dtype)
        # a maximum held by several ranks splits its gradient among them, as amax's does
        return g * hit / _all_reduce(hit, "sum", ctx.group), None, None


def all_reduce_region(x: torch.Tensor, op: str, mesh, axis: str) -> torch.Tensor:
    """All-reduce (``"sum"`` or ``"max"``) of a region's local partial over
    ``axis``, its result replicated.  The backward of a sum passes the
    gradient through; that of a max passes it to the ranks whose partial
    is the maximum (split evenly where several are)."""
    if op not in ("sum", "max"):
        raise ValueError(f"all_reduce_region reduces by 'sum' or 'max', not {op!r}")
    return _RegionAllReduce.apply(x, op, _group(mesh, axis))


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
