"""Mixture-of-Experts FFN with capacity-bounded sort dispatch.

Port of ``repro/models/moe.py``, with the JAX package's sharding
constraints (:func:`repro_torch.distributed.constraints.constrain`: no-ops
on one device):
  * router: f32 softmax top-k with renormalised gates, optional shared
    experts (DeepSeekMoE style);
  * dispatch: per token group, assignments stably sorted by expert id,
    positions within an expert from the sorted index minus the expert's
    first index, **capacity-clamped scatter** into a dense ``[E, C, d]``
    buffer (over-capacity assignments add zero to the last slot);
  * expert compute: batched SwiGLU over the expert axis (every expert runs
    on its buffer, full or not);
  * combine: weighted gather-back, scatter-added per token; dropped
    assignments contribute nothing (GShard semantics).

``expert_load`` (per-expert routing share, GeoLayer's heat signal) and the
Switch ``aux_loss`` are returned as in the JAX package.

On DTensors (a mesh in use) the group-local dispatch and combine, the
reference's ``vmap``-ed ``dispatch``/``combine``, run as ``local_map``
regions with the groups over the data-parallel axes (DTensor has no
sharding rule for their sorts, scatters and indexed adds); the expert
buffer is pinned to ``("model", dp, None)`` between them, so the experts
shard over ``model`` and their SwiGLU runs on DTensors.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..device import DeviceLike
from ..distributed.constraints import constrain, mesh_of
from .layers import Params, normal

__all__ = ["moe_forward", "moe_init"]


_DP = ("pod", "data")


def _pick_groups(t: int, mesh=None, target: int = 0) -> int:
    """Dispatch group count: aligned with ``mesh``'s data-parallel extent
    (pod x data) so every group is shard-local; 16 without a mesh (the JAX
    package's rule).  The largest power-of-two divisor of ``t`` up to that
    target."""
    if target <= 0:
        m = mesh
        target = 1
        if m is not None:
            sizes = dict(zip(m.mesh_dim_names, m.shape))
            for ax in _DP:
                target *= sizes.get(ax, 1)
        if target <= 1:
            target = 16
    g = target
    while g > 1 and t % g != 0:
        g //= 2
    return g


def moe_init(
    generator: torch.Generator,
    d_model: int,
    d_ff_expert: int,
    n_experts: int,
    n_shared: int = 0,
    d_ff_shared: Optional[int] = None,
    device: DeviceLike = None,
    dtype: torch.dtype = torch.float32,
) -> Params:
    """MoE params with the JAX package's scales; the router in f32, the
    expert and shared-expert weights in ``dtype``."""
    s = 1.0 / math.sqrt(d_model)
    sf = 1.0 / math.sqrt(d_ff_expert)
    p: Params = {
        "router": normal(generator, (d_model, n_experts), s, device),
        "w_gate": normal(generator, (n_experts, d_model, d_ff_expert), s, device, dtype),
        "w_up": normal(generator, (n_experts, d_model, d_ff_expert), s, device, dtype),
        "w_down": normal(generator, (n_experts, d_ff_expert, d_model), sf, device, dtype),
    }
    if n_shared > 0:
        dfs = d_ff_shared or d_ff_expert * n_shared
        p["shared_gate"] = normal(generator, (d_model, dfs), s, device, dtype)
        p["shared_up"] = normal(generator, (d_model, dfs), s, device, dtype)
        p["shared_down"] = normal(generator, (dfs, d_model), 1.0 / math.sqrt(dfs), device, dtype)
    return p


def moe_forward(
    p: Params,
    x: torch.Tensor,  # [B, S, d]
    top_k: int,
    capacity_factor: float = 1.25,
    dtype: torch.dtype = torch.bfloat16,
    n_active: Optional[int] = None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Returns (output, aux) where aux carries ``expert_load`` and
    ``aux_loss``.  ``n_active < E`` marks trailing experts as padding: the
    router never selects them."""
    b, s, d = x.shape
    e = p["router"].shape[1]
    t = b * s
    dev = x.device
    # tokens split over the data-parallel axes only, so that the groups below
    # split with them (the reference pins the grouped tokens, ``xg``; DTensor
    # cannot regroup a token axis split over ``model`` as well)
    xt = constrain(x.reshape(t, d).to(dtype), _DP, None)

    logits = xt.float() @ p["router"]
    if n_active is not None and n_active < e:
        pad_mask = torch.arange(e, device=dev) >= n_active
        logits = logits.masked_fill(pad_mask[None, :], -1e30)
    probs = torch.softmax(logits, dim=-1)  # [T, E]
    gate_vals, gate_idx = torch.topk(probs, top_k, dim=-1)  # [T, k]
    gate_vals = gate_vals / gate_vals.sum(dim=-1, keepdim=True).clamp_min(1e-9)

    # group-local dispatch: each group sorts and capacity-clamps on its own
    n_groups = _pick_groups(t, mesh_of(xt))
    tg = t // n_groups
    capacity = max(int(capacity_factor * tg * top_k / e), 4)
    xg = constrain(xt.reshape(n_groups, tg, d), _DP, None, None)
    route = (gate_idx.reshape(n_groups, tg * top_k), gate_vals.reshape(n_groups, tg * top_k))
    buf_g, state, load = _grouped(_dispatch, ("g",) * 6 + ("sum",), e, capacity, top_k)(
        route[0], route[1], xg)
    # [G, E, C, d] -> [E, G*C, d]: the all-to-all point (EP over `model`)
    buf = constrain(buf_g.transpose(0, 1).reshape(e, n_groups * capacity, d),
                    "model", _DP, None)

    # expert SwiGLU over the E axis
    g = F.silu(torch.bmm(buf, p["w_gate"].to(dtype)))
    u = torch.bmm(buf, p["w_up"].to(dtype))
    y = torch.bmm(g * u, p["w_down"].to(dtype))  # [E, G*C, d]
    y = constrain(y, "model", _DP, None)
    y_g = y.reshape(e, n_groups, capacity, d).transpose(0, 1)  # [G, E, C, d]

    out = _grouped(_combine, ("g",), top_k)(y_g, *state)
    out = constrain(out, _DP, None, None).reshape(t, d)

    if "shared_gate" in p:
        sg = F.silu(xt @ p["shared_gate"].to(dtype))
        su = xt @ p["shared_up"].to(dtype)
        out = out + (sg * su) @ p["shared_down"].to(dtype)

    # load-balance aux loss (Switch): e * sum(f_i * P_i)
    load = load / (t * top_k)
    imp = probs.mean(dim=0)
    aux_loss = e * (load * imp).sum()
    return out.reshape(b, s, d), {"expert_load": load, "aux_loss": aux_loss}


def _dispatch(flat_e: torch.Tensor, flat_w: torch.Tensor, xg: torch.Tensor, e: int,
              capacity: int, top_k: int):
    """Group-local dispatch of ``G`` groups: assignments ``flat_e`` /
    ``flat_w`` ``[G, tg*k]`` stably sorted by expert, positions within an
    expert, capacity-clamped scatter of the token rows ``xg`` ``[G, tg, d]``
    into ``[G, E, C, d]``.  Returns (buffer, (se, st, sw, keep, pos_c), the
    per-expert assignment counts ``[E]`` in f32)."""
    n_groups, tk = flat_e.shape
    tg, d = xg.shape[1], xg.shape[2]
    dev, dtype = xg.device, xg.dtype
    flat_t = torch.arange(tg, device=dev).repeat_interleave(top_k)
    se, order = torch.sort(flat_e, dim=-1, stable=True)  # [G, tk]
    st = flat_t[order]
    sw = torch.gather(flat_w, 1, order)
    cum = torch.arange(tk, device=dev).expand(n_groups, tk)
    first = torch.full((n_groups, e), tk, dtype=cum.dtype, device=dev)
    first = first.scatter_reduce(1, se, cum, reduce="amin")
    pos = cum - torch.gather(first, 1, se)
    keep = pos < capacity
    pos_c = torch.where(keep, pos, torch.full_like(pos, capacity - 1))
    gid = torch.arange(n_groups, device=dev)[:, None].expand(n_groups, tk)
    rows = xg[gid, st]  # [G, tk, d]
    zero = torch.zeros((), dtype=dtype, device=dev)
    buf = torch.zeros((n_groups, e, capacity, d), dtype=dtype, device=dev)
    buf.index_put_((gid, se, pos_c), torch.where(keep[..., None], rows, zero), accumulate=True)
    load = torch.zeros(e, dtype=torch.float32, device=dev)
    load.index_add_(0, flat_e.reshape(-1), torch.ones(n_groups * tk, device=dev))
    return buf, (se, st, sw, keep, pos_c), load


def _combine(y_g: torch.Tensor, se: torch.Tensor, st: torch.Tensor, sw: torch.Tensor,
             keep: torch.Tensor, pos_c: torch.Tensor, top_k: int) -> torch.Tensor:
    """Weighted gather-back of each group's expert outputs ``y_g``
    ``[G, E, C, d]`` to its tokens, scatter-added: ``[G, tg, d]``."""
    n_groups, tk = se.shape
    d, dtype, dev = y_g.shape[3], y_g.dtype, y_g.device
    gid = torch.arange(n_groups, device=dev)[:, None].expand(n_groups, tk)
    gathered = y_g[gid, se, pos_c]  # [G, tk, d]
    zero = torch.zeros((), dtype=dtype, device=dev)
    contrib = torch.where(keep[..., None], gathered * sw[..., None].to(dtype), zero)
    out = torch.zeros((n_groups, tk // top_k, d), dtype=dtype, device=dev)
    out.index_put_((gid, st), contrib, accumulate=True)
    return out


def _grouped(fn: Callable, outs: Tuple[str, ...], *static) -> Callable:
    """``fn(*tensors, *static)`` over groups on the leading axis.  On plain
    tensors it is ``fn``; on DTensors a ``local_map`` region: the group
    axis over the data-parallel mesh dims (when they divide it), the rest
    replicated, and each flattened output either split by group (``"g"``)
    or a per-rank partial sum over those dims (``"sum"``)."""

    def call(*tensors):
        from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
        from torch.distributed.tensor.experimental import local_map

        if not isinstance(tensors[0], DTensor):
            return fn(*tensors, *static)
        mesh = tensors[0].device_mesh
        dp = [i for i, a in enumerate(mesh.mesh_dim_names) if a in _DP]
        f = 1
        for i in dp:
            f *= mesh.shape[i]
        split = f > 1 and tensors[0].shape[0] % f == 0
        by_group = tuple(Shard(0) if (split and i in dp) else Replicate()
                         for i in range(mesh.ndim))
        summed = tuple(Partial() if (split and i in dp) else Replicate()
                       for i in range(mesh.ndim))
        region = local_map(
            lambda *ts: fn(*ts, *static),
            out_placements=tuple(by_group if o == "g" else summed for o in outs),
            in_placements=tuple(by_group for _ in tensors),
            device_mesh=mesh, redistribute_inputs=True,
        )
        return region(*tensors)

    return call
