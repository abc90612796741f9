"""Mixture-of-Experts FFN with capacity-bounded sort dispatch.

Port of ``repro/models/moe.py`` on one device (the JAX package's sharding
constraints have nothing to constrain here):
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
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..device import DeviceLike
from .layers import Params, normal

__all__ = ["moe_forward", "moe_init"]


def _pick_groups(t: int, target: int = 16) -> int:
    """Dispatch group count: the largest power-of-two divisor of ``t`` up to
    ``target`` (16, the JAX package's choice without a device mesh)."""
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
    xt = x.reshape(t, d).to(dtype)

    logits = xt.float() @ p["router"]
    if n_active is not None and n_active < e:
        pad_mask = torch.arange(e, device=dev) >= n_active
        logits = logits.masked_fill(pad_mask[None, :], -1e30)
    probs = torch.softmax(logits, dim=-1)  # [T, E]
    gate_vals, gate_idx = torch.topk(probs, top_k, dim=-1)  # [T, k]
    gate_vals = gate_vals / gate_vals.sum(dim=-1, keepdim=True).clamp_min(1e-9)

    # group-local dispatch: each group sorts and capacity-clamps on its own
    n_groups = _pick_groups(t)
    tg = t // n_groups
    tk = tg * top_k
    capacity = max(int(capacity_factor * tg * top_k / e), 4)
    flat_e = gate_idx.reshape(n_groups, tk)
    flat_w = gate_vals.reshape(n_groups, tk)
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
    xg = xt.reshape(n_groups, tg, d)
    rows = xg[gid, st]  # [G, tk, d]
    zero = torch.zeros((), dtype=dtype, device=dev)
    buf = torch.zeros((n_groups, e, capacity, d), dtype=dtype, device=dev)
    buf.index_put_((gid, se, pos_c), torch.where(keep[..., None], rows, zero), accumulate=True)
    buf = buf.transpose(0, 1).reshape(e, n_groups * capacity, d)  # [E, G*C, d]

    # expert SwiGLU over the E axis
    g = F.silu(torch.bmm(buf, p["w_gate"].to(dtype)))
    u = torch.bmm(buf, p["w_up"].to(dtype))
    y = torch.bmm(g * u, p["w_down"].to(dtype))  # [E, G*C, d]
    y_g = y.reshape(e, n_groups, capacity, d).transpose(0, 1)  # [G, E, C, d]

    gathered = y_g[gid, se, pos_c]  # [G, tk, d]
    contrib = torch.where(keep[..., None], gathered * sw[..., None].to(dtype), zero)
    out = torch.zeros((n_groups, tg, d), dtype=dtype, device=dev)
    out.index_put_((gid, st), contrib, accumulate=True)
    out = out.reshape(t, d)

    if "shared_gate" in p:
        sg = F.silu(xt @ p["shared_gate"].to(dtype))
        su = xt @ p["shared_up"].to(dtype)
        out = out + (sg * su) @ p["shared_down"].to(dtype)

    # load-balance aux loss (Switch): e * sum(f_i * P_i)
    load = torch.zeros(e, dtype=torch.float32, device=dev)
    load.index_add_(0, gate_idx.reshape(-1), torch.ones(t * top_k, device=dev))
    load = load / (t * top_k)
    imp = probs.mean(dim=0)
    aux_loss = e * (load * imp).sum()
    return out.reshape(b, s, d), {"expert_load": load, "aux_loss": aux_loss}
