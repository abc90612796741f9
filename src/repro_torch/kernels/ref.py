"""Plain PyTorch versions of the port's hand-written kernels.

Ports of the JAX oracles in ``repro/kernels/ref.py`` (same names, same
shapes).  They are the ground truth the CUDA kernels are held against, the
path a wrapper takes for tensors on the CPU, and what the tests compare
with the JAX package.  Every function runs on whatever device its inputs
live on.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

__all__ = [
    "attention_ref",
    "dhd_ell_count_ref",
    "dhd_ell_flow_ref",
    "dhd_ell_ref",
    "dhd_ell_ref_batch",
    "embedding_bag_ref",
    "route_expand_masks",
    "route_expand_ref",
]


def attention_ref(
    q: torch.Tensor,  # [B, Hq, Sq, Dqk]
    k: torch.Tensor,  # [B, Hkv, Skv, Dqk]
    v: torch.Tensor,  # [B, Hkv, Skv, Dv]
    causal: bool = True,
    window: Optional[int] = None,  # sliding-window size (local attention)
) -> torch.Tensor:
    """Dense softmax attention with GQA head grouping + causal/local masks,
    ``[B, Hq, Sq, Dv]`` in q's dtype (``Dv`` from ``v``).

    With Sq < Skv (decode/chunked prefill), query position i is aligned to
    absolute position ``i + Skv - Sq`` (the suffix convention).  A fully
    masked row gives 0.  Computed in f32 whatever the input dtype, as the
    flash kernel computes it (the JAX oracle multiplies in the input dtype;
    in bf16 the two agree within the reference's 2e-2)."""
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    if hq % hkv != 0:
        raise ValueError(f"GQA needs Hq % Hkv == 0, got Hq={hq}, Hkv={hkv}")
    group = hq // hkv
    scale = d ** -0.5
    dev = q.device
    kr = k.repeat_interleave(group, dim=1).float()
    vr = v.repeat_interleave(group, dim=1).float()
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), kr) * scale
    q_pos = torch.arange(sq, device=dev)[:, None] + (skv - sq)
    k_pos = torch.arange(skv, device=dev)[None, :]
    mask = torch.ones((sq, skv), dtype=torch.bool, device=dev)
    if causal:
        mask &= k_pos <= q_pos
    if window is not None:
        mask &= k_pos > q_pos - window
    logits = logits.masked_fill(~mask, float("-inf"))
    probs = torch.softmax(logits, dim=-1)
    probs = torch.nan_to_num(probs, nan=0.0)  # fully-masked rows
    return torch.einsum("bhqk,bhkd->bhqd", probs, vr).to(q.dtype)


def embedding_bag_ref(
    table: torch.Tensor,  # [V, D]
    indices: torch.Tensor,  # [B, L] ids
    weights: Optional[torch.Tensor] = None,  # [B, L]
    mode: str = "sum",
) -> torch.Tensor:
    """EmbeddingBag: per-bag weighted gather-reduce (sum, or mean over
    ``max(sum w, 1e-9)``), ``[B, D]`` in the table's dtype.  Sums in f32 as
    the kernel does; ids outside ``[0, V)`` are clamped to the nearest row
    (the JAX oracle's gather clamps ids past the end, wraps negative ones)."""
    ids = indices.long().clamp(0, table.shape[0] - 1)
    rows = table[ids].float()  # [B, L, D]
    w = torch.ones(indices.shape, device=table.device) if weights is None else weights.float()
    out = (rows * w[..., None]).sum(dim=1)
    if mode == "mean":
        out = out / w.sum(dim=1, keepdim=True).clamp_min(1e-9)
    return out.to(table.dtype)


def dhd_ell_ref(
    heat: torch.Tensor,  # [n]
    cols: torch.Tensor,  # [n, kmax] symmetric ELL neighbor ids (pad = self)
    vals: torch.Tensor,  # [n, kmax] edge weights (0 where padded)
    q: torch.Tensor,  # [n] source heat this step
    alpha: float = 0.5,
    gamma: float = 0.1,
    beta: float = 0.3,
) -> torch.Tensor:
    """DHD step (Eqs. 7-8) over a symmetric ELL adjacency; row ``u`` of the
    batched form with B = 1."""
    return dhd_ell_ref_batch(
        heat[None], cols, vals, q[None], alpha=alpha, gamma=gamma, beta=beta
    )[0]


def dhd_ell_ref_batch(
    heat: torch.Tensor,  # [B, n]
    cols: torch.Tensor,  # [n, kmax] symmetric ELL neighbor ids (shared)
    vals: torch.Tensor,  # [n, kmax] shared or [B, n, kmax] per-field weights
    q: torch.Tensor,  # [B, n] source heat this step
    alpha: float = 0.5,
    gamma: float = 0.1,
    beta: float = 0.3,
) -> torch.Tensor:
    """Batched DHD step: B heat fields over one shared ELL column structure.

    A zero weight in 3-D ``vals`` switches the edge off for that field only.
    ``|N_u^out|`` counts strictly-lower-heat active neighbours; outflow uses
    the row's own count, inflow the hotter neighbour's."""
    n_out = dhd_ell_count_ref(heat, cols, vals)
    return dhd_ell_flow_ref(
        heat, n_out, cols, vals, q, alpha=alpha, gamma=gamma, beta=beta
    )


def dhd_ell_count_ref(
    heat: torch.Tensor,  # [B, n]
    cols: torch.Tensor,  # [n, kmax]
    vals: torch.Tensor,  # [n, kmax] or [B, n, kmax]
) -> torch.Tensor:
    """First pass of the step: ``|N_u^out|`` per (field, row) as f32, the
    number of active neighbours with strictly lower heat."""
    h_nb = heat[:, cols.long()]  # [B, n, kmax]
    vals_b = vals if vals.dim() == 3 else vals[None]
    return ((vals_b > 0) & (heat[:, :, None] > h_nb)).sum(dim=-1).to(heat.dtype)


def dhd_ell_flow_ref(
    heat: torch.Tensor,  # [B, n]
    n_out: torch.Tensor,  # [B, n] from dhd_ell_count_ref
    cols: torch.Tensor,  # [n, kmax]
    vals: torch.Tensor,  # [n, kmax] or [B, n, kmax]
    q: torch.Tensor,  # [B, n]
    alpha: float = 0.5,
    gamma: float = 0.1,
    beta: float = 0.3,
) -> torch.Tensor:
    """Second pass: inflow - outflow with ``alpha / max(n_out, 1)`` on both
    ends, then ``(1 - gamma) * (h + delta) + beta * q``."""
    cols = cols.long()
    h_nb = heat[:, cols]  # [B, n, kmax]
    h_u = heat[:, :, None]
    vals_b = vals if vals.dim() == 3 else vals[None]
    active = vals_b > 0
    out_mask = active & (h_u > h_nb)
    in_mask = active & (h_nb > h_u)
    n_out = n_out.clamp_min(1.0)
    zero = heat.new_zeros(())
    outflow = (
        alpha / n_out[..., None] * vals_b * torch.where(out_mask, h_u - h_nb, zero)
    ).sum(dim=-1)
    inflow = (
        alpha / n_out[:, cols] * vals_b * torch.where(in_mask, h_nb - h_u, zero)
    ).sum(dim=-1)
    return (1.0 - gamma) * (heat + inflow - outflow) + beta * q


def route_expand_masks(
    bits: torch.Tensor,  # [R, K] i32 per-item replica bitmask over DCs
    lens: torch.Tensor,  # [R] i32 real item count per request
    origin: torch.Tensor,  # [R] i32 origin DC
    comp: torch.Tensor,  # [hier + 1, D] i32 layer component ids (layer 0 first)
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(valid [R, K], local [R, K], missing [R, K], allowed [R, L, D])``;
    ``allowed[r, l, d]`` is True when DC ``d`` sits in the origin's layer
    ``l + 1`` cluster (the origin itself excluded, as in the greedy)."""
    R, K = bits.shape
    D = comp.shape[1]
    dev = bits.device
    origin = origin.long()
    valid = torch.arange(K, device=dev)[None, :] < lens[:, None]
    local = valid & (((bits >> origin[:, None].to(bits.dtype)) & 1) > 0)
    comp_l = comp[1:]  # [L, D]
    comp_o = comp_l[:, origin].T  # [R, L]
    allowed = (comp_l[None, :, :] == comp_o[:, :, None]) & (
        torch.arange(D, device=dev)[None, None, :] != origin[:, None, None]
    )
    return valid, local, valid & ~local, allowed


def route_expand_ref(
    bits: torch.Tensor,  # [R, K] i32 per-item replica bitmask (bit d = DC d)
    sizes: torch.Tensor,  # [R, K] f32 item bytes (0 where padded)
    lens: torch.Tensor,  # [R] i32 real item count per request
    origin: torch.Tensor,  # [R] i32 origin DC per request
    comp: torch.Tensor,  # [hier + 1, D] i32 layer component ids
    rtt: torch.Tensor,  # [D, D] f32 env RTT matrix
    ibw: torch.Tensor,  # [D, D] f32 elementwise 1 / bandwidth matrix
) -> Tuple[torch.Tensor, ...]:
    """Fused stepwise layered expansion (paper §VI) + Eq. 1 latency fold.

    The batch walks the layers in lockstep: a pass that assigns items
    anywhere stays in the layer, a pass with no progress anywhere moves the
    shared layer pointer up.  Extra passes are idempotent per request, so
    the lockstep walk equals per-request greedy (serve locally, then per
    layer pick the cluster DC covering the most missing items, lowest DC id
    on ties).  The loop is bounded by ``L * (D + 1)`` passes.

    Returns ``(served [R, K] i32 (-1 unresolved), bytes_rd [R, D] f32,
    layers_used [R] i32, miss_after [R, L+1] i32, straggler_s [R] f32,
    wan_bytes [R] f32)``.
    """
    R, K = bits.shape
    L = comp.shape[0] - 1
    D = comp.shape[1]
    dev = bits.device
    valid, local, missing, allowed = route_expand_masks(bits, lens, origin, comp)
    origin_l = origin.long()
    served = torch.where(
        local, origin_l[:, None].to(torch.int32), torch.full((), -1, dtype=torch.int32, device=dev)
    )
    layers_used = torch.zeros(R, dtype=torch.int32, device=dev)
    miss_after = torch.zeros((R, L + 1), dtype=torch.int32, device=dev)
    miss_after[:, 0] = missing.sum(dim=1).to(torch.int32)
    dc_bits = torch.arange(D, device=dev, dtype=bits.dtype)
    has_dc = ((bits[:, :, None] >> dc_bits) & 1) > 0  # [R, K, D]
    layer, it = 0, 0
    while layer < L and it < L * (D + 1) and bool(missing.any()):
        a_l = allowed[:, layer]  # [R, D]
        layers_used = torch.where(
            missing.any(dim=1) & a_l.any(dim=1),
            torch.full((), layer + 1, dtype=torch.int32, device=dev),
            layers_used,
        )
        cover = (has_dc & missing[:, :, None]).sum(dim=1)  # [R, D] exact ints
        cover = torch.where(a_l, cover, torch.zeros_like(cover))
        gain, best = cover.max(dim=1)  # first max == lowest DC id
        hit = missing & (gain > 0)[:, None] & has_dc.gather(
            2, best[:, None, None].expand(R, K, 1)
        )[..., 0]
        served = torch.where(hit, best[:, None].to(torch.int32), served)
        missing = missing & ~hit
        if bool(hit.any()):
            it += 1
            continue
        miss_after[:, layer + 1] = missing.sum(dim=1).to(torch.int32)
        layer += 1
        it += 1

    # Eq. 1 fold: per-DC served bytes -> transfer latency, straggler = max
    # over serving DCs, WAN = bytes served away from the origin
    szv = torch.where(valid, sizes, torch.zeros((), dtype=sizes.dtype, device=dev))
    at_dc = served[:, :, None] == torch.arange(D, device=dev, dtype=torch.int32)
    bytes_rd = torch.where(at_dc, szv[:, :, None], szv.new_zeros(())).sum(dim=1)
    served_d = at_dc.any(dim=1)
    at_origin = torch.arange(D, device=dev)[None, :] == origin_l[:, None]  # [R, D]
    rtt_ro = rtt[:, origin_l].T
    ibw_ro = ibw[:, origin_l].T
    zero = sizes.new_zeros(())
    lat_rd = torch.where(at_origin, zero, rtt_ro + bytes_rd * ibw_ro)
    straggler = torch.where(served_d, lat_rd, zero).max(dim=1).values
    wan = torch.where(at_origin, zero, bytes_rd).sum(dim=1)
    return served, bytes_rd, layers_used, miss_after, straggler, wan
