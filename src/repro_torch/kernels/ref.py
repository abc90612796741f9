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
    "route_expand_ragged_ids_ref",
    "route_expand_ragged_ref",
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


def route_expand_ragged_ref(
    bits: torch.Tensor,  # [N] i32 per-item replica bitmask, the flat item stream
    sizes: torch.Tensor,  # [N] f32 item bytes
    offsets: torch.Tensor,  # [R + 1] i32 request r's items: [offsets[r], offsets[r + 1])
    origin: torch.Tensor,  # [R] i32 origin DC per request
    comp: torch.Tensor,  # [hier + 1, D] i32 layer component ids
    shift: int = 0,  # a size's units: size * 2**shift
) -> Tuple[torch.Tensor, ...]:
    """Fused stepwise layered expansion (paper §VI) + each request's bytes
    per DC on the flat item stream: request ``r``'s items are
    ``[offsets[r], offsets[r + 1])``, with no ``[R, K]`` tile and no bound
    on a request's length.  The plain version of ``route_expand_ragged``;
    its picks, layers and missing counts are the JAX oracle
    ``route_expand_ref``'s on the same requests.

    Each request keeps its own layer; a pass moves every request still
    walking one greedy step (pick the cluster DC covering the most missing
    items, lowest DC id on ties, or go up a layer), bounded by
    ``L * (D + 1)`` passes.  An item is missing while its bitmask shares no
    bit with the DCs taken so far (the origin, then each pick), and is
    served by the first of them, in order, that holds it.

    The bytes are summed as int64 units, each size times ``2**shift``
    rounded toward zero (exact where the sizes' shift,
    ``core.route_tables.fold_shift``, makes them whole, as the kernel's
    are).  Returns ``(served [N] i8 (-1 unresolved), units [R, D] i64,
    layers_used [R] i32, miss_after [R, L+1] i32, served_dcs [R] i32 (bit d:
    DC d served an item), n_miss [R] i32 (unresolved items))``.
    """
    R = origin.shape[0]
    L = comp.shape[0] - 1
    D = comp.shape[1]
    dev = bits.device
    lens = (offsets[1:] - offsets[:-1]).long()
    req = torch.repeat_interleave(torch.arange(R, device=dev), lens)  # [N]
    o = origin.long()
    ar_R = torch.arange(R, device=dev)
    dcs = torch.arange(D, device=dev)
    has = ((bits.long()[:, None] >> dcs) & 1) > 0  # [N, D]
    comp_l = comp[1:].long()  # [L, D]
    allowed = (comp_l[None, :, :] == comp_l[:, o].T[:, :, None]) & (
        dcs[None, None, :] != o[:, None, None]
    )  # [R, L, D]
    taken = dcs[None, :] == o[:, None]  # [R, D] DCs taken so far
    rank = torch.where(taken, 0, D)  # order of taking; D = never taken
    n_taken = torch.ones(R, dtype=torch.long, device=dev)
    missing = ~(has & taken[req]).any(dim=1)
    nmiss = torch.zeros(R, dtype=torch.long, device=dev).index_add_(0, req, missing.long())
    miss_after = torch.zeros((R, L + 1), dtype=torch.int32, device=dev)
    miss_after[:, 0] = nmiss.to(torch.int32)
    layers_used = torch.zeros(R, dtype=torch.int32, device=dev)
    layer = torch.zeros(R, dtype=torch.long, device=dev)
    walking = (layer < L) & (nmiss > 0)
    it = 0
    while it < L * (D + 1) and bool(walking.any()):
        a_l = allowed[ar_R, layer.clamp(max=max(L - 1, 0))] & walking[:, None]  # [R, D]
        layers_used = torch.where(walking & a_l.any(dim=1), (layer + 1).to(torch.int32),
                                  layers_used)
        cover = torch.zeros((R, D), dtype=torch.long, device=dev).index_add_(
            0, req, (has & missing[:, None]).long()
        )
        cover = torch.where(a_l, cover, torch.zeros_like(cover))
        gain, best = cover.max(dim=1)  # first max == lowest DC id
        step = walking & (gain > 0)
        pick = step[:, None] & (dcs[None, :] == best[:, None])  # [R, D]
        taken = taken | pick
        rank = torch.where(pick, n_taken[:, None], rank)
        n_taken = n_taken + step.long()
        nmiss = nmiss - torch.where(step, gain, torch.zeros_like(gain))
        missing = missing & ~(has & pick[req]).any(dim=1)
        up = walking & ~step
        layer = layer + up.long()
        rows = ar_R[up]
        miss_after[rows, layer[up]] = nmiss[up].to(torch.int32)
        walking = (layer < L) & (nmiss > 0)
        it += 1

    # picks: the first DC taken that holds the item; then the byte fold
    first = torch.where(has, rank[req], D).min(dim=1)
    served = torch.where(first.values < D, first.indices, -1)
    at = served >= 0
    cell = req[at] * D + served[at]
    units = (sizes[at].double() * 2.0 ** shift).long()
    units = torch.zeros(R * D, dtype=torch.int64, device=dev).index_add_(0, cell, units)
    served_d = torch.zeros(R * D, dtype=torch.int32, device=dev)
    served_d[cell] = 1
    served_dcs = (served_d.view(R, D) << dcs.int()).sum(dim=1, dtype=torch.int32)
    n_miss = torch.zeros(R, dtype=torch.int32, device=dev).index_add_(
        0, req[~at], torch.ones_like(req[~at], dtype=torch.int32))
    return (served.to(torch.int8), units.view(R, D), layers_used, miss_after, served_dcs,
            n_miss)


def route_expand_ragged_ids_ref(
    ids: torch.Tensor,  # [N] i32 item ids, the flat item stream
    table_bits: torch.Tensor,  # [I] i32 replica bitmask a row
    table_sizes: torch.Tensor,  # [I] f32 item bytes
    offsets: torch.Tensor,  # [R + 1] i32 request r's items: [offsets[r], offsets[r + 1])
    origin: torch.Tensor,  # [R] i32 origin DC per request
    comp: torch.Tensor,  # [hier + 1, D] i32 layer component ids
    shift: int = 0,  # a size's units: size * 2**shift
) -> Tuple[torch.Tensor, ...]:
    """:func:`route_expand_ragged_ref` on the stream of item ids: slot
    ``k``'s bitmask and bytes are ``table_bits[ids[k]]`` and
    ``table_sizes[ids[k]]``.  The plain version of
    ``route_expand_ragged_ids``; same outputs."""
    ids = ids.long()
    return route_expand_ragged_ref(table_bits[ids], table_sizes[ids], offsets, origin, comp,
                                   shift)
