"""Attention variants for the LM zoo: GQA (+qk-norm) and MLA (DeepSeek-V2
latent KV compression).

Port of ``repro/models/attention.py``: ``chunked_attention``, ``_attend``,
the head split and merge helpers, ``gqa_init`` / ``gqa_forward`` /
``gqa_decode`` and ``mla_init`` / ``mla_forward`` / ``mla_decode``.  The
decoder's layer loop (:mod:`.transformer`) runs GQA through its own
per-layer-window functions; ``gqa_forward`` and ``gqa_decode`` are the
single-layer entry points, as in the JAX package.

Execution paths:
  * ``ops.attention``     — the CUDA flash kernel on the card (prefill), its
    plain version on the CPU.
  * ``chunked_attention`` — plain torch online softmax over KV chunks, as
    the JAX package computes it outside any Pallas kernel; decode takes it
    (its ``kv_valid`` mask is per batch row).

KV caches are dicts of tensors.  ``mla_decode`` and ``gqa_decode`` write
the new token's cache entries into the caller's cache tensors in place
(the JAX package returns updated copies); at 1,024 slots x 27 layers a
copy per step would move the whole cache.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from ..device import DeviceLike
from ..distributed.constraints import constrain, is_dtensor, pinned, splittable
from ..distributed.sharding import axis_rank
from ..kernels import ops
from ..kernels.ref import attention_ref
from .layers import Params, dense_init, normal, rmsnorm, rmsnorm_init, rope

__all__ = [
    "chunked_attention",
    "gqa_decode",
    "gqa_forward",
    "gqa_init",
    "mla_decode",
    "mla_forward",
    "mla_init",
]


# ------------------------------------------------------- chunked (plain torch)
def chunked_attention(
    q: torch.Tensor,  # [B, Hq, Sq, D]
    k: torch.Tensor,  # [B, Hkv, Skv, D]
    v: torch.Tensor,  # [B, Hkv, Skv, Dv]
    causal: bool = True,
    window: Optional[int] = None,
    chunk_kv: int = 1024,
    chunk_q: int = 2048,
    kv_valid: Optional[torch.Tensor] = None,  # [B] #valid kv positions
) -> torch.Tensor:
    """Online-softmax attention over KV (and Q) chunks — O(Sq*Ckv) peak.

    Equivalent to ``ref.attention_ref``; ``kv_valid`` masks each batch
    row's cache past its valid length."""
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    dv = v.shape[-1]  # may differ from qk dim (MLA)
    group = hq // hkv
    scale = d ** -0.5
    dev = q.device
    chunk_kv = min(chunk_kv, skv)
    chunk_q = min(chunk_q, sq)
    pad_kv = (-skv) % chunk_kv
    if pad_kv:
        k = torch.nn.functional.pad(k, (0, 0, 0, pad_kv))
        v = torch.nn.functional.pad(v, (0, 0, 0, pad_kv))
    n_kv = k.shape[2] // chunk_kv

    def q_block(qb: torch.Tensor, q0: int) -> torch.Tensor:
        cq = qb.shape[2]
        qf = qb.float()
        m = torch.full((b, hq, cq, 1), -1e30, dtype=torch.float32, device=dev)
        l = torch.zeros((b, hq, cq, 1), dtype=torch.float32, device=dev)
        acc = torch.zeros((b, hq, cq, dv), dtype=torch.float32, device=dev)
        q_pos = q0 + torch.arange(cq, device=dev)[:, None] + (skv - sq)
        for ikv in range(n_kv):
            sl = slice(ikv * chunk_kv, (ikv + 1) * chunk_kv)
            kb = k[:, :, sl].repeat_interleave(group, dim=1)
            vb = v[:, :, sl].repeat_interleave(group, dim=1)
            s = torch.einsum("bhqd,bhkd->bhqk", qf, kb.float()) * scale
            k_pos = ikv * chunk_kv + torch.arange(chunk_kv, device=dev)[None, :]
            mask = k_pos < skv  # padding
            if causal:
                mask = mask & (k_pos <= q_pos)
            if window is not None:
                mask = mask & (k_pos > q_pos - window)
            if kv_valid is not None:
                mask = (mask[None] & (k_pos[None] < kv_valid[:, None, None]))[:, None]
            else:
                mask = mask[None, None]
            s = torch.where(mask, s, torch.full((), -1e30, device=dev))
            m_cur = s.amax(dim=-1, keepdim=True)
            m_new = torch.maximum(m, m_cur)
            p = torch.exp(s - m_new)
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1, keepdim=True)
            acc = acc * corr + torch.einsum("bhqk,bhkd->bhqd", p, vb.float())
            m = m_new
        return (acc / l.clamp_min(1e-30)).to(q.dtype)

    if sq <= chunk_q:
        return q_block(q, 0)
    if sq % chunk_q:
        raise ValueError(f"Sq={sq} must be a multiple of chunk_q={chunk_q}")
    return torch.cat(
        [q_block(q[:, :, i:i + chunk_q], i) for i in range(0, sq, chunk_q)], dim=2
    )


def _attend(q, k, v, causal: bool, window: Optional[int], kv_valid=None) -> torch.Tensor:
    """Dispatch: flash kernel (card, or any DTensor: the registered op runs
    sharded) -> chunked (long or masked) -> dense plain."""
    if kv_valid is None and (q.device.type == "cuda" or is_dtensor(q)):
        return ops.attention(q, k, v, causal=causal, window=window)
    if is_dtensor(q):  # masked decode: the chunked form, sharded as the op is
        return ops.sharded_attention(
            q, k, v, lambda q_, k_, v_, kv_: chunked_attention(
                q_, k_, v_, causal=causal, window=window, kv_valid=kv_), kv_valid)
    if k.shape[2] > 2048 or kv_valid is not None:
        return chunked_attention(q, k, v, causal=causal, window=window, kv_valid=kv_valid)
    return attention_ref(q, k, v, causal=causal, window=window)


_DP = ("pod", "data")


class _DenseGrad(torch.autograd.Function):
    """Identity whose backward makes the gradient contiguous: DTensor runs
    a reshape's backward as a view of the local gradient, which a
    transpose's backward leaves strided."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        # a clone, not .contiguous(): a DTensor's global strides may call a
        # strided local contiguous
        return g.clone(memory_format=torch.contiguous_format)


def _split_heads(x: torch.Tensor, n: int) -> torch.Tensor:
    b, s, _ = x.shape
    y = splittable(x, -1, n).reshape(b, s, n, -1)
    if is_dtensor(y):
        y = _DenseGrad.apply(y)
    return y.transpose(1, 2)  # [B, H, S, D]


def _heads(x: torch.Tensor) -> torch.Tensor:
    """Pin a ``[B, H, S, D]`` activation: batch over the data-parallel
    axes, heads over ``model``."""
    return constrain(x, _DP, "model", None, None)


def _merge_heads(x: torch.Tensor) -> torch.Tensor:
    b, h, s, d = x.shape
    if is_dtensor(x):  # DTensor may take the reshape for a view of a strided local
        y = x.transpose(1, 2).clone(memory_format=torch.contiguous_format)
        return pinned(y.reshape(b, s, h * d))
    return x.transpose(1, 2).reshape(b, s, h * d)


def _write_position(cache: torch.Tensor, new: torch.Tensor, position: torch.Tensor) -> None:
    """``cache[b, ..., position[b], :] = new[b, ..., 0, :]`` for each batch
    row, the position clamped into the cache as ``dynamic_update_slice``
    clamps it; the sequence axis is ``-2``.  A DTensor cache is written in
    place by :func:`_write_position_sharded`."""
    if is_dtensor(cache):
        _write_position_sharded(cache, new, position)
        return
    rows = torch.arange(cache.shape[0], device=cache.device)
    at = position.long().clamp(0, cache.shape[-2] - 1)
    cache.transpose(1, -2)[rows, at] = new.transpose(1, -2)[:, 0].to(cache.dtype)


def _write_position_sharded(cache, new, position) -> None:
    """:func:`_write_position` on a DTensor cache, as a ``local_map`` region
    on its own placements (``new`` and ``position`` follow its batch
    split): each rank writes its rows into its local slice.  Where the
    sequence axis is split (long-context decode), the rank whose slice
    holds the position writes it and every other rank writes back the value
    it already holds."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh = cache.device_mesh
    names = tuple(mesh.mesh_dim_names)
    seq = cache.dim() - 2
    pl = tuple(cache.placements)
    seq_axes = [names[i] for i, p in enumerate(pl) if isinstance(p, Shard) and p.dim == seq]
    new_pl = tuple(Replicate() if isinstance(p, Shard) and p.dim == seq else p for p in pl)
    pos_pl = tuple(p if isinstance(p, Shard) and p.dim == 0 else Replicate() for p in pl)
    s_global = cache.shape[seq]

    def local(c, n, pos):
        s_local = c.shape[seq]
        at = pos.long().clamp(0, s_global - 1) - axis_rank(mesh, seq_axes) * s_local
        inside = (at >= 0) & (at < s_local)
        at = at.clamp(0, s_local - 1)
        rows = torch.arange(c.shape[0], device=c.device)
        view = c.transpose(1, -2)
        val = n.transpose(1, -2)[:, 0].to(c.dtype)
        if seq_axes:
            keep = inside.reshape((-1,) + (1,) * (val.dim() - 1))
            val = torch.where(keep, val, view[rows, at])
        view[rows, at] = val
        return c

    local_map(local, out_placements=(pl,), in_placements=(pl, new_pl, pos_pl),
              device_mesh=mesh, redistribute_inputs=True)(cache, new, position)


# ------------------------------------------------------------------- GQA
def gqa_init(
    generator: torch.Generator,
    d_model: int,
    n_heads: int,
    n_kv_heads: int,
    head_dim: int,
    qk_norm: bool = False,
    device: DeviceLike = None,
    dtype: torch.dtype = torch.float32,
) -> Params:
    """GQA params with the JAX package's scales; the projections in
    ``dtype``, ``q_norm`` / ``k_norm`` in f32."""
    p: Params = {
        "wq": dense_init(generator, d_model, n_heads * head_dim, device=device)["w"],
        "wk": dense_init(generator, d_model, n_kv_heads * head_dim, device=device)["w"],
        "wv": dense_init(generator, d_model, n_kv_heads * head_dim, device=device)["w"],
        "wo": dense_init(generator, n_heads * head_dim, d_model, device=device)["w"],
    }
    p = {k: w.to(dtype) for k, w in p.items()}
    if qk_norm:
        p["q_norm"] = rmsnorm_init(head_dim, device)["g"]
        p["k_norm"] = rmsnorm_init(head_dim, device)["g"]
    return p


def _gqa_qkv(p: Params, x: torch.Tensor, positions: torch.Tensor, n_heads: int,
             n_kv_heads: int, rope_base: float, dtype: torch.dtype):
    """q ``[B, Hq, S, D]``, k and v ``[B, Hkv, S, D]``: projected, qk-normed
    when the params carry the gains, q and k rotated."""
    xd = x.to(dtype)
    q = _heads(_split_heads(xd @ p["wq"].to(dtype), n_heads))
    k = _heads(_split_heads(xd @ p["wk"].to(dtype), n_kv_heads))
    v = _heads(_split_heads(xd @ p["wv"].to(dtype), n_kv_heads))
    if "q_norm" in p:
        q = rmsnorm({"g": p["q_norm"]}, q)
        k = rmsnorm({"g": p["k_norm"]}, k)
    return rope(q, positions, rope_base), rope(k, positions, rope_base), v


def gqa_forward(
    p: Params,
    x: torch.Tensor,  # [B, S, d_model]
    positions: torch.Tensor,  # [S] or [B, S]
    n_heads: int,
    n_kv_heads: int,
    causal: bool = True,
    window: Optional[int] = None,
    rope_base: float = 10000.0,
    dtype: torch.dtype = torch.bfloat16,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Full-sequence attention (prefill).  Returns (out, kv_cache)."""
    q, k, v = _gqa_qkv(p, x, positions, n_heads, n_kv_heads, rope_base, dtype)
    o = _heads(_attend(q, k, v, causal, window))
    out = _merge_heads(o).to(dtype) @ p["wo"].to(dtype)
    return out, {"k": k, "v": v}


def gqa_decode(
    p: Params,
    x: torch.Tensor,  # [B, 1, d_model]
    cache: Dict[str, torch.Tensor],  # k/v: [B, Hkv, Smax, D]
    position: torch.Tensor,  # [B] current absolute position
    n_heads: int,
    n_kv_heads: int,
    window: Optional[int] = None,
    rope_base: float = 10000.0,
    dtype: torch.dtype = torch.bfloat16,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Single-token decode; writes the token's k and v into the caller's
    cache in place at ``position`` and returns ``(out, cache)``."""
    q, k_new, v_new = _gqa_qkv(p, x, position[:, None], n_heads, n_kv_heads, rope_base,
                               dtype)
    kc, vc = cache["k"], cache["v"]
    _write_position(kc, k_new, position)
    _write_position(vc, v_new, position)
    o = _attend(q, kc, vc, causal=False, window=window, kv_valid=position + 1)
    out = _merge_heads(o).to(dtype) @ p["wo"].to(dtype)
    return out, {"k": kc, "v": vc}


# ------------------------------------------------------------------- MLA
def mla_init(
    generator: torch.Generator,
    d_model: int,
    n_heads: int,
    kv_lora_rank: int,
    qk_nope_dim: int = 128,
    qk_rope_dim: int = 64,
    v_head_dim: int = 128,
    device: DeviceLike = None,
    dtype: torch.dtype = torch.float32,
) -> Params:
    """MLA params with the JAX package's scales; the matmul weights in
    ``dtype``, ``kv_norm`` in f32."""
    s = 1.0 / math.sqrt(d_model)
    sl = 1.0 / math.sqrt(kv_lora_rank)
    so = 1.0 / math.sqrt(n_heads * v_head_dim)
    return {
        "wq": normal(generator, (d_model, n_heads * (qk_nope_dim + qk_rope_dim)), s,
                     device, dtype),
        "w_dkv": normal(generator, (d_model, kv_lora_rank), s, device, dtype),
        "w_krope": normal(generator, (d_model, qk_rope_dim), s, device, dtype),
        "w_uk": normal(generator, (kv_lora_rank, n_heads * qk_nope_dim), sl, device, dtype),
        "w_uv": normal(generator, (kv_lora_rank, n_heads * v_head_dim), sl, device, dtype),
        "wo": normal(generator, (n_heads * v_head_dim, d_model), so, device, dtype),
        "kv_norm": rmsnorm_init(kv_lora_rank, device)["g"],
    }


def mla_forward(
    p: Params,
    x: torch.Tensor,  # [B, S, d]
    positions: torch.Tensor,  # [S]
    n_heads: int,
    qk_nope_dim: int = 128,
    qk_rope_dim: int = 64,
    v_head_dim: int = 128,
    causal: bool = True,
    dtype: torch.dtype = torch.bfloat16,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """MLA (DeepSeek-V2): latent-compressed KV + decoupled RoPE head.

    The cache stores only (c_kv [B,S,r], k_rope [B,S,dr]); keys and values
    are up-projected per step (no absorbed-weight trick)."""
    b, s, _ = x.shape
    xd = x.to(dtype)
    q = _heads(_split_heads(xd @ p["wq"].to(dtype), n_heads))
    q_nope, q_rope = q[..., :qk_nope_dim], q[..., qk_nope_dim:]
    q_rope = rope(q_rope, positions)
    # the latent projections pinned: their gradients come back in the
    # layout they left in (DTensor would otherwise take a strided one)
    c_kv = rmsnorm({"g": p["kv_norm"]}, pinned(xd @ p["w_dkv"].to(dtype)))  # [B,S,r]
    k_rope = rope(pinned(xd @ p["w_krope"].to(dtype))[:, None], positions)  # [B,1,S,dr] shared head
    k_nope = _heads(_split_heads(c_kv @ p["w_uk"].to(dtype), n_heads))
    v = _heads(_split_heads(c_kv @ p["w_uv"].to(dtype), n_heads))
    q_full = torch.cat([q_nope, q_rope], dim=-1)
    k_full = torch.cat([k_nope, k_rope.expand(b, n_heads, s, qk_rope_dim)], dim=-1)
    o = _heads(_attend(q_full, k_full, v, causal, None))
    out = _merge_heads(o).to(dtype) @ p["wo"].to(dtype)
    return out, {"c_kv": c_kv, "k_rope": k_rope[:, 0]}


def mla_decode(
    p: Params,
    x: torch.Tensor,  # [B, 1, d]
    cache: Dict[str, torch.Tensor],  # c_kv [B, Smax, r], k_rope [B, Smax, dr]
    position: torch.Tensor,  # [B]
    n_heads: int,
    qk_nope_dim: int = 128,
    qk_rope_dim: int = 64,
    v_head_dim: int = 128,
    dtype: torch.dtype = torch.bfloat16,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One-token MLA step; writes the token's cache entries in place at
    ``position`` (clamped into the cache, as ``dynamic_update_slice`` does)
    and returns ``(out, cache)``."""
    b = x.shape[0]
    xd = x.to(dtype)
    q = _split_heads(xd @ p["wq"].to(dtype), n_heads)
    q_nope, q_rope = q[..., :qk_nope_dim], q[..., qk_nope_dim:]
    q_rope = rope(q_rope, position[:, None])
    c_new = rmsnorm({"g": p["kv_norm"]}, xd @ p["w_dkv"].to(dtype))  # [B,1,r]
    kr_new = rope((xd @ p["w_krope"].to(dtype))[:, None], position[:, None])[:, 0]  # [B,1,dr]
    c_kv, k_rope = cache["c_kv"], cache["k_rope"]
    s_max = c_kv.shape[1]
    _write_position(c_kv, c_new, position)
    _write_position(k_rope, kr_new, position)
    k_nope = _heads(_split_heads(c_kv @ p["w_uk"].to(dtype), n_heads))
    v = _heads(_split_heads(c_kv @ p["w_uv"].to(dtype), n_heads))
    q_full = torch.cat([q_nope, q_rope], dim=-1)
    k_full = torch.cat(
        [k_nope, k_rope[:, None].expand(b, n_heads, s_max, qk_rope_dim)], dim=-1
    )
    kv_valid = position + 1
    o = _attend(q_full, k_full, v, causal=False, window=None, kv_valid=kv_valid)
    out = _merge_heads(o).to(dtype) @ p["wo"].to(dtype)
    return out, {"c_kv": c_kv, "k_rope": k_rope}
