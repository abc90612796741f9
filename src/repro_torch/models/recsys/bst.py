"""BST — Behavior Sequence Transformer for CTR (Alibaba, arXiv:1905.06874).

Port of ``repro/models/recsys/bst.py``.  The user's behavior sequence
(item + category embeddings + learned position) and the target item pass
through the transformer; outputs concat into the MLP and a CTR logit.
``retrieval_score`` scores one user state against N candidates as a single
batched dot product; ``bst_loss`` is the training loss, the mean logistic
loss of the CTR logits (the JAX package's ``RecsysArch.loss_fn``).

Params stay f32 at rest, as in the JAX package, and every use casts to the
compute dtype.  Lookups are plain row gathers (``embedding.lookup``); no
kernel runs here.  The transformer's GELU is the tanh form (JAX's
``jax.nn.gelu`` default).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from ...device import DeviceLike, resolve_device
from ..attention import _merge_heads, _split_heads
from ..layers import Params, layernorm, layernorm_init, mlp, mlp_init, normal
from .embedding import lookup, table_init

__all__ = [
    "BSTSpec", "bst_forward", "bst_init", "bst_loss", "bst_user_state", "retrieval_score",
]


@dataclasses.dataclass(frozen=True)
class BSTSpec:
    n_items: int = 4_000_000
    n_cats: int = 10_000
    embed_dim: int = 32
    seq_len: int = 20
    n_blocks: int = 1
    n_heads: int = 8
    mlp_dims: Tuple[int, ...] = (1024, 512, 256)
    dropout: float = 0.0  # inference default

    @property
    def d_tok(self) -> int:
        return 2 * self.embed_dim  # item ++ category


def bst_init(generator: torch.Generator, spec: BSTSpec, device: DeviceLike = None) -> Params:
    """Random params with the JAX package's scales, f32, drawn on
    ``device`` from ``generator`` (which must live there)."""
    dev = resolve_device(device)
    d = spec.d_tok
    p: Params = {
        "item_table": table_init(generator, spec.n_items, spec.embed_dim, device=dev),
        "cat_table": table_init(generator, spec.n_cats, spec.embed_dim, device=dev),
        "pos_embed": normal(generator, (spec.seq_len + 1, d), 0.02, dev),
    }
    s = 1.0 / math.sqrt(d)
    for i in range(spec.n_blocks):
        p[f"blk{i}"] = {
            "wqkv": normal(generator, (d, 3 * d), s, dev),
            "wo": normal(generator, (d, d), s, dev),
            "ffn": mlp_init(generator, (d, 4 * d, d), dev),
            "ln1": layernorm_init(d, dev),
            "ln2": layernorm_init(d, dev),
        }
    p["head"] = mlp_init(generator, ((spec.seq_len + 1) * d,) + spec.mlp_dims + (1,), dev)
    return p


def _gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


def _encode_seq(p: Params, batch: Dict[str, torch.Tensor], spec: BSTSpec,
                dtype: torch.dtype) -> torch.Tensor:
    """[B, L+1, 2*embed] token matrix: history ++ target, with positions."""
    hi = lookup(p["item_table"], batch["hist_items"], dtype)  # [B, L, e]
    hc = lookup(p["cat_table"], batch["hist_cats"], dtype)
    ti = lookup(p["item_table"], batch["target_item"], dtype)  # [B, e]
    tc = lookup(p["cat_table"], batch["target_cat"], dtype)
    hist = torch.cat([hi, hc], dim=-1)  # [B, L, d]
    targ = torch.cat([ti, tc], dim=-1)[:, None]  # [B, 1, d]
    x = torch.cat([hist, targ], dim=1)  # [B, L+1, d]
    return x + p["pos_embed"].to(dtype)[None]


def _transformer(p: Params, x: torch.Tensor, spec: BSTSpec, dtype: torch.dtype) -> torch.Tensor:
    for i in range(spec.n_blocks):
        blk = p[f"blk{i}"]
        h = layernorm(blk["ln1"], x)
        qkv = h.to(dtype) @ blk["wqkv"].to(dtype)
        q, k, v = (_split_heads(t, spec.n_heads) for t in qkv.chunk(3, dim=-1))
        s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * (q.shape[-1] ** -0.5)
        a = torch.softmax(s, dim=-1)
        o = torch.einsum("bhqk,bhkd->bhqd", a, v.float()).to(dtype)
        x = x + _merge_heads(o) @ blk["wo"].to(dtype)
        h = layernorm(blk["ln2"], x)
        x = x + mlp(blk["ffn"], h, act=_gelu, dtype=dtype)
    return x


def bst_forward(
    p: Params, batch: Dict[str, torch.Tensor], spec: BSTSpec,
    dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    """CTR logits [B], f32."""
    x = _encode_seq(p, batch, spec, dtype)
    x = _transformer(p, x, spec, dtype)
    flat = x.reshape(x.shape[0], -1)
    return mlp(p["head"], flat, act=F.relu, dtype=dtype)[:, 0].float()


def bst_loss(
    p: Params, batch: Dict[str, torch.Tensor], spec: BSTSpec,
    dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    """Mean binary cross-entropy of the CTR logits against ``batch["label"]``
    in the stable form ``max(z, 0) - z * y + log1p(exp(-|z|))``, f32."""
    z = bst_forward(p, batch, spec, dtype)
    y = batch["label"]
    return (torch.clamp(z, min=0) - z * y + torch.log1p(torch.exp(-z.abs()))).mean()


def bst_user_state(
    p: Params, batch: Dict[str, torch.Tensor], spec: BSTSpec,
    dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    """User embedding for retrieval: mean-pooled transformer output over the
    history tokens, cut to embed_dim (the item table's geometry)."""
    hi = lookup(p["item_table"], batch["hist_items"], dtype)
    hc = lookup(p["cat_table"], batch["hist_cats"], dtype)
    hist = torch.cat([hi, hc], dim=-1) + p["pos_embed"].to(dtype)[None, :-1]
    x = _transformer(p, hist, spec, dtype)
    u = x.mean(dim=1)  # [B, d_tok]
    return u[..., : spec.embed_dim]


def retrieval_score(
    p: Params,
    user: torch.Tensor,  # [B, embed_dim]
    cand_ids: torch.Tensor,  # [B, N] candidate item ids
    dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    """Batched dot-product scoring of N candidates per user (no loop), f32."""
    cand = lookup(p["item_table"], cand_ids, dtype)  # [B, N, e]
    return torch.einsum("be,bne->bn", user.float(), cand.float())
