"""Decoder-only LM assembled from the MLA and MoE/SwiGLU blocks.

Port of ``repro/models/transformer.py`` for inference: ``LMConfig``,
``init_params``, ``forward``, ``prefill`` and ``decode``.  Per-layer params
are stacked on a leading ``[L, ...]`` axis as in the JAX package, and the
layers run as a Python loop (inference needs neither ``scan`` nor remat).
Training (``train_loss``, ``chunked_ce_loss``, ``hidden_forward``) waits for
the training slice, and the dense/GQA attention branch (``_gqa_*_window``)
for the dense-LM slice: a config without MLA raises.

Weights at rest: the JAX package keeps params in f32 and casts each matmul
weight to ``cfg.dtype`` at use; the port stores those weights (attention
projections, experts, shared experts, embedding table) in ``cfg.dtype``
once, which rounds the same, and keeps f32 what the reference uses in f32
(router, norm gains, ``kv_norm``).  At ``deepseek-v2-lite-16b``'s full width
that is 32 GB of bf16 instead of 64 GB of f32.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import torch

from ..device import DeviceLike, resolve_device
from .attention import mla_decode, mla_forward, mla_init
from .layers import Params, embedding_init, rmsnorm, rmsnorm_init, swiglu, swiglu_init
from .moe import moe_forward, moe_init

__all__ = [
    "LMConfig",
    "decode",
    "forward",
    "init_params",
    "prefill",
    "require_mla",
]


@dataclasses.dataclass(frozen=True)
class LMConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None
    # MoE
    moe: bool = False
    n_experts: int = 0
    n_experts_active: Optional[int] = None  # < n_experts when padded for EP
    n_shared_experts: int = 0
    top_k: int = 0
    d_ff_expert: int = 0
    capacity_factor: float = 1.25
    # MLA
    mla: bool = False
    kv_lora_rank: int = 0
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128
    # attention pattern
    sliding_window: Optional[int] = None  # window for local layers
    local_global_ratio: int = 0  # N local : 1 global; 0 = all global
    qk_norm: bool = False
    rope_base: float = 10000.0
    tie_embeddings: bool = True
    dtype: torch.dtype = torch.bfloat16

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    def param_count(self) -> int:
        """Analytic parameter count."""
        d, hd = self.d_model, self.hd
        if self.mla:
            attn = d * self.n_heads * (self.qk_nope_dim + self.qk_rope_dim)
            attn += d * self.kv_lora_rank + d * self.qk_rope_dim
            attn += self.kv_lora_rank * self.n_heads * (self.qk_nope_dim + self.v_head_dim)
            attn += self.n_heads * self.v_head_dim * d
        else:
            attn = d * self.n_heads * hd + 2 * d * self.n_kv_heads * hd
            attn += self.n_heads * hd * d
        if self.moe:
            ffn = 3 * d * self.d_ff_expert * self.n_experts + d * self.n_experts
            ffn += 3 * d * (self.d_ff_expert * self.n_shared_experts)
        else:
            ffn = 3 * d * self.d_ff
        emb = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        return self.n_layers * (attn + ffn + 2 * d) + emb + d

    def active_param_count(self) -> int:
        """Params touched per token (MoE: routed top-k + shared only)."""
        if not self.moe:
            return self.param_count()
        d = self.d_model
        routed_all = 3 * d * self.d_ff_expert * self.n_experts
        routed_active = 3 * d * self.d_ff_expert * self.top_k
        return self.param_count() - self.n_layers * (routed_all - routed_active)


def require_mla(cfg: LMConfig) -> None:
    """Raise for a config the port cannot run yet (no MLA)."""
    if not cfg.mla:
        raise NotImplementedError(
            f"{cfg.name}: only MLA configs are ported; the dense/GQA attention branch "
            "(_gqa_*_window, layer_windows) waits for ROADMAP.md slice F's dense-LM item"
        )


def _tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of nested dicts (``rest`` shaped like ``tree``)."""
    if isinstance(tree, dict):
        return {key: _tree_map(fn, tree[key], *(r[key] for r in rest)) for key in tree}
    return fn(tree, *rest)


# ---------------------------------------------------------------- parameters
def _layer_init(generator: torch.Generator, cfg: LMConfig, device: torch.device) -> Params:
    dt = cfg.dtype
    attn = mla_init(
        generator, cfg.d_model, cfg.n_heads, cfg.kv_lora_rank,
        cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim, device=device, dtype=dt,
    )
    if cfg.moe:
        ffn = moe_init(
            generator, cfg.d_model, cfg.d_ff_expert, cfg.n_experts,
            cfg.n_shared_experts, device=device, dtype=dt,
        )
    else:
        ffn = _tree_map(lambda w: w.to(dt), swiglu_init(generator, cfg.d_model, cfg.d_ff, device))
    return {
        "attn": attn,
        "ffn": ffn,
        "ln1": rmsnorm_init(cfg.d_model, device),
        "ln2": rmsnorm_init(cfg.d_model, device),
    }


def init_params(
    cfg: LMConfig, generator: torch.Generator, device: DeviceLike = None
) -> Params:
    """Random params with the JAX package's scales, drawn on ``device`` from
    ``generator`` (which must live there), one layer at a time so the f32
    draws stay one tensor wide; weights at rest as the module docstring says."""
    require_mla(cfg)
    dev = resolve_device(device)
    embed = embedding_init(generator, cfg.vocab_size, cfg.d_model, device=dev)
    embed["table"] = embed["table"].to(cfg.dtype)
    stacked = None
    for i in range(cfg.n_layers):
        lp = _layer_init(generator, cfg, dev)
        if stacked is None:
            stacked = _tree_map(
                lambda a: torch.empty((cfg.n_layers, *a.shape), dtype=a.dtype, device=dev), lp
            )
        _tree_map(lambda dst, src: dst[i].copy_(src), stacked, lp)
        del lp
    p: Params = {"embed": embed, "layers": stacked, "ln_f": rmsnorm_init(cfg.d_model, dev)}
    if not cfg.tie_embeddings:
        unembed = embedding_init(generator, cfg.vocab_size, cfg.d_model, device=dev)
        p["unembed"] = {"table": unembed["table"].to(cfg.dtype)}
    return p


def _layer(params: Params, i: int) -> Params:
    return _tree_map(lambda a: a[i], params["layers"])


def _unembed(params: Params, cfg: LMConfig) -> torch.Tensor:
    return params.get("unembed", params["embed"])["table"].to(cfg.dtype)


# ------------------------------------------------------------------- forward
def _block(
    lp: Params, x: torch.Tensor, positions: torch.Tensor, cfg: LMConfig
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor], torch.Tensor]:
    h = rmsnorm(lp["ln1"], x)
    a, cache = mla_forward(
        lp["attn"], h, positions, cfg.n_heads,
        cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim, dtype=cfg.dtype,
    )
    x = x + a
    h = rmsnorm(lp["ln2"], x)
    aux_loss = torch.zeros((), dtype=torch.float32, device=x.device)
    if cfg.moe:
        f, aux = moe_forward(
            lp["ffn"], h, cfg.top_k, cfg.capacity_factor, cfg.dtype,
            n_active=cfg.n_experts_active,
        )
        aux_loss = aux["aux_loss"]
    else:
        f = swiglu(lp["ffn"], h, cfg.dtype)
    return x + f, cache, aux_loss


def forward(
    params: Params,
    tokens: torch.Tensor,  # [B, S]
    cfg: LMConfig,
    collect_cache: bool = False,
) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]], torch.Tensor]:
    """Returns (logits [B, S, V], caches stacked [L, ...] or None, aux loss)."""
    require_mla(cfg)
    s = tokens.shape[1]
    x = params["embed"]["table"].to(cfg.dtype)[tokens]
    positions = torch.arange(s, device=x.device)
    caches, auxes = [], []
    for i in range(cfg.n_layers):
        x, cache, aux = _block(_layer(params, i), x, positions, cfg)
        if collect_cache:
            caches.append(cache)
        auxes.append(aux)
    x = rmsnorm(params["ln_f"], x)
    logits = x @ _unembed(params, cfg).T
    stacked = (
        {k: torch.stack([c[k] for c in caches]) for k in caches[0]} if collect_cache else None
    )
    return logits, stacked, torch.stack(auxes).sum()


def prefill(params: Params, tokens: torch.Tensor, cfg: LMConfig):
    """Serving prefill: forward + stacked KV caches + last-position logits."""
    logits, caches, _ = forward(params, tokens, cfg, collect_cache=True)
    return logits[:, -1], caches


def decode(
    params: Params,
    token: torch.Tensor,  # [B] current token ids
    caches: Dict[str, torch.Tensor],  # stacked over layers: [L, B, Smax, ...]
    position: torch.Tensor,  # [B]
    cfg: LMConfig,
):
    """One-token serve step over stacked caches, which it updates in place.
    Returns (logits [B, V], caches)."""
    require_mla(cfg)
    x = params["embed"]["table"].to(cfg.dtype)[token][:, None]  # [B,1,d]
    for i in range(cfg.n_layers):
        lp = _layer(params, i)
        h = rmsnorm(lp["ln1"], x)
        a, _ = mla_decode(
            lp["attn"], h, {k: c[i] for k, c in caches.items()}, position, cfg.n_heads,
            cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim, dtype=cfg.dtype,
        )
        x = x + a
        h = rmsnorm(lp["ln2"], x)
        if cfg.moe:
            f, _ = moe_forward(lp["ffn"], h, cfg.top_k, cfg.capacity_factor, cfg.dtype)
        else:
            f = swiglu(lp["ffn"], h, cfg.dtype)
        x = x + f
    x = rmsnorm(params["ln_f"], x)
    logits = (x @ _unembed(params, cfg).T)[:, 0]
    return logits, caches
