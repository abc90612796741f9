"""Decoder-only LM assembled from the attention (GQA or MLA) and MoE/SwiGLU
blocks.

Port of ``repro/models/transformer.py``: ``LMConfig`` (with
``layer_windows``), ``init_params``, ``forward``, ``prefill`` and
``decode`` for serving, and ``hidden_forward``, ``chunked_ce_loss`` and
``train_loss`` (cross-entropy + 0.01 x the MoE aux loss) for training, for
every LM arch of the JAX package.  Per-layer params are stacked on a
leading ``[L, ...]`` axis as in the JAX package, and the layers run as a
Python loop; ``forward`` unbinds the stack once, so a backward pass stacks
each leaf's gradient once.  With ``cfg.remat`` and grad enabled, each layer
runs under ``torch.utils.checkpoint`` (``jax.checkpoint(_block)`` in the
JAX package): its activations are recomputed in the backward pass, so a
GQA or MLA layer launches the flash kernel twice a training step.

Per-layer windows (gemma3's 5 local : 1 global) are plain ints here: the
JAX package carries them as data through ``lax.scan``, so its GQA stack
masks with a traced window in dense einsums (``_window_attention``, chunked
past 2,048 positions by ``_chunked_dyn_window``).  The eager loop knows each
layer's window, so a GQA layer goes through ``_attend`` with that window
(``None`` on a global layer), the dispatch the JAX package's ``_attend``
takes on a TPU for a static window: the flash kernel on the card (trainable
through ``ops.attention``'s autograd Function), and on the CPU the same
masked f32 softmax as ``_window_attention`` (dense up to 2,048 positions,
chunked past them).  Decode attends in plain PyTorch (``_decode_attend``),
as MLA decode does.

Weights at rest: the JAX package keeps params in f32 and casts each matmul
weight to ``cfg.dtype`` at use.  For serving, the port stores those weights
(attention projections, experts, shared experts, embedding table) in
``cfg.dtype`` once, which rounds the same, and keeps f32 what the reference
uses in f32 (router, norm gains, ``kv_norm``): at
``deepseek-v2-lite-16b``'s full width that is 32 GB of bf16 instead of 64 GB
of f32.  Training keeps every param in f32 (``init_params(...,
at_rest=torch.float32)``), as the reference does, since AdamW's small
updates would round away on a bf16 master; the forward casts at use either
way.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Dict, List, Optional, Tuple

import torch
import torch.utils.checkpoint

from ..device import DeviceLike, resolve_device
from ..distributed.constraints import constrain, is_dtensor
from ..distributed.sharding import axis_rank, constrain_lm_layer
from .attention import (
    _DP, _attend, _gqa_qkv, _heads, _merge_heads, _write_position, gqa_init, mla_decode,
    mla_forward, mla_init,
)
from .layers import (
    Params, embedding_init, rmsnorm, rmsnorm_init, swiglu, swiglu_init, unstack, vocab_lookup,
)
from .moe import moe_forward, moe_init

__all__ = [
    "LMConfig",
    "chunked_ce_loss",
    "decode",
    "forward",
    "hidden_forward",
    "init_params",
    "prefill",
    "train_loss",
]

_GLOBAL_WINDOW = 1 << 30  # "window" that never masks = global attention


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
    remat: bool = True  # recompute each layer in the backward pass

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    def layer_windows(self) -> List[int]:
        """Per-layer attention window (gemma3 5:1 pattern; global = huge)."""
        if self.local_global_ratio <= 0 or self.sliding_window is None:
            return [self.sliding_window or _GLOBAL_WINDOW] * self.n_layers
        r = self.local_global_ratio
        return [
            self.sliding_window if (i % (r + 1)) != r else _GLOBAL_WINDOW
            for i in range(self.n_layers)
        ]

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


def _tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of nested dicts (``rest`` shaped like ``tree``)."""
    if isinstance(tree, dict):
        return {key: _tree_map(fn, tree[key], *(r[key] for r in rest)) for key in tree}
    return fn(tree, *rest)


# ---------------------------------------------------------------- parameters
def _layer_init(generator: torch.Generator, cfg: LMConfig, device: torch.device,
                dt: torch.dtype) -> Params:
    if cfg.mla:
        attn = mla_init(
            generator, cfg.d_model, cfg.n_heads, cfg.kv_lora_rank,
            cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim, device=device, dtype=dt,
        )
    else:
        attn = gqa_init(
            generator, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd, cfg.qk_norm,
            device=device, dtype=dt,
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
    cfg: LMConfig, generator: torch.Generator, device: DeviceLike = None,
    at_rest: Optional[torch.dtype] = None,
) -> Params:
    """Random params with the JAX package's scales, drawn on ``device`` from
    ``generator`` (which must live there), one layer at a time so the f32
    draws stay one tensor wide.  Matmul weights are stored in ``at_rest``
    (``cfg.dtype`` when None, for serving; ``torch.float32`` for training),
    router and norms in f32, as the module docstring says."""
    dev = resolve_device(device)
    dt = at_rest or cfg.dtype
    embed = embedding_init(generator, cfg.vocab_size, cfg.d_model, device=dev)
    embed["table"] = embed["table"].to(dt)
    stacked = None
    for i in range(cfg.n_layers):
        lp = _layer_init(generator, cfg, dev, dt)
        if stacked is None:
            stacked = _tree_map(
                lambda a: torch.empty((cfg.n_layers, *a.shape), dtype=a.dtype, device=dev), lp
            )
        _tree_map(lambda dst, src: dst[i].copy_(src), stacked, lp)
        del lp
    p: Params = {"embed": embed, "layers": stacked, "ln_f": rmsnorm_init(cfg.d_model, dev)}
    if not cfg.tie_embeddings:
        unembed = embedding_init(generator, cfg.vocab_size, cfg.d_model, device=dev)
        p["unembed"] = {"table": unembed["table"].to(dt)}
    return p


def _layer(params: Params, i: int) -> Params:
    return _tree_map(lambda a: a[i], params["layers"])


def _unembed(params: Params, cfg: LMConfig) -> torch.Tensor:
    """The unembedding table in ``cfg.dtype``, gathered over ``data`` where
    a mesh shards it (its FSDP gather), vocab still over ``model``."""
    return constrain(params.get("unembed", params["embed"])["table"].to(cfg.dtype), "model", None)


# ------------------------------------------------------------------- forward
def _block(
    lp: Params, x: torch.Tensor, positions: torch.Tensor, window: int, cfg: LMConfig
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor], torch.Tensor]:
    lp = constrain_lm_layer(lp)  # each layer's FSDP gathers where it runs
    # sequence parallelism: the residual stream (and thus every remat-saved
    # layer input) shards seq over `model`; attention/ffn re-gather locally.
    x = constrain(x, _DP, "model", None)
    h = _gathered(rmsnorm(lp["ln1"], x))
    if cfg.mla:
        a, cache = mla_forward(
            lp["attn"], h, positions, cfg.n_heads,
            cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim, dtype=cfg.dtype,
        )
    else:
        a, cache = _gqa_forward_window(lp["attn"], h, positions, window, cfg)
    x = x + _gathered(a)
    h = _gathered(rmsnorm(lp["ln2"], x))
    aux_loss = torch.zeros((), dtype=torch.float32, device=x.device)
    if cfg.moe:
        f, aux = moe_forward(
            lp["ffn"], h, cfg.top_k, cfg.capacity_factor, cfg.dtype,
            n_active=cfg.n_experts_active,
        )
        aux_loss = aux["aux_loss"]
    else:
        f = swiglu(lp["ffn"], h, cfg.dtype)
    return constrain(x + _gathered(f), _DP, "model", None), cache, aux_loss


def _gathered(h: torch.Tensor) -> torch.Tensor:
    """A ``[B, S, d]`` activation whole over the sequence: the normed
    residual before attention or the FFN, and their outputs before they
    join the sequence-sharded residual (the reference leaves these
    reshards to XLA; DTensor cannot multiply, forward or backward, a
    tensor split on two dims that the product flattens)."""
    return constrain(h, _DP, None, None)


def _gqa_forward_window(p: Params, h: torch.Tensor, positions: torch.Tensor, window: int,
                        cfg: LMConfig):
    """GQA forward of one layer with its window (``_GLOBAL_WINDOW`` on a
    global layer) through ``_attend``: the flash kernel on the card, the
    plain masked softmax on the CPU.  Returns (out, kv_cache)."""
    q, k, v = _gqa_qkv(p, h, positions, cfg.n_heads, cfg.n_kv_heads, cfg.rope_base, cfg.dtype)
    o = _attend(q, k, v, causal=True, window=None if window >= _GLOBAL_WINDOW else window)
    out = _merge_heads(_heads(o)).to(cfg.dtype) @ p["wo"].to(cfg.dtype)
    return out, {"k": k, "v": v}


def forward(
    params: Params,
    tokens: torch.Tensor,  # [B, S]
    cfg: LMConfig,
    collect_cache: bool = False,
    skip_unembed: bool = False,
) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]], torch.Tensor]:
    """Returns (logits [B, S, V], or the final-norm hidden states [B, S, d]
    with ``skip_unembed``; caches stacked [L, ...] or None; aux loss)."""
    s = tokens.shape[1]
    x = vocab_lookup(params["embed"]["table"].to(cfg.dtype), tokens)
    positions = torch.arange(s, device=x.device)
    fn = _block
    if cfg.remat and torch.is_grad_enabled():
        fn = functools.partial(torch.utils.checkpoint.checkpoint, _block, use_reentrant=False)
    caches, auxes = [], []
    layers = unstack(params["layers"], cfg.n_layers)
    for lp, w in zip(layers, cfg.layer_windows()):
        x, cache, aux = fn(lp, x, positions, w, cfg)
        if collect_cache:
            caches.append(cache)
        auxes.append(aux)
    x = rmsnorm(params["ln_f"], x)
    stacked = (
        {k: torch.stack([c[k] for c in caches]) for k in caches[0]} if collect_cache else None
    )
    if skip_unembed:
        return x, stacked, torch.stack(auxes).sum()
    logits = _gathered(x) @ _unembed(params, cfg).T
    return logits, stacked, torch.stack(auxes).sum()


def hidden_forward(params: Params, tokens: torch.Tensor, cfg: LMConfig):
    """Forward up to the final norm (no unembed); returns ([B, S, d], aux)."""
    x, _, aux = forward(params, tokens, cfg, skip_unembed=True)
    return x, aux


def chunked_ce_loss(
    x: torch.Tensor,  # [B, S, d] final hidden states
    unemb: torch.Tensor,  # [V, d]
    labels: torch.Tensor,  # [B, S]
    n_chunks: int = 16,
) -> torch.Tensor:
    """Mean cross-entropy over sequence chunks: each chunk's logits
    (``x @ unemb.T`` in x's dtype), then its f32 logsumexp and gold logit,
    summed in f32.  Without autograd no ``[B, S, V]`` f32 logits exist at
    once; under autograd each chunk's f32 logits are saved for the
    backward, so by the end of the forward all of them are alive.
    ``n_chunks`` halves until it divides S."""
    b, s, _ = x.shape
    while s % n_chunks != 0:
        n_chunks //= 2
    cs = s // n_chunks
    tot = torch.zeros((), dtype=torch.float32, device=x.device)
    for c0 in range(0, s, cs):
        logits = constrain(x[:, c0:c0 + cs] @ unemb.T, _DP, None, "model")  # [b, cs, V]
        tot = tot + _token_nll(logits, labels[:, c0:c0 + cs]).sum()
    return tot / (b * s)


def _nll(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Per-token ``logsumexp - gold logit`` in f32."""
    lf = logits.float()
    return torch.logsumexp(lf, dim=-1) - torch.gather(lf, -1, labels[..., None].long())[..., 0]


def _token_nll(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """:func:`_nll`; on DTensor logits a ``local_map`` region (the
    vocab-parallel cross-entropy): each rank takes the logsumexp of its
    vocab slice and the gold logits that fall in it, and two all-reduces
    over ``model`` (a max, then a sum of ``exp(lse_local - max)`` and of the
    gold logits) complete them.  On a one-rank axis it computes exactly
    :func:`_nll` (``log(exp(0)) = 0``)."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    from ..distributed.collectives import all_reduce_region

    if not is_dtensor(logits):
        return _nll(logits, labels)
    mesh = logits.device_mesh
    names = tuple(mesh.mesh_dim_names)
    pl = tuple(p if isinstance(p, Shard) and p.dim in (0, 2) else Replicate()
               for p in logits.placements)
    vocab = [i for i, p in enumerate(pl) if isinstance(p, Shard) and p.dim == 2]
    v_axes = [names[i] for i in vocab]
    lab_pl = tuple(Shard(0) if isinstance(p, Shard) and p.dim == 0 else Replicate() for p in pl)

    def local(lg, lab):
        lf = lg.float()
        if not v_axes:
            return _nll(lf, lab)
        v_local = lf.shape[-1]
        rel = lab.long() - axis_rank(mesh, v_axes) * v_local  # this rank's vocab slice
        inside = (rel >= 0) & (rel < v_local)
        gold = torch.gather(lf, -1, rel.clamp(0, v_local - 1)[..., None])[..., 0]
        gold = torch.where(inside, gold, torch.zeros((), dtype=gold.dtype, device=gold.device))
        lse = torch.logsumexp(lf, dim=-1)
        m = lse.detach()
        for a in v_axes:
            m = all_reduce_region(m, "max", mesh, a)
        s_exp = torch.exp(lse - m)
        for a in v_axes:
            s_exp = all_reduce_region(s_exp, "sum", mesh, a)
            gold = all_reduce_region(gold, "sum", mesh, a)
        return torch.log(s_exp) + m - gold

    region = local_map(local, out_placements=(lab_pl,), in_placements=(pl, lab_pl),
                       device_mesh=mesh, redistribute_inputs=True)
    return region(logits, labels)


def train_loss(params: Params, batch: Dict[str, torch.Tensor], cfg: LMConfig):
    """``(ce + 0.01 * aux, {"ce", "aux"})`` over ``batch["tokens"]`` and
    ``batch["labels"]`` ([B, S] each), the CE in 16 sequence chunks."""
    x, aux = hidden_forward(params, batch["tokens"], cfg)
    loss = chunked_ce_loss(x, _unembed(params, cfg), batch["labels"], 16)
    return loss + 0.01 * aux, {"ce": loss, "aux": aux}


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
    Returns (logits [B, V], caches).

    As in the JAX package, the MoE layers route without ``n_active``: at
    decode the router may pick a padded expert (ROADMAP queue 3)."""
    # the looked-up rows whole over `model` (a vocab-parallel lookup leaves
    # a partial sum): decode keeps the batch split only
    x = constrain(vocab_lookup(params["embed"]["table"].to(cfg.dtype), token), _DP, None)
    x = x[:, None]  # [B,1,d]
    for i, w in enumerate(cfg.layer_windows()):
        lp = constrain_lm_layer(_layer(params, i))
        cache = {k: c[i] for k, c in caches.items()}
        h = rmsnorm(lp["ln1"], x)
        if cfg.mla:
            a, _ = mla_decode(
                lp["attn"], h, cache, position, cfg.n_heads,
                cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim, dtype=cfg.dtype,
            )
        else:
            a = _gqa_decode_window(lp["attn"], h, cache, position, w, cfg)
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


def _gqa_decode_window(p: Params, h: torch.Tensor, cache: Dict[str, torch.Tensor],
                       position: torch.Tensor, window: int, cfg: LMConfig) -> torch.Tensor:
    """One-token GQA step of one layer: writes k and v at ``position`` into
    the layer's cache in place and attends over it, window- and
    valid-masked.  Returns the attention output ``[B, 1, d]``."""
    q, k_new, v_new = _gqa_qkv(p, h, position[:, None], cfg.n_heads, cfg.n_kv_heads,
                               cfg.rope_base, cfg.dtype)
    kc, vc = cache["k"], cache["v"]
    _write_position(kc, k_new, position)
    _write_position(vc, v_new, position)
    o = _decode_attend(q, kc, vc, position, window, cfg.n_heads // cfg.n_kv_heads,
                       cfg.hd ** -0.5)
    return _merge_heads(_heads(o)).to(cfg.dtype) @ p["wo"].to(cfg.dtype)


def _decode_attend(q, kc, vc, position: torch.Tensor, window: int, group: int, scale: float,
                   chunk: int = 8192) -> torch.Tensor:
    """One query a batch row against its cache, masked to ``position`` and
    the window: dense f32 up to ``chunk`` slots, online softmax over chunks
    past them.  Each kv head's q heads attend as one block, so the cache is
    never repeated over the group (``group`` q heads a kv head, on every
    rank of a mesh: heads and kv heads split together or not at all).

    A DTensor cache runs :func:`_decode_local` as a ``local_map`` region on
    its own placements (``_cache_spec``: batch over dp, or the sequence
    over ``data`` at long context; kv heads over ``model``, or the head
    width when the heads do not divide it); q and the output follow the
    cache's batch, head and width splits."""
    if not is_dtensor(kc):
        return _decode_local(q, kc, vc, position, window, group, scale, chunk)
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh = kc.device_mesh
    pl = tuple(kc.placements)
    seq_axes, width_axes = ([a for a, p in zip(mesh.mesh_dim_names, pl)
                             if isinstance(p, Shard) and p.dim == dim] for dim in (2, 3))
    q_pl = tuple(p if isinstance(p, Shard) and p.dim in (0, 1, 3) else Replicate() for p in pl)
    pos_pl = tuple(p if isinstance(p, Shard) and p.dim == 0 else Replicate() for p in pl)
    region = functools.partial(_decode_local, window=window, group=group, scale=scale,
                               chunk=chunk, mesh=mesh, seq_axes=seq_axes, width_axes=width_axes)
    return local_map(region, out_placements=(q_pl,), in_placements=(q_pl, pl, pl, pos_pl),
                     device_mesh=mesh, redistribute_inputs=True)(q, kc, vc, position)


def _decode_local(q, kc, vc, position, window: int, group: int, scale: float, chunk: int,
                  mesh=None, seq_axes=(), width_axes=()) -> torch.Tensor:
    """:func:`_decode_attend` on one rank's cache slice.  A width split
    over ``width_axes`` sums its partial q.k products over them; a sequence
    split over ``seq_axes`` runs the online softmax over its own slots and
    combines the running max, denominator and numerator across them (max,
    then sums), as the chunks of one slice combine.  With no axes it is
    the whole computation."""
    from ..distributed.collectives import all_reduce_region

    b, hq, _, d = q.shape
    hkv, skv = kc.shape[1], kc.shape[2]
    qg = q.float().reshape(b, hkv, group, d)
    pos = position.long()[:, None, None, None]
    p0 = axis_rank(mesh, seq_axes) * skv  # this slice's first slot

    def logits(k0: int, n: int) -> torch.Tensor:
        s = torch.einsum("bhgd,bhkd->bhgk", qg, kc[:, :, k0:k0 + n].float())
        for a in width_axes:
            s = all_reduce_region(s, "sum", mesh, a)
        s = s * scale
        k_pos = (p0 + k0 + torch.arange(n, device=q.device))[None, None, None, :]
        mask = (k_pos <= pos) & (k_pos > pos - window)
        return torch.where(mask, s, torch.full((), -1e30, device=q.device))

    def values(p_: torch.Tensor, k0: int, n: int) -> torch.Tensor:
        return torch.einsum("bhgk,bhkd->bhgd", p_, vc[:, :, k0:k0 + n].float())

    if skv <= chunk and not seq_axes:
        o = values(torch.softmax(logits(0, skv), dim=-1), 0, skv)
    else:
        n = min(chunk, skv)
        if skv % n:
            raise ValueError(f"{skv} cache slots must be a multiple of {chunk}")
        m = torch.full((b, hkv, group, 1), -1e30, dtype=torch.float32, device=q.device)
        l = torch.zeros_like(m)
        acc = torch.zeros(m.shape[:3] + (vc.shape[3],), dtype=torch.float32, device=q.device)
        for k0 in range(0, skv, n):
            s = logits(k0, n)
            m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
            p_ = torch.exp(s - m_new)
            corr = torch.exp(m - m_new)
            l = l * corr + p_.sum(dim=-1, keepdim=True)
            acc = acc * corr + values(p_, k0, n)
            m = m_new
        if seq_axes:
            m_all = m
            for a in seq_axes:
                m_all = all_reduce_region(m_all, "max", mesh, a)
            corr = torch.exp(m - m_all)
            l, acc = l * corr, acc * corr
            for a in seq_axes:
                l = all_reduce_region(l, "sum", mesh, a)
                acc = all_reduce_region(acc, "sum", mesh, a)
        o = acc / l.clamp_min(1e-30)
    return o.reshape(b, hq, 1, -1).to(q.dtype)
