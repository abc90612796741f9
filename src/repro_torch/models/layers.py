"""Shared neural-net building blocks (pure-functional, dict params).

Port of ``repro/models/layers.py``.  Params are plain dicts of tensors; the
``*_init`` helpers draw from a ``torch.Generator`` on the device they are
given (the generator must live on that device) with the JAX package's
scales.  JAX's PRNG is not reproduced: tests convert the JAX package's params
instead (:func:`repro_torch.convert.lm_params_from_numpy`).  Compute dtype
is bf16 by default; the init helpers return f32 and the model stores each
matmul weight in its compute dtype (see :mod:`.transformer`).

Row gathers go through :func:`take_rows` and :func:`vocab_lookup`: plain
indexing on plain tensors, ``local_map`` regions on DTensors (an indexed
gather has no sharding rule that holds across PyTorch versions).
"""
from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Sequence

import torch
import torch.nn.functional as F

from ..device import DeviceLike, resolve_device
from ..distributed.sharding import axis_rank

__all__ = [
    "Params",
    "cross_entropy",
    "dense",
    "dense_init",
    "embedding_init",
    "layernorm",
    "layernorm_init",
    "mlp",
    "mlp_init",
    "normal",
    "rmsnorm",
    "rmsnorm_init",
    "rope",
    "stack",
    "swiglu",
    "swiglu_init",
    "take_rows",
    "unstack",
    "vocab_lookup",
]

Params = Dict[str, torch.Tensor]


def normal(
    generator: torch.Generator,
    shape: Sequence[int],
    scale: float,
    device: DeviceLike = None,
    dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """``normal(shape) * scale`` drawn in f32, then cast to ``dtype`` (the
    rounding the JAX package applies at each use, done once)."""
    dev = resolve_device(device)
    x = torch.randn(tuple(shape), generator=generator, device=dev, dtype=torch.float32)
    return x.mul_(scale).to(dtype)


def dense_init(
    generator: torch.Generator, d_in: int, d_out: int, scale: Optional[float] = None,
    device: DeviceLike = None,
) -> Params:
    if scale is None:
        scale = 1.0 / math.sqrt(d_in)
    return {"w": normal(generator, (d_in, d_out), scale, device)}


def dense(p: Params, x: torch.Tensor, dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    return x.to(dtype) @ p["w"].to(dtype)


def rmsnorm_init(d: int, device: DeviceLike = None) -> Params:
    return {"g": torch.ones(d, dtype=torch.float32, device=resolve_device(device))}


def rmsnorm(p: Params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return ((xf * torch.rsqrt(var + eps)) * p["g"]).to(dt)


def layernorm_init(d: int, device: DeviceLike = None) -> Params:
    dev = resolve_device(device)
    return {"g": torch.ones(d, dtype=torch.float32, device=dev),
            "b": torch.zeros(d, dtype=torch.float32, device=dev)}


def layernorm(p: Params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(dim=-1, keepdim=True)
    return ((xf - mu) * torch.rsqrt(var + eps) * p["g"] + p["b"]).to(dt)


def mlp_init(generator: torch.Generator, dims: Sequence[int], device: DeviceLike = None) -> Params:
    dev = resolve_device(device)
    p: Params = {}
    for i, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
        p[f"w{i}"] = normal(generator, (a, b), 1.0 / math.sqrt(a), dev)
        p[f"b{i}"] = torch.zeros(b, dtype=torch.float32, device=dev)
    return p


def mlp(
    p: Params, x: torch.Tensor, act: Callable = F.silu, final_act: bool = False,
    dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    n = len([k for k in p if k.startswith("w")])
    h = x.to(dtype)
    for i in range(n):
        h = h @ p[f"w{i}"].to(dtype) + p[f"b{i}"].to(dtype)
        if i < n - 1 or final_act:
            h = act(h)
    return h


def stack(trees: Sequence) -> Params:
    """Trees of one structure as one tree, each leaf stacked on a new
    leading axis (``jax.vmap`` of an init over layer keys)."""
    if isinstance(trees[0], dict):
        return {k: stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(list(trees))


def unstack(tree, n: int) -> List[Params]:
    """The ``n`` layers of a tree stacked on a leading ``[n, ...]`` axis,
    each leaf unbound once (a backward pass then stacks each leaf's
    gradients in one op; indexing a layer out of the stack would make a
    full-size zero gradient a layer)."""
    if isinstance(tree, dict):
        subs = {k: unstack(v, n) for k, v in tree.items()}
        return [{k: sub[i] for k, sub in subs.items()} for i in range(n)]
    return list(tree.unbind(0))


def swiglu_init(generator: torch.Generator, d: int, d_ff: int, device: DeviceLike = None) -> Params:
    s = 1.0 / math.sqrt(d)
    return {
        "w_gate": normal(generator, (d, d_ff), s, device),
        "w_up": normal(generator, (d, d_ff), s, device),
        "w_down": normal(generator, (d_ff, d), 1.0 / math.sqrt(d_ff), device),
    }


def swiglu(p: Params, x: torch.Tensor, dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    xd = x.to(dtype)
    g = F.silu(xd @ p["w_gate"].to(dtype))
    u = xd @ p["w_up"].to(dtype)
    return (g * u) @ p["w_down"].to(dtype)


def embedding_init(
    generator: torch.Generator, vocab: int, d: int, scale: float = 0.02,
    device: DeviceLike = None,
) -> Params:
    return {"table": normal(generator, (vocab, d), scale, device)}


def rope(
    x: torch.Tensor,  # [..., S, D] (D even)
    positions: torch.Tensor,  # [..., S] or [S]
    base: float = 10000.0,
) -> torch.Tensor:
    """Rotary position embedding over the last dim (half-split convention);
    frequencies ``exp(-log(base) * i / half)`` in f32, as the JAX package."""
    d = x.shape[-1]
    half = d // 2
    freqs = torch.exp(
        -math.log(base) * torch.arange(half, dtype=torch.float32, device=x.device) / half
    )
    ang = positions[..., None].float() * freqs  # [..., S, half]
    while ang.dim() < x.dim():  # insert head axis: [..., 1, S, half]
        ang = ang.unsqueeze(-3)
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def cross_entropy(
    logits: torch.Tensor,  # [..., V]
    labels: torch.Tensor,  # [...]
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    lf = logits.float()
    last = lf.dim() - 1  # a non-negative dim: DTensor rules may not normalise -1
    lse = torch.logsumexp(lf, dim=last)
    gold = torch.gather(lf, last, labels[..., None].long())[..., 0]
    nll = lse - gold
    if mask is not None:
        return (nll * mask).sum() / mask.sum().clamp_min(1.0)
    return nll.mean()


def _idx_placements(idx, ndim: int, drop=()):
    """An index tensor's placements (a plain one is replicated), with the
    mesh dims in ``drop`` replicated."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    if not isinstance(idx, DTensor):
        return tuple(Replicate() for _ in range(ndim))
    return tuple(p if isinstance(p, Shard) and i not in drop else Replicate()
                 for i, p in enumerate(idx.placements))


def take_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[idx]``.  On a DTensor a ``local_map`` region: ``x`` gathered
    whole on every rank, ``idx`` in its own layout and the rows out in it;
    each rank's gradient of ``x`` is a partial sum over the mesh dims that
    split ``idx``."""
    from torch.distributed.tensor import DTensor, Partial, Replicate
    from torch.distributed.tensor.experimental import local_map

    if not isinstance(x, DTensor):
        return x[idx]
    mesh = x.device_mesh
    ipl = _idx_placements(idx, mesh.ndim)
    whole = tuple(Replicate() for _ in range(mesh.ndim))
    grad = tuple(Partial() if not isinstance(p, Replicate) else p for p in ipl)
    return local_map(lambda x_, i_: x_[i_], out_placements=(ipl,),
                     in_placements=(whole, ipl), in_grad_placements=(grad, ipl),
                     device_mesh=mesh, redistribute_inputs=True)(x, idx)


def vocab_lookup(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``table[ids]`` for an embedding table whose rows (the vocabulary) a
    mesh may shard.  On a DTensor a ``local_map`` region (the vocab-parallel
    lookup): each rank looks up the ids that fall in its rows, zero for the
    rest, and the rows out are a partial sum over the vocabulary's mesh
    dims; a table's other splits (FSDP over ``data``) are gathered first."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    if not isinstance(table, DTensor):
        return table[ids]
    mesh = table.device_mesh
    vocab = [i for i, p in enumerate(table.placements) if isinstance(p, Shard) and p.dim == 0]
    tpl = tuple(Shard(0) if i in vocab else Replicate() for i in range(mesh.ndim))
    ipl = _idx_placements(ids, mesh.ndim, drop=vocab)
    out = tuple(Partial() if i in vocab else p for i, p in enumerate(ipl))
    tgrad = tuple(Shard(0) if i in vocab else (Partial() if isinstance(p, Shard) else p)
                  for i, p in enumerate(ipl))

    v_axes = [mesh.mesh_dim_names[d] for d in vocab]

    def local(t, i):
        if not vocab:
            return t[i]
        rel = i.long() - axis_rank(mesh, v_axes) * t.shape[0]  # this rank's slice of the rows
        inside = (rel >= 0) & (rel < t.shape[0])
        rows = t[rel.clamp(0, t.shape[0] - 1)]
        keep = inside.reshape(inside.shape + (1,) * (rows.dim() - inside.dim()))
        return torch.where(keep, rows, torch.zeros((), dtype=rows.dtype, device=rows.device))

    return local_map(local, out_placements=(out,), in_placements=(tpl, ipl),
                     in_grad_placements=(tgrad, ipl), device_mesh=mesh,
                     redistribute_inputs=True)(table, ids)
