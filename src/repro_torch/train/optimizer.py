"""AdamW + schedules as transforms of dict-of-tensor trees (no torch.optim).

Port of ``repro/train/optimizer.py``.  The state mirrors the params: f32
first and second moments per leaf and ``step``, a 0-d int32 tensor, so a
checkpoint of either package restores in the other.  The schedule and the
bias corrections are taken in f32 (``b1 ** step`` with ``step`` cast to
f32), as the JAX package takes them, and the update runs under
``torch.no_grad``: it returns new trees and leaves its inputs as they were.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, List, Tuple

import torch

__all__ = [
    "OptConfig", "adamw_init", "adamw_update", "cosine_lr", "global_norm", "tree_leaves",
    "tree_map", "tree_paths",
]


@dataclasses.dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of nested dicts (``rest`` shaped like ``tree``)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    return fn(tree, *rest)


def tree_paths(tree: Any, prefix: str = ""):
    """(``"/"``-joined key, leaf) pairs of nested dicts, keys sorted at
    every level: the JAX package's leaf order and its checkpoint keys."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from tree_paths(tree[k], f"{prefix}{k}/")
    else:
        yield prefix[:-1], tree


def tree_leaves(tree: Any) -> List[torch.Tensor]:
    """Leaves in the JAX package's order."""
    return [leaf for _, leaf in tree_paths(tree)]


def adamw_init(params: Any) -> Dict[str, Any]:
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device)  # noqa: E731
    leaf = tree_leaves(params)[0]
    return {"mu": tree_map(zeros, params), "nu": tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=leaf.device)}


def cosine_lr(step: torch.Tensor, cfg: OptConfig) -> torch.Tensor:
    """Linear warm-up to ``cfg.lr``, then a cosine decay to 0 at
    ``total_steps``; f32."""
    s = step.to(torch.float32)
    warm = torch.clamp(s / max(cfg.warmup_steps, 1), max=1.0)
    t = torch.clamp((s - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1),
                    0.0, 1.0)
    return cfg.lr * warm * 0.5 * (1.0 + torch.cos(math.pi * t))


def global_norm(tree: Any) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf in f32, leaf by leaf in the
    JAX package's order."""
    total = None
    for leaf in tree_leaves(tree):
        sq = (leaf.to(torch.float32) ** 2).sum()
        total = sq if total is None else total + sq
    return torch.sqrt(total)


@torch.no_grad()
def adamw_update(
    grads: Any, state: Dict[str, Any], params: Any, cfg: OptConfig
) -> Tuple[Any, Dict[str, Any], Dict[str, torch.Tensor]]:
    """One clipped AdamW step: ``(new params, new state, {"grad_norm", "lr"})``.
    Each param keeps its dtype; the arithmetic is f32."""
    step = state["step"] + 1
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
    lr = cosine_lr(step, cfg)
    b1, b2 = cfg.b1, cfg.b2
    sf = step.to(torch.float32)
    c1 = 1 - torch.pow(torch.full_like(sf, b1), sf)
    c2 = 1 - torch.pow(torch.full_like(sf, b2), sf)

    def upd(g, mu, nu, p):
        g = g.to(torch.float32) * scale
        mu2 = b1 * mu + (1 - b1) * g
        nu2 = b2 * nu + (1 - b2) * g * g
        delta = (mu2 / c1) / (torch.sqrt(nu2 / c2) + cfg.eps) + cfg.weight_decay * p
        return (p - lr * delta).to(p.dtype), mu2, nu2

    out = tree_map(upd, grads, state["mu"], state["nu"], params)
    pick = lambda i: tree_map(lambda t: t[i], out)  # noqa: E731
    return pick(0), {"mu": pick(1), "nu": pick(2), "step": step}, {"grad_norm": gnorm, "lr": lr}
