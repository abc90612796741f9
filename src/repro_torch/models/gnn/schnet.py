"""SchNet — continuous-filter convolutions (arXiv:1706.08566).

Port of ``repro/models/gnn/schnet.py``.  Interaction block:
x_i += W_post( sum_j  W_pre(x_j) * F(rbf(||r_ij||)) ) with a 300-Gaussian
radial basis over a 10 A cutoff and shifted-softplus activations (assigned
config: 3 interactions, d_hidden=64).  Params are drawn from a
``torch.Generator`` with the JAX package's scales.
"""
from __future__ import annotations

import math
from typing import Dict

import torch

from ...device import DeviceLike, resolve_device
from ..layers import Params, mlp, mlp_init, normal, take_rows
from .common import masked_segment_sum, shard_ragged

__all__ = ["schnet_init", "schnet_forward", "gaussian_rbf"]


def ssp(x):
    """Shifted softplus (SchNet's activation), softplus(x) - log 2, in the
    form log1p(expm1(x) / 2), which keeps its relative precision near 0 in
    f32 (the difference form cancels there: it is 0 at x = 1e-8, and its
    rounding there moved gradients by 4e-5 between two backends); x - log 2
    past x = 20, where softplus is x to f32 precision."""
    small = torch.log1p(torch.expm1(torch.clamp(x, max=20.0)) * 0.5)
    return torch.where(x < 20.0, small, x - math.log(2.0))


def gaussian_rbf(d: torch.Tensor, n_rbf: int, cutoff: float) -> torch.Tensor:
    """[E] distances -> [E, n_rbf] Gaussian expansion on [0, cutoff]."""
    centers = torch.linspace(0.0, cutoff, n_rbf, dtype=d.dtype, device=d.device)
    gamma = n_rbf / cutoff
    return torch.exp(-gamma * (d[:, None] - centers[None, :]) ** 2)


def cosine_cutoff(d: torch.Tensor, cutoff: float) -> torch.Tensor:
    return torch.where(d < cutoff, 0.5 * (torch.cos(math.pi * d / cutoff) + 1.0),
                       d.new_zeros(()))


def schnet_init(
    generator: torch.Generator, n_species: int, d_hidden: int, n_interactions: int,
    n_rbf: int, device: DeviceLike = None,
) -> Params:
    dev = resolve_device(device)
    p: Params = {"embed": normal(generator, (n_species, d_hidden), 0.1, dev)}
    for i in range(n_interactions):
        p[f"filter{i}"] = mlp_init(generator, (n_rbf, d_hidden, d_hidden), dev)
        p[f"pre{i}"] = mlp_init(generator, (d_hidden, d_hidden), dev)
        p[f"post{i}"] = mlp_init(generator, (d_hidden, d_hidden, d_hidden), dev)
    p["out"] = mlp_init(generator, (d_hidden, d_hidden // 2, 1), dev)
    return p


def schnet_forward(
    p: Params,
    batch: Dict[str, torch.Tensor],
    n_interactions: int,
    n_rbf: int,
    cutoff: float,
    dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """Returns per-node scalar contributions [N, 1] (sum-readout = energy)."""
    x = batch["x"]
    if x.dim() == 2:  # one-hot species given
        h = x.to(dtype) @ p["embed"].to(dtype)
    else:
        h = take_rows(p["embed"].to(dtype), x.long())
    pos = batch["pos"].to(dtype)
    src, dst = batch["edge_src"].long(), batch["edge_dst"].long()
    emask = batch.get("edge_mask")
    n = h.shape[0]
    d = torch.sqrt(((take_rows(pos, dst) - take_rows(pos, src)) ** 2).sum(-1) + 1e-12)
    rbf = gaussian_rbf(d, n_rbf, cutoff)
    env = cosine_cutoff(d, cutoff)[:, None]
    for i in range(n_interactions):
        w = mlp(p[f"filter{i}"], rbf, act=ssp, final_act=True, dtype=dtype) * env
        msg = shard_ragged(take_rows(mlp(p[f"pre{i}"], h, act=ssp, dtype=dtype), src) * w)
        agg = masked_segment_sum(msg, dst, n, emask)
        h = h + mlp(p[f"post{i}"], agg, act=ssp, dtype=dtype)
    return mlp(p["out"], h, act=ssp, dtype=dtype)
