"""EGNN — E(n)-equivariant GNN (Satorras et al., arXiv:2102.09844).

Port of ``repro/models/gnn/egnn.py``.  Per layer:
    m_ij  = phi_e(h_i, h_j, ||x_i - x_j||^2, a_ij)
    x_i'  = x_i + C * sum_j (x_i - x_j) * phi_x(m_ij)
    h_i'  = phi_h(h_i, sum_j m_ij)
Scalar-distance conditioning keeps full E(n) equivariance without spherical
harmonics.  4 layers, d_hidden=64 (assigned config).
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from ...device import DeviceLike, resolve_device
from ..layers import Params, mlp, mlp_init, take_rows
from .common import masked_segment_mean, masked_segment_sum, shard_ragged

__all__ = ["egnn_init", "egnn_forward"]


def egnn_init(
    generator: torch.Generator, d_in: int, d_hidden: int, n_layers: int, d_edge: int = 0,
    device: DeviceLike = None,
) -> Params:
    dev = resolve_device(device)
    p: Params = {"enc": mlp_init(generator, (d_in, d_hidden), dev)}
    for i in range(n_layers):
        p[f"phi_e{i}"] = mlp_init(generator, (2 * d_hidden + 1 + d_edge, d_hidden, d_hidden), dev)
        p[f"phi_x{i}"] = mlp_init(generator, (d_hidden, d_hidden, 1), dev)
        p[f"phi_h{i}"] = mlp_init(generator, (2 * d_hidden, d_hidden, d_hidden), dev)
    p["dec"] = mlp_init(generator, (d_hidden, d_hidden, 1), dev)
    return p


def egnn_forward(
    p: Params,
    batch: Dict[str, torch.Tensor],
    n_layers: int,
    dtype: torch.dtype = torch.float32,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (node embeddings [N, d], updated coords [N, 3])."""
    x = batch["pos"].to(dtype)
    h = mlp(p["enc"], batch["x"].to(dtype), dtype=dtype)
    src, dst = batch["edge_src"].long(), batch["edge_dst"].long()
    emask = batch.get("edge_mask")
    n = h.shape[0]
    for i in range(n_layers):
        xi, xj = take_rows(x, dst), take_rows(x, src)
        diff = xi - xj
        d2 = (diff * diff).sum(-1, keepdim=True)
        feats = [take_rows(h, dst), take_rows(h, src), d2]
        if "edge_attr" in batch:
            feats.append(batch["edge_attr"].to(dtype))
        m = shard_ragged(mlp(p[f"phi_e{i}"], torch.cat(feats, -1), dtype=dtype))
        w = mlp(p[f"phi_x{i}"], m, dtype=dtype)  # [E, 1]
        # mean-normalized coordinate update (C = 1/deg), E(n)-equivariant
        x = x + masked_segment_mean(diff * w, dst, n, emask)
        agg = masked_segment_sum(m, dst, n, emask)
        h = h + mlp(p[f"phi_h{i}"], torch.cat([h, agg], -1), dtype=dtype)
    return h, x
