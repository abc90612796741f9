"""MeshGraphNet — encode/process/decode mesh simulator (arXiv:2010.03409).

Port of ``repro/models/gnn/meshgraphnet.py``.  15 processor steps (assigned
config), d_hidden=128, 2-layer MLPs with LayerNorm, sum aggregation,
residual node+edge updates.  The per-step params are stacked on a leading
``[n_steps, ...]`` axis as the JAX package stacks them for ``lax.scan``;
the forward unbinds the stack once and loops over the steps.
"""
from __future__ import annotations

from typing import Dict

import torch

from ...device import DeviceLike, resolve_device
from ..layers import (
    Params, layernorm, layernorm_init, mlp, mlp_init, stack, take_rows, unstack,
)
from .common import masked_segment_sum, shard_ragged

__all__ = ["mgn_init", "mgn_forward"]


def _block_init(generator: torch.Generator, dims, device: torch.device) -> Params:
    return {"mlp": mlp_init(generator, dims, device), "ln": layernorm_init(dims[-1], device)}


def _block(p, x, dtype):
    return layernorm(p["ln"], mlp(p["mlp"], x, dtype=dtype))


def mgn_init(
    generator: torch.Generator,
    d_node_in: int,
    d_edge_in: int,
    d_hidden: int,
    n_steps: int,
    d_out: int,
    mlp_layers: int = 2,
    device: DeviceLike = None,
) -> Params:
    dev = resolve_device(device)
    hid = tuple([d_hidden] * mlp_layers)
    enc_node = _block_init(generator, (d_node_in,) + hid, dev)
    enc_edge = _block_init(generator, (d_edge_in,) + hid, dev)
    steps = [{"edge": _block_init(generator, (3 * d_hidden,) + hid, dev),
              "node": _block_init(generator, (2 * d_hidden,) + hid, dev)}
             for _ in range(n_steps)]
    return {
        "enc_node": enc_node,
        "enc_edge": enc_edge,
        "steps": stack(steps),
        "dec": mlp_init(generator, (d_hidden,) + hid[:-1] + (d_out,), dev),
    }


def mgn_forward(
    p: Params, batch: Dict[str, torch.Tensor], dtype: torch.dtype = torch.float32
) -> torch.Tensor:
    """Returns per-node outputs [N, d_out]."""
    src, dst = batch["edge_src"].long(), batch["edge_dst"].long()
    emask = batch.get("edge_mask")
    n = batch["x"].shape[0]
    h = _block(p["enc_node"], batch["x"].to(dtype), dtype)
    e = _block(p["enc_edge"], batch["edge_attr"].to(dtype), dtype)
    n_steps = next(iter(p["steps"]["edge"]["ln"].values())).shape[0]
    for sp in unstack(p["steps"], n_steps):
        e = shard_ragged(e + _block(sp["edge"], torch.cat([e, take_rows(h, src), take_rows(h, dst)], -1),
                                    dtype))
        agg = masked_segment_sum(e, dst, n, emask)
        h = h + _block(sp["node"], torch.cat([h, agg], -1), dtype)
    return mlp(p["dec"], h, dtype=dtype)
