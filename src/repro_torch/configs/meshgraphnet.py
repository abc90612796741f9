"""meshgraphnet [gnn]: 15 processor steps, d_hidden=128, sum aggregation,
2-layer MLPs [arXiv:2010.03409].  Edge features derived from pos (rel-pos +
norm), the standard MGN encoding.  The values of the JAX package's config."""
import torch

from ..models.gnn.meshgraphnet import mgn_forward, mgn_init
from ..models.layers import take_rows
from .base import GNNArch

_FULL = dict(n_steps=15, d_hidden=128, mlp_layers=2)
_SMOKE = dict(n_steps=3, d_hidden=16, mlp_layers=2)


def _init(generator, d_in, d_out, full, device=None):
    c = _FULL if full else _SMOKE
    return mgn_init(
        generator, d_in, 4, c["d_hidden"], c["n_steps"], d_out, c["mlp_layers"], device
    )


def _forward(params, batch, full, shape_name=None):
    pos = batch["pos"].float()
    rel = take_rows(pos, batch["edge_dst"].long()) - take_rows(pos, batch["edge_src"].long())
    norm = torch.linalg.vector_norm(rel, dim=-1, keepdim=True)
    b = dict(batch, edge_attr=torch.cat([rel, norm], -1))
    # full-scale runs use bf16 messages: halves the cross-shard gather bytes
    # (collective term) at negligible accuracy cost for 2-layer MLP blocks
    return mgn_forward(params, b, dtype=torch.bfloat16 if full else torch.float32)


def _variant(depth):
    def init_fn(generator, d_in, d_out, full, device=None):
        c = _FULL if full else _SMOKE
        return mgn_init(generator, d_in, 4, c["d_hidden"], depth, d_out, c["mlp_layers"],
                        device)

    return init_fn, _forward


ARCH = GNNArch(
    "meshgraphnet", _init, _forward, variant_builder=_variant,
    depth_full=_FULL["n_steps"],
)
