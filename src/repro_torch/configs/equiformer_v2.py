"""equiformer-v2 [gnn]: 12 layers, d_hidden=128, l_max=6, m_max=2, 8 heads,
SO(2)-eSCN convolutions [arXiv:2306.12059].  Huge-edge shapes run the
edge-chunked online-softmax path.  The values of the JAX package's config."""
import dataclasses

from ..models.gnn.equiformer_v2 import EqV2Spec, eqv2_forward, eqv2_init
from .base import GNNArch

_FULL = EqV2Spec(n_layers=12, channels=128, l_max=6, m_max=2, n_heads=8, n_rbf=32)
_SMOKE = EqV2Spec(n_layers=2, channels=8, l_max=2, m_max=1, n_heads=2, n_rbf=8)

# edge chunking per shape: chunks chosen so each chunk is ~2M edges
_CHUNKS = {"ogb_products": 28, "minibatch_lg": 1, "full_graph_sm": 1, "molecule": 1}


def _spec(full, d_in, depth=None):
    spec = dataclasses.replace(_FULL if full else _SMOKE, n_species=d_in)
    return spec if depth is None else dataclasses.replace(spec, n_layers=depth)


def _chunks(shape_name, n_edges):
    """``_CHUNKS``' count for the shape, lowered until the edges split into
    chunks of a multiple of 512."""
    chunks = _CHUNKS.get(shape_name or "", 1)
    while chunks > 1 and (n_edges % chunks or (n_edges // chunks) % 512):
        chunks -= 1
    return chunks


def _variant(depth):
    def init_fn(generator, d_in, d_out, full, device=None):
        return eqv2_init(generator, _spec(full, d_in, depth), d_out, device)

    def forward_fn(params, batch, full, shape_name=None):
        d_in = batch["x"].shape[-1] if batch["x"].dim() == 2 else 32
        return eqv2_forward(params, batch, _spec(full, d_in, depth),
                            edge_chunks=_chunks(shape_name, batch["edge_src"].shape[0]))

    return init_fn, forward_fn


_init, _forward = _variant(None)

ARCH = GNNArch(
    "equiformer-v2",
    _init,
    _forward,
    flops_correction=(("ogb_products", 28.0),),
    variant_builder=_variant,
    depth_full=_FULL.n_layers,
)
