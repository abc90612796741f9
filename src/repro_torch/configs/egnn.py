"""egnn [gnn]: 4 layers, d_hidden=64, E(n)-equivariant [arXiv:2102.09844].
The values of the JAX package's config."""
import torch

from ..device import resolve_device
from ..models.gnn.egnn import egnn_forward, egnn_init
from ..models.layers import mlp, mlp_init
from .base import GNNArch

_FULL = dict(n_layers=4, d_hidden=64)
_SMOKE = dict(n_layers=2, d_hidden=16)


def _variant(depth):
    """(init, forward) at ``depth`` layers (``None``: the config's)."""

    def widths(full):
        c = _FULL if full else _SMOKE
        return c if depth is None else dict(c, n_layers=depth)

    def init_fn(generator, d_in, d_out, full, device=None):
        c = widths(full)
        return {
            "body": egnn_init(generator, d_in, c["d_hidden"], c["n_layers"], device=device),
            "head": mlp_init(generator, (c["d_hidden"], d_out), device),
            # static marker, a leaf as in the JAX package (checkpoints cross)
            "_n_layers": torch.zeros((c["n_layers"],), device=resolve_device(device)),
        }

    def forward_fn(params, batch, full, shape_name=None):
        h, _ = egnn_forward(params["body"], batch, widths(full)["n_layers"])
        return mlp(params["head"], h, dtype=torch.float32)

    return init_fn, forward_fn


_init, _forward = _variant(None)

ARCH = GNNArch("egnn", _init, _forward)
