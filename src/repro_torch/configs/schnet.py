"""schnet [gnn]: 3 interactions, d_hidden=64, 300 Gaussian RBFs, 10 A cutoff
[arXiv:1706.08566].  Feature graphs use x @ embed (soft species).  The
values of the JAX package's config."""
from ..models.gnn.schnet import schnet_forward, schnet_init
from ..models.layers import mlp_init
from .base import GNNArch

_FULL = dict(n_interactions=3, d_hidden=64, n_rbf=300, cutoff=10.0)
_SMOKE = dict(n_interactions=2, d_hidden=16, n_rbf=16, cutoff=5.0)


def _variant(depth):
    """(init, forward) at ``depth`` interactions (``None``: the config's)."""

    def widths(full):
        c = _FULL if full else _SMOKE
        return c if depth is None else dict(c, n_interactions=depth)

    def init_fn(generator, d_in, d_out, full, device=None):
        c = widths(full)
        p = schnet_init(generator, d_in, c["d_hidden"], c["n_interactions"], c["n_rbf"], device)
        p["out"] = mlp_init(generator, (c["d_hidden"], c["d_hidden"] // 2, d_out), device)
        return p

    def forward_fn(params, batch, full, shape_name=None):
        c = widths(full)
        return schnet_forward(params, batch, c["n_interactions"], c["n_rbf"], c["cutoff"])

    return init_fn, forward_fn


_init, _forward = _variant(None)

ARCH = GNNArch("schnet", _init, _forward)
