"""bst [recsys]: Behavior Sequence Transformer [arXiv:1905.06874]:
embed_dim=32, seq_len=20, 1 block, 8 heads, MLP 1024-512-256.
Item vocab 2^22 (4.2M rows).  The values of the JAX package's config."""
from ..models.recsys.bst import BSTSpec
from .base import RecsysArch

ARCH = RecsysArch(
    "bst",
    spec=BSTSpec(
        n_items=1 << 22,
        n_cats=16384,
        embed_dim=32,
        seq_len=20,
        n_blocks=1,
        n_heads=8,
        mlp_dims=(1024, 512, 256),
    ),
    smoke_spec=BSTSpec(
        n_items=1024, n_cats=64, embed_dim=16, seq_len=8, n_blocks=1,
        n_heads=2, mlp_dims=(32, 16),
    ),
)
