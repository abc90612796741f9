"""yi-6b [dense]: 32L d_model=4096 32H (GQA kv=4) d_ff=11008 vocab=64000,
llama-arch GQA [arXiv:2403.04652; hf].  The values of the JAX package's
config."""
from ..models.transformer import LMConfig
from .base import LMArch

ARCH = LMArch(
    name="yi-6b",
    cfg=LMConfig(
        name="yi-6b",
        n_layers=32,
        d_model=4096,
        n_heads=32,
        n_kv_heads=4,
        d_ff=11008,
        vocab_size=64000,
        head_dim=128,
    ),
    smoke_cfg=LMConfig(
        name="yi-smoke",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        d_ff=128,
        vocab_size=512,
        remat=False,
    ),
    sub_quadratic=False,
)
