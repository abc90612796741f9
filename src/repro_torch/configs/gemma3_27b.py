"""gemma3-27b [dense]: 62L d_model=5376 32H (GQA kv=16) d_ff=21504
vocab=262144, 5:1 local:global attention (sliding window 1024), 128k ctx
[hf:google/gemma-3-*; unverified].  The values of the JAX package's
config; layer i is global when i % 6 == 5 (``LMConfig.layer_windows``)."""
from ..models.transformer import LMConfig
from .base import LMArch

ARCH = LMArch(
    name="gemma3-27b",
    cfg=LMConfig(
        name="gemma3-27b",
        n_layers=62,
        d_model=5376,
        n_heads=32,
        n_kv_heads=16,
        d_ff=21504,
        vocab_size=262144,
        head_dim=128,
        sliding_window=1024,
        local_global_ratio=5,
    ),
    smoke_cfg=LMConfig(
        name="gemma3-smoke",
        n_layers=6,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        d_ff=128,
        vocab_size=512,
        sliding_window=8,
        local_global_ratio=5,
        remat=False,
    ),
    sub_quadratic=True,  # hybrid local:global
)
