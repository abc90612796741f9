"""qwen3-0.6b [dense]: 28L d_model=1024 16H (GQA kv=8) d_ff=3072
vocab=151936, qk_norm [hf:Qwen/Qwen3-*; hf].  The values of the JAX
package's config."""
from ..models.transformer import LMConfig
from .base import LMArch

ARCH = LMArch(
    name="qwen3-0.6b",
    cfg=LMConfig(
        name="qwen3-0.6b",
        n_layers=28,
        d_model=1024,
        n_heads=16,
        n_kv_heads=8,
        d_ff=3072,
        vocab_size=151936,
        head_dim=128,
        qk_norm=True,
    ),
    smoke_cfg=LMConfig(
        name="qwen3-smoke",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        d_ff=128,
        vocab_size=512,
        qk_norm=True,
        remat=False,
    ),
    sub_quadratic=False,
)
