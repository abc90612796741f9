"""granite-moe-3b-a800m [moe]: 32L d_model=1536 24H (GQA kv=8) vocab=49155
(padded to 49408 for 16-way vocab sharding), MoE 40 experts top-8,
d_ff_expert=512 [hf:ibm-granite/granite-3.0-*; hf].

The values of the JAX package's config, which pads the experts to 48 for
16-way expert sharding: the 8 dummies are masked from the router in
prefill (``n_experts_active``), not in decode (ROADMAP queue 3)."""
from ..models.transformer import LMConfig
from .base import LMArch

ARCH = LMArch(
    name="granite-moe-3b-a800m",
    cfg=LMConfig(
        name="granite-moe-3b-a800m",
        n_layers=32,
        d_model=1536,
        n_heads=24,
        n_kv_heads=8,
        d_ff=0,
        vocab_size=49408,  # 49155 padded to /256 (sharding divisibility)
        head_dim=64,
        moe=True,
        n_experts=48,  # padded; 40 active
        n_experts_active=40,
        n_shared_experts=0,
        top_k=8,
        d_ff_expert=512,
    ),
    smoke_cfg=LMConfig(
        name="granite-smoke",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        d_ff=0,
        vocab_size=512,
        head_dim=16,
        moe=True,
        n_experts=5,
        top_k=2,
        d_ff_expert=32,
        remat=False,
    ),
    sub_quadratic=False,
    ep_divisible=True,  # 48 % 16 == 0 after padding
)
