"""deepseek-v2-lite-16b [moe]: 27L d_model=2048 16H MLA(kv_lora=512)
vocab=102400, MoE: 64 routed experts top-6 + 2 shared, d_ff_expert=1408
[arXiv:2405.04434; hf].  The values of the JAX package's config; as there,
every layer is MoE (the published V2-Lite's first layer is dense)."""

from ..models.transformer import LMConfig
from .base import LMArch

ARCH = LMArch(
    name="deepseek-v2-lite-16b",
    cfg=LMConfig(
        name="deepseek-v2-lite-16b",
        n_layers=27,
        d_model=2048,
        n_heads=16,
        n_kv_heads=16,
        d_ff=0,
        vocab_size=102400,
        moe=True,
        n_experts=64,
        n_shared_experts=2,
        top_k=6,
        d_ff_expert=1408,
        mla=True,
        kv_lora_rank=512,
        qk_nope_dim=128,
        qk_rope_dim=64,
        v_head_dim=128,
    ),
    smoke_cfg=LMConfig(
        name="deepseek-smoke",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        d_ff=0,
        vocab_size=512,
        moe=True,
        n_experts=8,
        n_shared_experts=1,
        top_k=2,
        d_ff_expert=32,
        mla=True,
        kv_lora_rank=32,
        qk_nope_dim=16,
        qk_rope_dim=8,
        v_head_dim=16,
        remat=False,
    ),
    sub_quadratic=False,  # MLA is still full attention
    ep_divisible=True,  # 64 % 16 == 0
)
