"""Jamba 1.5 Large 398B — Mamba+attention 1:7 interleave, MoE 16e top-2
[arXiv:2403.19887]."""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="jamba-1.5-large-398b",
        family="hybrid",
        n_layers=72,
        d_model=8192,
        n_heads=64,
        n_kv_heads=8,
        d_ff=24_576,
        vocab_size=65_536,
        head_dim=128,
        n_experts=16,
        experts_per_token=2,
        moe_period=2,  # MoE every other layer (jamba pattern)
        attn_period=8,  # 1 attention layer per 8 (1:7 mamba:attn)
        attn_offset=4,
        ssm_state=16,
        ssm_expand=2,
        ssm_conv=4,
        citation="arXiv:2403.19887",
    )
)
