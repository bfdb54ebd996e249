"""Qwen2 7B — GQA with QKV bias [arXiv:2407.10671]."""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="qwen2-7b",
        family="dense",
        n_layers=28,
        d_model=3584,
        n_heads=28,
        n_kv_heads=4,
        d_ff=18_944,
        vocab_size=152_064,
        head_dim=128,
        qkv_bias=True,
        rope_theta=1_000_000.0,
        citation="arXiv:2407.10671",
    )
)
