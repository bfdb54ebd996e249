"""Phi-4-mini 3.8B — RoPE SwiGLU GQA [arXiv:2412.08905]."""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="phi4-mini-3.8b",
        family="dense",
        n_layers=32,
        d_model=3072,
        n_heads=24,
        n_kv_heads=8,
        d_ff=8192,
        vocab_size=200_064,
        head_dim=128,
        citation="arXiv:2412.08905",
    )
)
