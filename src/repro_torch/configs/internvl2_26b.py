"""InternVL2 26B — InternViT + InternLM2 backbone [arXiv:2404.16821].

LLM backbone only; the InternViT vision encoder + MLP projector is a stub
frontend delivering precomputed patch embeddings (assignment carve-out).
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="internvl2-26b",
        family="vlm",
        n_layers=48,
        d_model=6144,
        n_heads=48,
        n_kv_heads=8,
        d_ff=16_384,
        vocab_size=92_553,
        head_dim=128,
        citation="arXiv:2404.16821",
    )
)
