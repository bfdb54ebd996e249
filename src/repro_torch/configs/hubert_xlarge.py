"""HuBERT X-Large — encoder-only audio transformer [arXiv:2106.07447].

Backbone only; the mel-spectrogram + conv feature extractor is a stub frontend
delivering precomputed frame embeddings (assignment carve-out).
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="hubert-xlarge",
        family="audio",
        n_layers=48,
        d_model=1280,
        n_heads=16,
        n_kv_heads=16,
        d_ff=5120,
        vocab_size=504,
        head_dim=80,
        causal=False,  # encoder-only
        frontend="audio_frames",
        citation="arXiv:2106.07447",
    )
)
