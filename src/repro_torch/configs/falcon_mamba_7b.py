"""Falcon-Mamba 7B — attention-free mamba1 [arXiv:2410.05355]."""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="falcon-mamba-7b",
        family="ssm",
        n_layers=64,
        d_model=4096,
        n_heads=0,
        n_kv_heads=0,
        d_ff=0,
        vocab_size=65_024,
        ssm_state=16,
        ssm_expand=2,
        ssm_conv=4,
        citation="arXiv:2410.05355",
    )
)
