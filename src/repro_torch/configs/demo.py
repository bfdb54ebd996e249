"""Demo-scale configs for the end-to-end CPU drivers (examples/)."""
from repro_torch.configs.base import ModelConfig, register

# ~100M params: the end-to-end training driver target.
DEMO_100M = register(
    ModelConfig(
        name="demo-100m",
        family="dense",
        n_layers=12,
        d_model=640,
        n_heads=10,
        n_kv_heads=5,
        d_ff=2560,
        vocab_size=16_384,
        dtype="float32",
        privacy_noise=0.02,
        citation="demo",
    )
)

# ~11M params: fast CPU demo / CI default.
DEMO_11M = register(
    ModelConfig(
        name="demo-11m",
        family="dense",
        n_layers=8,
        d_model=256,
        n_heads=8,
        n_kv_heads=4,
        d_ff=1024,
        vocab_size=4096,
        dtype="float32",
        privacy_noise=0.02,
        citation="demo",
    )
)

# tiny MoE demo (exercises expert parallel paths end-to-end on CPU)
DEMO_MOE = register(
    ModelConfig(
        name="demo-moe",
        family="moe",
        n_layers=4,
        d_model=256,
        n_heads=8,
        n_kv_heads=4,
        d_ff=512,
        vocab_size=4096,
        n_experts=8,
        experts_per_token=2,
        dtype="float32",
        privacy_noise=0.02,
        citation="demo",
    )
)
