# Importing the package registers every architecture, as ``repro.configs`` does.
from repro_torch.configs import (
    command_r_plus_104b,
    demo,
    falcon_mamba_7b,
    granite_moe_1b_a400m,
    hubert_xlarge,
    internvl2_26b,
    jamba_1_5_large_398b,
    llama3_2_1b,
    mixtral_8x7b,
    phi4_mini_3_8b,
    qwen2_7b,
)
from repro_torch.configs.base import (
    SHAPES,
    ModelConfig,
    ShapeConfig,
    get_config,
    list_configs,
    register,
    shape_applicable,
)
from repro_torch.configs.paper_models import (
    CHOLESTEROL_MLP,
    COVID_CNN,
    MURA_VGG19,
    TABLE1_CNN,
    CNNConfig,
    MLPConfig,
)
