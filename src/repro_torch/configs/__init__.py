from repro_torch.configs.paper_models import (
    CHOLESTEROL_MLP,
    COVID_CNN,
    MURA_VGG19,
    TABLE1_CNN,
    CNNConfig,
    MLPConfig,
)
