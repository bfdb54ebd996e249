"""The paper's own model configurations (Table 4), as plain dataclasses.

Three models: the custom 5-conv-layer COVID-19 CT classifier (64x64x1 inputs,
binary cross-entropy, sigmoid), VGG19 for MURA X-rays (224x224x1), and the
cholesterol regression MLP (7 tabular features -> LDL-C).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class CNNConfig:
    name: str
    input_hw: Tuple[int, int]
    in_channels: int
    # (filters, repeats) per stage; each stage ends with 2x2 max-pool.
    stages: Tuple[Tuple[int, int], ...]
    n_classes: int
    dense_units: Tuple[int, ...] = ()
    cut_layers: int = 1  # client-held conv stages (privacy-preserving layer)
    privacy_noise: float = 0.05
    batch_size: int = 64
    epochs: int = 100
    loss: str = "bce"
    activation: str = "sigmoid_out"
    # use_kernel routes single-conv client stages through the fused privacy
    # kernel (Conv3x3+ReLU+MaxPool2x2+noise in one pass, so the pre-pool
    # activation never leaves the chip): the CUDA kernel for a CUDA tensor,
    # its plain PyTorch version for a CPU tensor. Differentiable through a
    # torch.autograd.Function whose backward runs the plain version.
    use_kernel: bool = False
    # kept so that configurations carry across from the JAX package; it has
    # no effect here (there is no interpreter: the device of the tensor
    # decides between the kernel and its plain version)
    interpret: Optional[bool] = None


@dataclasses.dataclass(frozen=True)
class MLPConfig:
    name: str
    in_features: int
    hidden: Tuple[int, ...]
    cut_layers: int = 1
    privacy_noise: float = 0.01
    batch_size: int = 2048
    epochs: int = 200
    loss: str = "mse"
    activation: str = "leaky_relu"


# Custom COVID-19 CT classifier: 5 conv layers, client holds the first (Table 4).
COVID_CNN = CNNConfig(
    name="paper-covid-cnn",
    input_hw=(64, 64),
    in_channels=1,
    stages=((16, 1), (32, 1), (64, 1), (128, 1), (256, 1)),
    n_classes=1,
    dense_units=(64,),
    cut_layers=1,
    batch_size=64,
    epochs=100,
)

# VGG19 for MURA: 16 conv layers + 3 dense; client holds the first conv block
# (paper: 1 of 17 conv layers at the client, feature map 112x112 transferred).
MURA_VGG19 = CNNConfig(
    name="paper-mura-vgg19",
    input_hw=(224, 224),
    in_channels=1,
    stages=((64, 2), (128, 2), (256, 4), (512, 4), (512, 4)),
    n_classes=1,
    dense_units=(4096, 4096),
    cut_layers=1,
    batch_size=128,
    epochs=50,
)

# Cholesterol LDL-C regressor: 7 features (age, sex, height, weight, TC, HDL-C, TG).
CHOLESTEROL_MLP = MLPConfig(
    name="paper-cholesterol-mlp",
    in_features=7,
    hidden=(64, 128, 64, 32),
    cut_layers=1,
    batch_size=2048,
    epochs=200,
)

# The related-work CIFAR-style model used for Table 1 (5 hidden layers of
# 16/32/64/128/256 filters on 32x32 inputs).
TABLE1_CNN = CNNConfig(
    name="paper-table1-cnn",
    input_hw=(32, 32),
    in_channels=3,
    stages=((16, 1), (32, 1), (64, 1), (128, 1), (256, 1)),
    n_classes=10,
    dense_units=(128,),
    cut_layers=1,
    batch_size=64,
    epochs=30,
    loss="ce",
    activation="softmax_out",
)
