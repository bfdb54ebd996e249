"""The Jamba family's own switches, a port-only :class:`ModelConfig`.

The JAX package's ``ModelConfig`` (which the port's copies field for field,
``tests/test_torch_configs.py``) has no field for two things Jamba's
published layers do (arXiv:2403.19887; the HF ``JambaMambaMixer`` and
``JambaAttention``):

- ``rope``: its attention layers carry no positional encoding (the Mamba
  layers carry order), so q and k go to the product as projected;
- ``mamba_inner_norm``: its mixer puts an RMSNorm with learned weights
  (float32, ones at init, eps ``norm_eps``) on each of ``dt`` (width
  ``dt_rank``), ``B`` and ``C`` (width ``ssm_state``) after ``x_proj``.

A config of this type is not registered, so the registry stays the JAX
package's. The model code reads the switches through :func:`uses_rope` and
:func:`mamba_inner_norm`, which give every other config its path as before.
"""
from __future__ import annotations

import dataclasses

from repro_torch.configs.base import ModelConfig


@dataclasses.dataclass(frozen=True)
class JambaConfig(ModelConfig):
    rope: bool = False
    mamba_inner_norm: bool = True


def uses_rope(cfg: ModelConfig) -> bool:
    """Whether attention rotates q and k (every registered config does)."""
    return cfg.rope if isinstance(cfg, JambaConfig) else True


def mamba_inner_norm(cfg: ModelConfig) -> bool:
    """Whether the mamba mixer norms ``dt``, ``B`` and ``C`` after
    ``x_proj`` (no registered config does)."""
    return cfg.mamba_inner_norm if isinstance(cfg, JambaConfig) else False
