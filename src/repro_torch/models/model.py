"""Model entry points: init, loss and step functions, as
``repro.models.model``. The launchers, the ``llm-split`` engine and the
tests call this layer."""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models import transformer
from repro_torch.models.layers import softmax_cross_entropy
from repro_torch.models.transformer import ModelOptions

MOE_AUX_WEIGHT = 0.01

# stub-frontend sizing: patches a VLM sample carries
VLM_N_PATCHES = 1024


def init_model(generator: torch.Generator, cfg: ModelConfig, dtype=None, device=None) -> dict:
    return transformer.init_params(generator, cfg, dtype, device)


def make_batch_shapes(cfg: ModelConfig, shape: ShapeConfig, *,
                      batch_override: int = None) -> Dict[str, Tuple[tuple, torch.dtype]]:
    """``{input: (shape, dtype)}`` of every model input, the port's
    counterpart of the reference's ``jax.ShapeDtypeStruct`` stand-ins
    (``torch.empty(*spec, device="meta")`` makes one a tensor)."""
    B = batch_override or shape.global_batch
    S = shape.seq_len
    if shape.kind == "decode":
        return {"tokens": ((B, 1), torch.int32)}
    if cfg.frontend == "audio_frames":
        return {"frame_embeds": ((B, S, cfg.frontend_dim), torch.bfloat16),
                "labels": ((B, S), torch.int32)}
    if cfg.frontend == "vision_patches":
        P = min(VLM_N_PATCHES, S // 2)
        return {"tokens": ((B, S - P), torch.int32),
                "patch_embeds": ((B, P, cfg.frontend_dim), torch.bfloat16),
                "labels": ((B, S), torch.int32)}
    return {"tokens": ((B, S), torch.int32), "labels": ((B, S), torch.int32)}


def loss_fn(params: dict, cfg: ModelConfig, batch: Dict[str, torch.Tensor],
            opts: ModelOptions = ModelOptions(), noise=None):
    """Next-token LM loss (causal) or per-frame classification
    (encoder-only): ``(ce + MOE_AUX_WEIGHT * aux, {"ce", "moe_aux"})``.
    ``noise`` is the cut's standard-normal model noise (``None``: none)."""
    logits, moe_aux = transformer.forward(params, cfg, batch, opts, noise)
    labels = batch["labels"]
    if cfg.is_encoder_only:
        ce = softmax_cross_entropy(logits, labels)
    else:
        # next-token prediction: logits[:, :-1] predicts labels[:, 1:]
        ce = softmax_cross_entropy(logits[:, :-1], labels[:, 1:])
    return ce + MOE_AUX_WEIGHT * moe_aux, {"ce": ce, "moe_aux": moe_aux}


def prefill(params: dict, cfg: ModelConfig, batch, opts: ModelOptions = ModelOptions()):
    """Inference prefill: the forward's logits (no labels needed)."""
    logits, _ = transformer.forward(params, cfg, batch, opts)
    return logits


def serve_step(params: dict, cfg: ModelConfig, state, tokens, pos: int,
               opts: ModelOptions = ModelOptions()):
    """ONE new token against the KV caches."""
    return transformer.decode_step(params, cfg, state, tokens, pos, opts)


def init_decode_state(cfg: ModelConfig, batch: int, max_seq: int, dtype=torch.bfloat16,
                      device=None):
    return transformer.init_decode_state(cfg, batch, max_seq, dtype, device)
