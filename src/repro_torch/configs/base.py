"""Model / input-shape configuration system, copied from
``repro/configs/base.py`` so that the port imports nothing of ``repro``.

Every architecture of the repo registers a :class:`ModelConfig` here and is
selected by ``get_config(name)``. In the port, ``chip_smoke.py`` and the
tests take the shapes of the LM kernels (``flash_attention``,
``selective_scan``) from these configs.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int  # 0 for attention-free (pure SSM)
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # derived from d_model/n_heads when 0

    # --- MoE ---
    n_experts: int = 0
    experts_per_token: int = 0
    moe_period: int = 1  # every `moe_period`-th layer is MoE (jamba: 2)
    capacity_factor: float = 1.25

    # --- SSM (mamba1) ---
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_conv: int = 4
    dt_rank: int = 0  # derived d_model/16 when 0

    # --- hybrid (jamba) ---
    attn_period: int = 0  # 1 attention layer per `attn_period` layers; 0 = n/a
    attn_offset: int = 4  # position of the attn layer inside each period group

    # --- attention flavour ---
    sliding_window: int = 0  # 0 = full causal attention
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    causal: bool = True  # False => encoder-only (hubert)

    # --- misc ---
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    dtype: str = "bfloat16"

    # --- split-learning integration (the paper's technique) ---
    cut_layers: int = 1  # client-held layers (the privacy-preserving layer)
    privacy_noise: float = 0.0  # stddev of Gaussian noise added at the cut

    # --- modality frontend (stubbed per assignment carve-out) ---
    frontend: str = "token"  # token | audio_frames | vision_patches
    frontend_dim: int = 0  # embedding dim delivered by the stub frontend

    citation: str = ""

    # ------------------------------------------------------------------
    def __post_init__(self):
        if self.head_dim == 0 and self.n_heads > 0:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)
        if self.dt_rank == 0 and self.ssm_state > 0:
            object.__setattr__(self, "dt_rank", max(1, self.d_model // 16))
        if self.frontend_dim == 0:
            object.__setattr__(self, "frontend_dim", self.d_model)

    # ------------------------------------------------------------------
    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def is_encoder_only(self) -> bool:
        return not self.causal

    def layer_kind(self, i: int) -> str:
        """'attn' or 'ssm' for global layer index i."""
        if self.family == "ssm":
            return "ssm"
        if self.family == "hybrid":
            return "attn" if (i % self.attn_period) == self.attn_offset else "ssm"
        return "attn"

    def layer_is_moe(self, i: int) -> bool:
        return self.n_experts > 0 and (i % self.moe_period) == (self.moe_period - 1)

    # ------------------------------------------------------------------
    def param_count(self) -> int:
        """Analytic parameter count (matches the initialiser; used for 6ND)."""
        d, ff, V = self.d_model, self.d_ff, self.vocab_size
        total = V * d  # embedding
        if not self.tie_embeddings:
            total += d * V  # lm head / output proj
        total += d  # final norm
        for i in range(self.n_layers):
            kind = self.layer_kind(i)
            if kind == "attn":
                q = d * self.n_heads * self.head_dim
                kv = 2 * d * self.n_kv_heads * self.head_dim
                o = self.n_heads * self.head_dim * d
                total += q + kv + o + d  # + attn norm
                if self.qkv_bias:
                    total += (self.n_heads + 2 * self.n_kv_heads) * self.head_dim
            else:  # ssm
                di, st, dt = self.d_inner, self.ssm_state, self.dt_rank
                total += d * 2 * di  # in_proj
                total += di * self.ssm_conv + di  # conv1d + bias
                total += di * (dt + 2 * st)  # x_proj
                total += dt * di + di  # dt_proj + bias
                total += di * st + di  # A_log + D
                total += di * d  # out_proj
                total += d  # norm
            # FFN sub-layer (attn layers always have one; ssm blocks fold the
            # MLP into the block in mamba1 — no separate FFN for pure ssm)
            if kind == "attn" or self.family == "hybrid":
                if self.layer_is_moe(i):
                    total += d * self.n_experts  # router
                    total += self.n_experts * 3 * d * ff
                elif ff > 0:
                    total += 3 * d * ff  # SwiGLU
                total += d  # ffn norm
        return total

    def active_param_count(self) -> int:
        """Params touched per token (MoE uses experts_per_token of n_experts)."""
        if self.n_experts == 0:
            return self.param_count()
        d, ff = self.d_model, self.d_ff
        total = self.param_count()
        for i in range(self.n_layers):
            if self.layer_is_moe(i):
                inactive = self.n_experts - self.experts_per_token
                total -= inactive * 3 * d * ff
        return total

    # ------------------------------------------------------------------
    def reduced(self) -> "ModelConfig":
        """Smoke-test variant: 2 layers, d_model<=512, <=4 experts."""
        d = min(self.d_model, 256)
        n_heads = min(self.n_heads, 4) if self.n_heads else 0
        n_kv = min(self.n_kv_heads, max(1, n_heads // 2)) if n_heads else 0
        n_layers = 2
        attn_period = 0
        attn_offset = self.attn_offset
        if self.family == "hybrid":
            n_layers = 4
            attn_period = 2
            attn_offset = 1
        return dataclasses.replace(
            self,
            name=self.name + "-smoke",
            n_layers=n_layers,
            d_model=d,
            n_heads=n_heads,
            n_kv_heads=n_kv,
            head_dim=(d // n_heads) if n_heads else 0,
            d_ff=min(self.d_ff, 512) if self.d_ff else 0,
            vocab_size=min(self.vocab_size, 512),
            n_experts=min(self.n_experts, 4),
            experts_per_token=min(self.experts_per_token, 2),
            dt_rank=0 if self.ssm_state else self.dt_rank,
            attn_period=attn_period,
            attn_offset=attn_offset,
            sliding_window=min(self.sliding_window, 64) if self.sliding_window else 0,
            frontend_dim=d,  # stub frontend delivers reduced-width embeddings
            dtype="float32",
        )


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES: Dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


_REGISTRY: Dict[str, ModelConfig] = {}


def register(cfg: ModelConfig) -> ModelConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ModelConfig:
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def list_configs() -> Dict[str, ModelConfig]:
    return dict(_REGISTRY)


def shape_applicable(cfg: ModelConfig, shape: ShapeConfig) -> Optional[str]:
    """Return None if (arch, shape) should run; else a skip reason (DESIGN.md §4)."""
    if shape.kind == "decode":
        if cfg.is_encoder_only:
            return "encoder-only: no autoregressive decode step"
        if shape.seq_len > 100_000:
            subq = cfg.family in ("ssm", "hybrid") or cfg.sliding_window > 0
            if not subq:
                return "full-attention dense arch: long_500k requires sub-quadratic attention"
    return None
