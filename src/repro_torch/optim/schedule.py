"""Learning-rate schedules, as ``repro.optim.schedule``: each maps an int32
step tensor to a float32 learning-rate tensor."""
from __future__ import annotations

import math

import torch


def constant_schedule(lr: float):
    return lambda step: torch.tensor(lr, dtype=torch.float32, device=step.device)


def cosine_schedule(peak_lr: float, total_steps: int, final_frac: float = 0.1):
    def fn(step):
        frac = torch.clamp(step.float() / total_steps, 0.0, 1.0)
        cos = 0.5 * (1 + torch.cos(math.pi * frac))
        return peak_lr * (final_frac + (1 - final_frac) * cos)

    return fn


def linear_warmup_cosine(peak_lr: float, warmup: int, total_steps: int, final_frac: float = 0.1):
    cos = cosine_schedule(peak_lr, max(total_steps - warmup, 1), final_frac)

    def fn(step):
        step = step.float()
        warm = peak_lr * step / max(warmup, 1)
        return torch.where(step < warmup, warm, cos(step - warmup))

    return fn
