"""Losses and evaluation metrics used by the paper (MSLE/RMSLE/sMAPE, Eq. 3-5)."""
from __future__ import annotations

import torch


def bce_with_logits(logits, labels):
    """Binary cross-entropy. logits [B] or [B,1]; labels float {0,1}."""
    logits = logits.reshape(labels.shape).float()
    labels = labels.float()
    # the reference's gradients at a logit of exactly 0 (a row whose hidden
    # units are all dead, through a bias at its zero init): jnp.maximum
    # splits the tie (0.5) and jnp.abs has slope 1 there, where torch.clamp
    # passes 1 and torch.abs 0
    zero = torch.zeros_like(logits)
    return torch.mean(
        torch.maximum(logits, zero) - logits * labels
        + torch.log1p(torch.exp(-torch.where(logits >= 0, logits, -logits)))
    )


def ce_with_logits(logits, labels):
    """Multiclass CE. logits [B, C]; labels int [B]."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels.long()[:, None])[:, 0]
    return torch.mean(logz - ll)


def mse(pred, target):
    return torch.mean(torch.square(pred.float() - target.float()))


def msle_per_sample(pred, target):
    pred = torch.clamp(pred.float(), min=0.0)
    target = torch.clamp(target.float(), min=0.0)
    return torch.square(torch.log1p(target) - torch.log1p(pred))


def msle(pred, target):
    """Mean squared logarithmic error (paper Eq. 3). Values must be >= 0."""
    return torch.mean(msle_per_sample(pred, target))


def rmsle(pred, target):
    """Root MSLE (paper Eq. 4)."""
    return torch.sqrt(msle(pred, target))


def smape(pred, target):
    """Symmetric mean absolute percentage error in % (paper Eq. 5)."""
    pred, target = pred.float(), target.float()
    denom = torch.abs(target) + torch.abs(pred)
    return 100.0 * torch.mean(torch.abs(target - pred) / torch.clamp(denom, min=1e-9))


def binary_accuracy(logits, labels):
    pred = (logits.reshape(labels.shape) > 0).float()
    return torch.mean((pred == labels.float()).float())


def multiclass_accuracy(logits, labels):
    return torch.mean((torch.argmax(logits, -1) == labels).float())
