"""Mask-weighted sequence losses (counterpart of
``wavenet_autoencoders_tpu/ops/losses.py``): the mu-law cross-entropy and
the MoL/MoG NLLs of the scalar-input path.

Logits/parameters are channels-last (B, T, C); the reduction is the
mask-weighted mean ``sum(loss * mask) / max(sum(mask), 1)``, or
``sum(loss * mask) / denom`` when the caller gives the denominator (a
data-parallel rank divides its numerator by the global batch's).
"""
from __future__ import annotations

import torch

from wavenet_autoencoders_tpu_torch.ops.mixture import discretized_mix_logistic_loss, mix_gaussian_loss


def sequence_mask(lengths: torch.Tensor, max_len: int) -> torch.Tensor:
    """(B,) lengths -> (B, max_len) float 0/1 mask."""
    pos = torch.arange(max_len, device=lengths.device)[None, :]
    return (pos < lengths[:, None]).float()


def masked_cross_entropy(logits: torch.Tensor, targets: torch.Tensor, mask: torch.Tensor,
                         denom: torch.Tensor | None = None) -> torch.Tensor:
    """Softmax CE; logits (B, T, Q), integer targets (B, T) or (B, T, 1),
    mask (B, T) or (B, T, 1)."""
    if targets.ndim == 3:
        targets = targets[..., 0]
    if mask.ndim == 3:
        mask = mask[..., 0]
    logp = torch.log_softmax(logits, dim=-1)
    nll = -logp.gather(-1, targets.long()[..., None])[..., 0]
    if denom is None:
        denom = mask.sum().clamp_min(1.0)
    return (nll * mask).sum() / denom


def _masked_mean(losses: torch.Tensor, mask: torch.Tensor, denom: torch.Tensor | None = None) -> torch.Tensor:
    if mask.ndim == 2:
        mask = mask[..., None]
    return (losses * mask).sum() / (mask.sum().clamp_min(1.0) if denom is None else denom)


def masked_mol_loss(y_hat, y, mask, num_classes: int, log_scale_min: float, denom=None) -> torch.Tensor:
    """Masked discretized-MoL NLL; y_hat (B, T, 3M), y (B, T, 1)."""
    losses = discretized_mix_logistic_loss(
        y_hat, y, num_classes=num_classes, log_scale_min=log_scale_min, reduce=False
    )
    return _masked_mean(losses, mask, denom)


def masked_mog_loss(y_hat, y, mask, log_scale_min: float, denom=None) -> torch.Tensor:
    """Masked MoG NLL; y_hat (B, T, C), y (B, T, 1)."""
    return _masked_mean(mix_gaussian_loss(y_hat, y, log_scale_min=log_scale_min, reduce=False), mask, denom)
