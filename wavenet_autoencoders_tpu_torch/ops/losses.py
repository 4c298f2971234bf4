"""Mask-weighted sequence losses of the mu-law-quantize path (counterpart of
``wavenet_autoencoders_tpu/ops/losses.py:18-36``).

Logits are channels-last (B, T, Q); the reduction is the mask-weighted mean
``sum(loss * mask) / max(sum(mask), 1)``. The MoL/MoG losses of the scalar
input path are not ported yet (ROADMAP.md, queue 1).
"""
from __future__ import annotations

import torch


def sequence_mask(lengths: torch.Tensor, max_len: int) -> torch.Tensor:
    """(B,) lengths -> (B, max_len) float 0/1 mask."""
    pos = torch.arange(max_len, device=lengths.device)[None, :]
    return (pos < lengths[:, None]).float()


def masked_cross_entropy(logits: torch.Tensor, targets: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Softmax CE; logits (B, T, Q), integer targets (B, T) or (B, T, 1),
    mask (B, T) or (B, T, 1)."""
    if targets.ndim == 3:
        targets = targets[..., 0]
    if mask.ndim == 3:
        mask = mask[..., 0]
    logp = torch.log_softmax(logits, dim=-1)
    nll = -logp.gather(-1, targets.long()[..., None])[..., 0]
    denom = mask.sum().clamp_min(1.0)
    return (nll * mask).sum() / denom
