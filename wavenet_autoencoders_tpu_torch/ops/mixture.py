"""Samplers of the scalar-input output heads: discretized mixture of
logistics and mixture of Gaussians (counterpart of
``wavenet_autoencoders_tpu/ops/mixture.py:79-106,148-164``).

Parameters are (B, T, C) with C = 3·M packed as [logit_probs | means |
log_scales]. Uniforms lie in [1e-5, 1-1e-5), as in the reference. Random
numbers come from an explicit ``torch.Generator``; the losses are training
code and are not ported yet.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def _uniform(shape, like, generator, lo=1e-5):
    u = torch.rand(shape, generator=generator, device=like.device, dtype=torch.float32)
    return u * (1.0 - 2.0 * lo) + lo


def _pick(y, nr_mix, generator):
    logit_probs = y[:, :, :nr_mix]
    temp = logit_probs - torch.log(-torch.log(_uniform(logit_probs.shape, y, generator)))
    one_hot = F.one_hot(temp.argmax(-1), nr_mix).to(y.dtype)
    means = (y[:, :, nr_mix : 2 * nr_mix] * one_hot).sum(-1)
    log_scales = (y[:, :, 2 * nr_mix : 3 * nr_mix] * one_hot).sum(-1)
    return means, log_scales


def sample_from_discretized_mix_logistic(
    y: torch.Tensor,
    generator: torch.Generator | None = None,
    log_scale_min: float = -7.0,
    clamp_log_scale: bool = False,
) -> torch.Tensor:
    """Draw samples in [-1, 1]; y: (B, T, 3*M) -> (B, T)."""
    assert y.shape[-1] % 3 == 0
    means, log_scales = _pick(y, y.shape[-1] // 3, generator)
    if clamp_log_scale:
        log_scales = log_scales.clamp_min(log_scale_min)
    u = _uniform(means.shape, y, generator)
    x = means + torch.exp(log_scales) * (torch.log(u) - torch.log(1.0 - u))
    return x.clamp(-1.0, 1.0)


def sample_from_mix_gaussian(
    y: torch.Tensor, generator: torch.Generator | None = None, log_scale_min: float = -7.0
) -> torch.Tensor:
    """Sample in [-1, 1]; y: (B, T, C) -> (B, T). C == 2 is one Gaussian."""
    if y.shape[-1] == 2:
        means, log_scales = y[:, :, 0], y[:, :, 1]
    else:
        means, log_scales = _pick(y, y.shape[-1] // 3, generator)
    noise = torch.randn(means.shape, generator=generator, device=y.device)
    return (means + torch.exp(log_scales) * noise).clamp(-1.0, 1.0)
