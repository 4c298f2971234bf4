"""Output distributions of the scalar-input heads: discretized mixture of
logistics and mixture of Gaussians, their losses and samplers (counterpart
of ``wavenet_autoencoders_tpu/ops/mixture.py``).

Parameters are (B, T, C) with C = 3·M packed as [logit_probs | means |
log_scales]. The losses keep the reference's numerics: log scales clamped
at ``log_scale_min``, the 1e-12 CDF floor, and the three-way select of the
edge bins (±0.999) and the mid-bin fallback where the CDF difference
underflows. Uniforms of the samplers lie in [1e-5, 1-1e-5); random numbers
come from an explicit ``torch.Generator``.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def log_sum_exp(x: torch.Tensor) -> torch.Tensor:
    """Stable logsumexp over the last axis."""
    m = x.amax(-1)
    return m + torch.log(torch.exp(x - m[..., None]).sum(-1))


def discretized_mix_logistic_loss(
    y_hat: torch.Tensor,
    y: torch.Tensor,
    num_classes: int = 256,
    log_scale_min: float = -7.0,
    reduce: bool = True,
) -> torch.Tensor:
    """NLL of y in [-1, 1] under a discretized MoL. y_hat: (B, T, 3*M);
    y: (B, T, 1). Returns the scalar sum if ``reduce``, else (B, T, 1)."""
    assert y_hat.ndim == 3 and y_hat.shape[-1] % 3 == 0
    nr_mix = y_hat.shape[-1] // 3
    logit_probs = y_hat[:, :, :nr_mix]
    means = y_hat[:, :, nr_mix : 2 * nr_mix]
    log_scales = y_hat[:, :, 2 * nr_mix : 3 * nr_mix].clamp_min(log_scale_min)

    y = y.expand_as(means)
    centered_y = y - means
    inv_stdv = torch.exp(-log_scales)
    plus_in = inv_stdv * (centered_y + 1.0 / (num_classes - 1))
    min_in = inv_stdv * (centered_y - 1.0 / (num_classes - 1))
    log_cdf_plus = plus_in - F.softplus(plus_in)  # log sigmoid(plus_in)
    log_one_minus_cdf_min = -F.softplus(min_in)  # log(1 - sigmoid(min_in))
    cdf_delta = torch.sigmoid(plus_in) - torch.sigmoid(min_in)
    mid_in = inv_stdv * centered_y
    log_pdf_mid = mid_in - log_scales - 2.0 * F.softplus(mid_in)

    # the reference's nested select: left edge bin, right edge bin, else the
    # bin's CDF difference, or the density at its centre where that underflows
    inner_inner = torch.where(
        cdf_delta > 1e-5,
        torch.log(cdf_delta.clamp_min(1e-12)),
        log_pdf_mid - math.log((num_classes - 1) / 2.0),
    )
    inner = torch.where(y > 0.999, log_one_minus_cdf_min, inner_inner)
    log_probs = torch.where(y < -0.999, log_cdf_plus, inner)

    lse = log_sum_exp(log_probs + torch.log_softmax(logit_probs, -1))
    return -lse.sum() if reduce else -lse[..., None]


def mix_gaussian_loss(
    y_hat: torch.Tensor, y: torch.Tensor, log_scale_min: float = -7.0, reduce: bool = True
) -> torch.Tensor:
    """Continuous MoG NLL, with the single-Gaussian C == 2 case. y_hat:
    (B, T, C); y: (B, T, 1)."""
    C = y_hat.shape[-1]
    if C == 2:
        nr_mix, logit_probs = 1, None
        means = y_hat[:, :, 0:1]
        log_scales = y_hat[:, :, 1:2].clamp_min(log_scale_min)
    else:
        assert C % 3 == 0
        nr_mix = C // 3
        logit_probs = y_hat[:, :, :nr_mix]
        means = y_hat[:, :, nr_mix : 2 * nr_mix]
        log_scales = y_hat[:, :, 2 * nr_mix : 3 * nr_mix].clamp_min(log_scale_min)

    centered_y = y.expand_as(means) - means
    # Normal(0, exp(log_scales)).log_prob(centered_y)
    log_probs = (
        -0.5 * math.log(2.0 * math.pi) - log_scales - 0.5 * (centered_y * torch.exp(-log_scales)) ** 2
    )
    if nr_mix == 1:
        return -log_probs.sum() if reduce else -log_probs
    lse = log_sum_exp(log_probs + torch.log_softmax(logit_probs, -1))
    return -lse.sum() if reduce else -lse[..., None]


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
