"""Mu-law companding, pre-emphasis and their inverses (numpy/scipy).

Counterparts of ``wavenet_autoencoders_tpu/dsp/mulaw.py:27-79`` for host
arrays; ``mu = quantize_channels - 1`` (255) gives codes in [0, 255].
"""
from __future__ import annotations

import numpy as np
from scipy.signal import lfilter


def mulaw(x, mu: int = 256):
    """Mu-law companding: [-1, 1] -> [-1, 1]."""
    mu = float(mu)
    return np.sign(x) * np.log1p(mu * np.abs(x)) / np.log1p(mu)


def mulaw_quantize(x, mu: int = 256):
    """Mu-law compand + quantize: [-1, 1] -> integer codes [0, mu]."""
    out = (mulaw(x, mu) + 1) / 2 * mu
    if np.isscalar(out):
        return int(out)
    return out.astype(np.int64)


def inv_mulaw(y, mu: int = 256):
    """Inverse mu-law companding: [-1, 1] -> [-1, 1]."""
    mu = float(mu)
    return np.sign(y) * (1.0 / mu) * ((1.0 + mu) ** np.abs(y) - 1.0)


def inv_mulaw_quantize(y, mu: int = 256):
    """Integer codes [0, mu] -> waveform in [-1, 1]."""
    if np.isscalar(y):
        return float(inv_mulaw(2.0 * y / mu - 1.0, mu))
    y = np.asarray(y).astype(np.float32)
    return inv_mulaw(2.0 * y / mu - 1.0, mu)


def preemphasis(x, coef: float = 0.85):
    """y[t] = x[t] - coef * x[t-1]  (nnmnkwii lfilter([1, -coef], [1], x))."""
    return np.concatenate([x[:1], x[1:] - coef * x[:-1]])


def inv_preemphasis(x, coef: float = 0.85):
    """Inverse of pre-emphasis: y[t] = x[t] + coef * y[t-1]."""
    return lfilter([1], [1, -float(coef)], x)
