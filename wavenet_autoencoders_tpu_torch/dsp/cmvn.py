"""Streaming cepstral mean/variance normalization statistics (a copy of
``wavenet_autoencoders_tpu/dsp/cmvn.py``: the same npz keys ``n``, ``mean``
and ``m2``, so either package loads a scaler the other saved).

Replaces sklearn StandardScaler + joblib persistence
(``compute_mean_var.py:18-41``, ``normalize.py:27-83``) with a small
Welford/Chan parallel-merge accumulator persisted as .npz.
"""
from __future__ import annotations

from pathlib import Path

import numpy as np


class CMVN:
    """Accumulates per-dimension mean/variance over utterances of shape
    (T, D); apply/invert like StandardScaler."""

    def __init__(self, dim: int | None = None):
        self.n = 0.0
        self.mean = None if dim is None else np.zeros(dim, np.float64)
        self.m2 = None if dim is None else np.zeros(dim, np.float64)

    def partial_fit(self, x: np.ndarray) -> "CMVN":
        x = np.asarray(x, dtype=np.float64)
        assert x.ndim == 2
        if self.mean is None:
            self.mean = np.zeros(x.shape[1], np.float64)
            self.m2 = np.zeros(x.shape[1], np.float64)
        nb = float(x.shape[0])
        mb = x.mean(axis=0)
        vb = x.var(axis=0) * nb
        delta = mb - self.mean
        tot = self.n + nb
        self.mean += delta * (nb / tot)
        self.m2 += vb + delta**2 * (self.n * nb / tot)
        self.n = tot
        return self

    @property
    def var(self) -> np.ndarray:
        return self.m2 / max(self.n, 1.0)

    @property
    def scale(self) -> np.ndarray:
        # sklearn: zero-variance dims scale to 1
        v = self.var
        s = np.sqrt(v)
        s[s == 0.0] = 1.0
        return s

    def transform(self, x: np.ndarray) -> np.ndarray:
        return ((np.asarray(x) - self.mean) / self.scale).astype(np.float32)

    def inverse_transform(self, x: np.ndarray) -> np.ndarray:
        return (np.asarray(x) * self.scale + self.mean).astype(np.float32)

    def save(self, path) -> None:
        np.savez(path, n=self.n, mean=self.mean, m2=self.m2)

    @classmethod
    def load(cls, path) -> "CMVN":
        z = np.load(Path(path))
        c = cls()
        c.n = float(z["n"])
        c.mean = z["mean"]
        c.m2 = z["m2"]
        return c
