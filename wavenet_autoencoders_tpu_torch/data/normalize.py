"""CMVN fit + apply over dump directories (a copy of
``wavenet_autoencoders_tpu/data/normalize.py``).

Replaces ``compute_mean_var.py`` (StandardScaler.partial_fit + joblib) and
``normalize.py`` (transform to ``<feat>.norm.npy`` / inverse) with the
self-contained npz-backed :class:`dsp.CMVN`.
"""
from __future__ import annotations

import json
from pathlib import Path

import numpy as np

from wavenet_autoencoders_tpu_torch.dsp.cmvn import CMVN


def _dump_dirs(scp_path: str) -> list[str]:
    return [dst for _src, dst in json.load(open(scp_path))]


def compute_mean_var(scp_paths: list[str], feat: str, scaler_out: str) -> CMVN:
    """``compute_mean_var.py:18-41`` over one or more scp splits."""
    cm = CMVN()
    n = 0
    for scp in scp_paths:
        for d in _dump_dirs(scp):
            p = Path(d) / f"{feat}.npy"
            cm.partial_fit(np.load(p))
            n += 1
    cm.save(scaler_out)
    print(f"fitted CMVN on {n} utterances -> {scaler_out}")
    return cm


def apply_normalization(scp_path: str, feat: str, scaler_path: str, inverse: bool = False):
    """``normalize.py:27-74``: <feat>.npy -> <feat>.norm.npy (or inverse)."""
    cm = CMVN.load(scaler_path)
    for d in _dump_dirs(scp_path):
        base = Path(d) / f"{feat}.npy"
        norm = Path(d) / f"{feat}.norm.npy"
        if inverse:
            np.save(base, cm.inverse_transform(np.load(norm)), allow_pickle=False)
        else:
            np.save(norm, cm.transform(np.load(base)), allow_pickle=False)
