"""Acoustic feature extraction: espnet-style log-mel and MFCC(13)+Δ+ΔΔ
(numpy/scipy; a copy of ``wavenet_autoencoders_tpu/dsp/features.py``).

Replaces ``audio.py:108-125`` (librosa-based). The 39-dim MFCC+Δ+ΔΔ matrix is
the encoder input for every autoencoder in the zoo (c_in=39, SURVEY.md §2.2).
"""
from __future__ import annotations

import numpy as np
from scipy.signal import savgol_filter

from wavenet_autoencoders_tpu_torch.config import Config
from wavenet_autoencoders_tpu_torch.dsp.stft import dct_matrix, mel_filterbank, stft

_fb_cache: dict = {}


def _cached_mel_fb(sr, n_fft, n_mels, fmin, fmax):
    key = (sr, n_fft, n_mels, fmin, fmax)
    if key not in _fb_cache:
        _fb_cache[key] = mel_filterbank(sr, n_fft, n_mels=n_mels, fmin=fmin, fmax=fmax)
    return _fb_cache[key]


def logmelspectrogram(y: np.ndarray, cfg: Config, pad_mode: str = "reflect") -> np.ndarray:
    """Espnet-style log10-mel spectrogram, shape (n_mels, T).

    Mirrors ``audio.py:108-116``: |STFT| -> Slaney mel (with cfg fmin/fmax)
    -> log10(max(., 1e-10)).
    """
    D = stft(
        y,
        n_fft=cfg.fft_size,
        hop_length=cfg.get_hop_size(),
        win_length=cfg.get_win_length(),
        window=cfg.window,
        center=True,
        pad_mode=pad_mode,
    )
    fb = _cached_mel_fb(cfg.sample_rate, cfg.fft_size, cfg.num_mels, cfg.fmin, cfg.fmax)
    S = fb @ np.abs(D)
    return np.log10(np.maximum(S, 1e-10))


def _power_to_db(S: np.ndarray, amin: float = 1e-10, top_db: float = 80.0) -> np.ndarray:
    """librosa.power_to_db with ref=1.0: 10 log10(max(S, amin)), floored at
    global max - top_db."""
    log_spec = 10.0 * np.log10(np.maximum(amin, S))
    if top_db is not None:
        log_spec = np.maximum(log_spec, log_spec.max() - top_db)
    return log_spec


def delta(data: np.ndarray, width: int = 9, order: int = 1) -> np.ndarray:
    """librosa.feature.delta: Savitzky-Golay derivative along time (last
    axis), width 9, polyorder=deriv=order, mode='interp'."""
    return savgol_filter(data, width, polyorder=order, deriv=order, axis=-1, mode="interp")


def mfcc(y: np.ndarray, cfg: Config) -> np.ndarray:
    """MFCC(n_mfcc) + Δ + ΔΔ stacked along the feature axis, shape
    (3*n_mfcc, T) = (39, T).

    Mirrors ``audio.py:119-125``, which calls librosa.feature.mfcc with
    defaults: power-2 mel spectrogram over the FULL band (fmin=0,
    fmax=sr/2 — note: cfg.fmin/fmax are NOT passed there), power_to_db with
    top_db=80, orthonormal DCT-II, first n_mfcc coefficients.
    """
    D = stft(
        y,
        n_fft=cfg.fft_size,
        hop_length=cfg.get_hop_size(),
        win_length=cfg.fft_size,
        window="hann",
        center=True,
        pad_mode="reflect",
    )
    fb = _cached_mel_fb(cfg.sample_rate, cfg.fft_size, cfg.num_mels, 0.0, None)
    S = fb @ (np.abs(D) ** 2)
    log_S = _power_to_db(S)
    M = dct_matrix(cfg.n_mfcc, cfg.num_mels) @ log_S
    d1 = delta(M, order=1)
    d2 = delta(M, order=2)
    return np.concatenate([M, d1, d2], axis=0).astype(np.float32)
