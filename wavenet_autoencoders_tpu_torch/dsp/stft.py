"""STFT, mel filterbank and DCT (numpy; a copy of
``wavenet_autoencoders_tpu/dsp/stft.py``, so the port's features equal the
JAX package's bit for bit).

Covers ``audio.py:_stft`` (librosa.stft, center=True), ``audio.py:167-172``
(librosa.filters.mel, Slaney scale + Slaney norm) and the DCT-II used by
librosa.feature.mfcc.
"""
from __future__ import annotations

import numpy as np


def hann_window(n: int) -> np.ndarray:
    """Periodic (DFT-even) Hann window — scipy get_window('hann', n,
    fftbins=True), librosa's default."""
    return 0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(n) / n)


def frame(x: np.ndarray, frame_length: int, hop_length: int) -> np.ndarray:
    """Frame a 1-D signal into overlapping windows, shape (n_frames, L)."""
    n_frames = 1 + (len(x) - frame_length) // hop_length
    idx = (
        np.arange(frame_length)[None, :]
        + hop_length * np.arange(n_frames)[:, None]
    )
    return x[idx]


def stft(
    y: np.ndarray,
    n_fft: int,
    hop_length: int,
    win_length: int | None = None,
    window: str = "hann",
    center: bool = True,
    pad_mode: str = "constant",
) -> np.ndarray:
    """Complex STFT, shape (1 + n_fft//2, n_frames) — librosa.stft layout.

    Reference call sites: ``audio.py:144-148`` (pad_mode='constant' for the
    espnet log-mel path, 'reflect' when requested).
    """
    if win_length is None:
        win_length = n_fft
    assert window == "hann", "only hann supported (reference uses hann only)"
    w = hann_window(win_length)
    if win_length < n_fft:  # center-pad window to n_fft (librosa semantics)
        lpad = (n_fft - win_length) // 2
        w = np.pad(w, (lpad, n_fft - win_length - lpad))
    if center:
        y = np.pad(y, n_fft // 2, mode=pad_mode)
    frames = frame(y, n_fft, hop_length) * w[None, :]
    return np.fft.rfft(frames, n=n_fft, axis=-1).T


def _hz_to_mel_slaney(f):
    f = np.asarray(f, dtype=np.float64)
    f_sp = 200.0 / 3
    mels = f / f_sp
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(
        f >= min_log_hz, min_log_mel + np.log(np.maximum(f, 1e-10) / min_log_hz) / logstep, mels
    )


def _mel_to_hz_slaney(m):
    m = np.asarray(m, dtype=np.float64)
    f_sp = 200.0 / 3
    freqs = f_sp * m
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(m >= min_log_mel, min_log_hz * np.exp(logstep * (m - min_log_mel)), freqs)


def mel_filterbank(
    sr: int,
    n_fft: int,
    n_mels: int = 128,
    fmin: float = 0.0,
    fmax: float | None = None,
) -> np.ndarray:
    """Slaney-scale, Slaney-normalized triangular mel filterbank,
    shape (n_mels, 1 + n_fft//2) — librosa.filters.mel(htk=False,
    norm='slaney') as used at ``audio.py:167-172``."""
    if fmax is None:
        fmax = sr / 2.0
    fftfreqs = np.linspace(0.0, sr / 2.0, 1 + n_fft // 2)
    mel_pts = np.linspace(_hz_to_mel_slaney(fmin), _hz_to_mel_slaney(fmax), n_mels + 2)
    mel_f = _mel_to_hz_slaney(mel_pts)

    fdiff = np.diff(mel_f)
    ramps = mel_f[:, None] - fftfreqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1][:, None]
    upper = ramps[2:] / fdiff[1:][:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))

    enorm = 2.0 / (mel_f[2 : n_mels + 2] - mel_f[:n_mels])
    weights *= enorm[:, None]
    return weights.astype(np.float32)


def dct_matrix(n_out: int, n_in: int) -> np.ndarray:
    """Orthonormal DCT-II matrix, shape (n_out, n_in) — scipy
    dct(type=2, norm='ortho') as used by librosa.feature.mfcc."""
    k = np.arange(n_out)[:, None]
    n = np.arange(n_in)[None, :]
    m = np.cos(np.pi * k * (2 * n + 1) / (2.0 * n_in)) * np.sqrt(2.0 / n_in)
    m[0] *= 1.0 / np.sqrt(2.0)
    return m.astype(np.float64)
