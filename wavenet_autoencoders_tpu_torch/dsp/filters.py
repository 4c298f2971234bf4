"""Waveform-domain utilities: wav I/O, FIR high-pass, silence trimming
(numpy/scipy; a copy of ``wavenet_autoencoders_tpu/dsp/filters.py``).

Replaces ``audio.py:14-105`` (scipy.io.wavfile + librosa.effects.trim +
kan-bayashi low_cut_filter).
"""
from __future__ import annotations

import numpy as np
from scipy.io import wavfile
from scipy.signal import firwin, lfilter, resample_poly

from wavenet_autoencoders_tpu_torch.dsp.stft import frame as _frame


def load_wav(path, sample_rate: int) -> np.ndarray:
    """int16 wav -> float32 in [-1, 1], resampled to ``sample_rate`` if
    needed (``audio.py:37-47``)."""
    sr, x = wavfile.read(path)
    if x.dtype == np.int16:
        x = x.astype(np.float32) / 2**15
    elif x.dtype == np.int32:
        x = x.astype(np.float32) / 2**31
    elif x.dtype != np.float32:
        x = x.astype(np.float32)
    if x.ndim > 1:
        x = x.mean(axis=-1)
    if sr != sample_rate:
        g = np.gcd(sr, sample_rate)
        x = resample_poly(x, sample_rate // g, sr // g).astype(np.float32)
    return np.clip(x, -1.0, 1.0)


def save_wav(wav: np.ndarray, path, sample_rate: int) -> None:
    """Peak-normalize to int16 and write (``audio.py:50-52``)."""
    wav = np.asarray(wav, dtype=np.float64)
    wav = wav * (32767 / max(0.01, np.max(np.abs(wav))))
    wavfile.write(path, sample_rate, wav.astype(np.int16))


def low_cut_filter(x: np.ndarray, fs: int, cutoff: float = 70.0) -> np.ndarray:
    """255-tap FIR high-pass (DC removal) — ``audio.py:14-34``."""
    nyquist = fs // 2
    fil = firwin(255, cutoff / nyquist, pass_zero=False)
    return lfilter(fil, 1, x)


def trim_silence_db(
    y: np.ndarray,
    top_db: float = 60.0,
    frame_length: int = 2048,
    hop_length: int = 512,
) -> tuple[np.ndarray, tuple[int, int]]:
    """Trim leading/trailing silence below ``max - top_db`` dB.

    Equivalent of librosa.effects.trim as called at
    ``preprocess_2019.py:65``: frame-level RMS power relative to the peak
    frame.
    """
    if len(y) < frame_length:
        return y, (0, len(y))
    padded = np.pad(y, frame_length // 2, mode="reflect")
    frames = _frame(padded, frame_length, hop_length)
    rms2 = np.mean(frames.astype(np.float64) ** 2, axis=-1)
    ref = max(rms2.max(), 1e-20)
    db = 10.0 * np.log10(np.maximum(rms2, 1e-20) / ref)
    nonsilent = np.flatnonzero(db > -top_db)
    if len(nonsilent) == 0:
        return y[:0], (0, 0)
    start = int(nonsilent[0] * hop_length)
    end = min(len(y), int((nonsilent[-1] + 1) * hop_length))
    return y[start:end], (start, end)


def start_and_end_indices(quantized: np.ndarray, silence_threshold: int = 2):
    """First/last indices where the mu-law code leaves the silence band
    around 127 (``audio.py:94-105``)."""
    above = np.abs(quantized.astype(np.int64) - 127) > silence_threshold
    idx = np.flatnonzero(above)
    if len(idx) == 0:
        return 0, len(quantized)
    return int(idx[0]), int(idx[-1])


def trim_quantized(quantized: np.ndarray, silence_threshold: int = 2) -> np.ndarray:
    """``audio.py:55-57``."""
    s, e = start_and_end_indices(quantized, silence_threshold)
    return quantized[s:e]


def adjust_time_resolution(quantized: np.ndarray, feats: np.ndarray, silence_threshold: int = 2):
    """Repeat frame features to sample rate and co-trim
    (``audio.py:68-91``). feats: (N, D)."""
    assert quantized.ndim == 1 and feats.ndim == 2
    upsample_factor = quantized.size // feats.shape[0]
    feats = np.repeat(feats, upsample_factor, axis=0)
    n_pad = quantized.size - feats.shape[0]
    if n_pad != 0:
        assert n_pad > 0
        feats = np.pad(feats, [(0, n_pad), (0, 0)], mode="constant")
    s, e = start_and_end_indices(quantized, silence_threshold)
    return quantized[s:e], feats[s:e, :]
