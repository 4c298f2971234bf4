"""WAV output (counterpart of ``wavenet_autoencoders_tpu/dsp/filters.py:33-38``)."""
from __future__ import annotations

import numpy as np
from scipy.io import wavfile


def save_wav(wav: np.ndarray, path, sample_rate: int) -> None:
    """Peak-normalize to int16 and write."""
    wav = np.asarray(wav, dtype=np.float64)
    wav = wav * (32767 / max(0.01, np.max(np.abs(wav))))
    wavfile.write(path, sample_rate, wav.astype(np.int16))
