"""A seeded raw-audio vocoder dump in the layout the port's loader reads
with ``WaveDataset(feat_type="mel")`` (``train.txt`` lines ``<utterance
dir>/|frames|-1|text``: no speakers; per utterance ``wave.npy`` float32
samples in [-1, 1] and ``mel.norm.npy`` float32 (frames, num_mels) in [0,
1], r9y9's normalised log-mel range), which the train driver feeds through
the port's ``data_iterator`` (the Python collator: the native loader takes
mu-law codes alone) in crops of the configuration's ``max_time_steps``.

Parameters (``traffic/<name>.json``): ``utterances``, ``seconds_min`` /
``seconds_max`` (lengths at the quantiles of a uniform distribution, the
same set for every seed, in a seeded order), ``level_min`` / ``level_max``
(the range of an utterance's RMS level), ``ref_level_db`` (r9y9's).

Each utterance is a voice of its own, so that the rows of a batch differ
as speech's do: AR(2) noise, as ``train_crops.py`` shapes its noise, here
with a resonance drawn per utterance (pole radius 0.5–0.95, angle 0.05π–
0.6π), at a level drawn per utterance, log-uniform over the range, under
an envelope that moves round it every ten frames (log-normal, σ 0.35).
The mel frames are computed from the samples as r9y9's ``audio.py``
computes them: a Hann-windowed STFT of ``fft_size`` at ``hop_size``
(centred, reflect-padded), the magnitudes through a triangular mel
filterbank of ``num_mels`` bands over ``fmin``–``fmax``, then
20·log10(max(1e-5, ·)) − ``ref_level_db``, normalised by ``min_level_db``
and clipped to [0, 1]; an utterance keeps ``frames`` = samples // hop of
them.
"""
from __future__ import annotations

from pathlib import Path

import numpy as np

DRIVER = "train"


def lengths(params: dict) -> np.ndarray:
    """Utterance lengths in seconds: the quantiles of a uniform
    distribution, the same for every seed."""
    n = int(params["utterances"])
    q = (np.arange(n) + 0.5) / n
    return params["seconds_min"] + q * (params["seconds_max"] - params["seconds_min"])


def mel_basis(sr: int, n_fft: int, n_mels: int, fmin: float, fmax: float) -> np.ndarray:
    """(n_mels, n_fft // 2 + 1) triangular filters, equally spaced on the
    mel scale, each of unit area."""
    to_mel = lambda f: 2595.0 * np.log10(1.0 + f / 700.0)  # noqa: E731
    edges = 700.0 * (10.0 ** (np.linspace(to_mel(fmin), to_mel(fmax), n_mels + 2) / 2595.0) - 1.0)
    f = np.linspace(0.0, sr / 2, n_fft // 2 + 1)
    lo, mid, hi = edges[:-2, None], edges[1:-1, None], edges[2:, None]
    return np.maximum(0.0, np.minimum((f - lo) / (mid - lo), (hi - f) / (hi - mid))) * (2.0 / (hi - lo))


def mel_frames(x: np.ndarray, frames: int, cfg: dict, basis: np.ndarray, ref_level_db: float) -> np.ndarray:
    n_fft, hop, min_db = cfg["fft_size"], cfg["hop_size"], cfg["min_level_db"]
    xp = np.pad(x.astype(np.float64), n_fft // 2, mode="reflect")
    idx = np.arange(frames)[:, None] * hop + np.arange(n_fft)[None, :]
    mag = np.abs(np.fft.rfft(xp[idx] * np.hanning(n_fft + 1)[:-1], axis=1))
    db = 20.0 * np.log10(np.maximum(1e-5, mag @ basis.T)) - ref_level_db
    return np.clip((db - min_db) / -min_db, 0.0, 1.0).astype(np.float32)


def generate(params: dict, cfg: dict, seed: int, out_dir: Path) -> Path:
    from scipy.signal import lfilter

    rng = np.random.default_rng(seed)
    hop, sr = cfg["hop_size"], cfg["sample_rate"]
    basis = mel_basis(sr, cfg["fft_size"], cfg["num_mels"], cfg["fmin"], cfg["fmax"])
    lo, hi = np.log(params["level_min"]), np.log(params["level_max"])
    out_dir.mkdir(parents=True, exist_ok=True)
    lines = []
    for i, sec in enumerate(rng.permutation(lengths(params))):
        frames = int(sec * sr) // hop
        n = frames * hop
        r, angle = rng.uniform(0.5, 0.95), rng.uniform(0.05, 0.6) * np.pi
        noise = lfilter([1.0], [1.0, -2.0 * r * np.cos(angle), r * r], rng.standard_normal(n))
        level = np.exp(rng.uniform(lo, hi) + rng.normal(0.0, 0.35, frames // 10 + 1))
        x = np.clip(noise / noise.std() * np.repeat(level, hop * 10)[:n], -1.0, 1.0).astype(np.float32)
        d = out_dir / f"{i:05d}"
        d.mkdir()
        np.save(d / "wave.npy", x)
        np.save(d / "mel.norm.npy", mel_frames(x, frames, cfg, basis, params["ref_level_db"]))
        lines.append(f"{d}/|{frames}|-1|bench")
    (out_dir / "train.txt").write_text("\n".join(lines) + "\n")
    return out_dir
