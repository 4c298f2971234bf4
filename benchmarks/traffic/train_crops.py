"""A seeded training dump in the layout the port's loader reads
(``train.txt`` lines ``<utterance dir>/|frames|speaker|text``; per
utterance ``wave.npy`` int16 mu-law codes and ``mfcc.norm.npy`` float32
(frames, dim_in)), which the train driver feeds through the port's
``data_iterator`` in crops of the configuration's ``max_time_steps``.

Parameters (``traffic/<name>.json``): ``utterances``, ``seconds_min`` /
``seconds_max`` (lengths at the quantiles of a log-uniform distribution,
the same set for every seed, in a seeded order), ``level_min`` /
``level_max`` (the signal's RMS before companding). Speakers are uniform
over the configuration's ``n_speakers``. The waveform is pre-emphasised
AR(2) noise under a random envelope, so the codes cluster round silence
as speech's do; the features are unit-variance noise smoothed over three
frames, as normalised MFCCs are.
"""
from __future__ import annotations

from pathlib import Path

import numpy as np

DRIVER = "train"


def lengths(params: dict) -> np.ndarray:
    """Utterance lengths in seconds: the quantiles of a log-uniform
    distribution, the same for every seed."""
    n = int(params["utterances"])
    q = (np.arange(n) + 0.5) / n
    lo, hi = np.log(params["seconds_min"]), np.log(params["seconds_max"])
    return np.exp(lo + q * (hi - lo))


def generate(params: dict, cfg: dict, seed: int, out_dir: Path) -> Path:
    from scipy.signal import lfilter

    rng = np.random.default_rng(seed)
    hop, sr, mu = cfg["hop_size"], cfg["sample_rate"], cfg["quantize_channels"] - 1
    out_dir.mkdir(parents=True, exist_ok=True)
    lines = []
    for i, sec in enumerate(rng.permutation(lengths(params))):
        frames = int(sec * sr) // hop
        n = frames * hop
        noise = lfilter([1.0], [1.0, -1.3, 0.4], rng.standard_normal(n))
        env = np.repeat(np.exp(rng.uniform(np.log(params["level_min"]), np.log(params["level_max"]),
                                           frames // 10 + 1)), hop * 10)[:n]
        x = np.clip(noise / noise.std() * env, -1.0, 1.0)
        codes = ((np.sign(x) * np.log1p(mu * np.abs(x)) / np.log1p(mu) + 1.0) / 2.0 * mu + 0.5).astype(np.int16)
        feats = rng.standard_normal((frames + 2, cfg["dim_in"]))
        feats = ((feats[:-2] + feats[1:-1] + feats[2:]) / np.sqrt(3.0)).astype(np.float32)
        d = out_dir / f"{i:05d}"
        d.mkdir()
        np.save(d / "wave.npy", codes)
        np.save(d / "mfcc.norm.npy", feats)
        lines.append(f"{d}/|{frames}|{int(rng.integers(cfg['n_speakers']))}|bench")
    (out_dir / "train.txt").write_text("\n".join(lines) + "\n")
    return out_dir
