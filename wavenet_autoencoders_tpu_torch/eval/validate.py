"""Lightweight ZeroSpeech-2019 submission validator (a copy of
``wavenet_autoencoders_tpu/eval/validate.py``).

The challenge's own validator (``zerospeech2020-validate``, invoked by the
reference's ``bin/run_valid.sh:8``) is an external package that cannot be
installed offline. This performs the structural and format checks that
tool applies to the 2019 track so a submission tree can be sanity-checked
before shipping:

- ``2019/<lan>/test/`` exists and contains the expected artifact kinds;
- every ABX ``.txt`` parses as a float matrix (rows = frames) with a
  consistent column count across the corpus;
- every synthesized ``.wav`` is a readable RIFF/PCM file with > 0 samples
  and an integer PCM or float encoding;
- file stems are non-empty and unique.

It is a stand-in, not a replica: the external tool additionally checks
utterance-list completeness against the challenge dataset (impossible
offline) and metadata.yaml fields.
"""
from __future__ import annotations

from pathlib import Path

import numpy as np


class ValidationError(ValueError):
    pass


def _check_txt(path: Path, n_cols: int | None) -> int:
    try:
        mat = np.loadtxt(path, ndmin=2)
    except Exception as e:
        raise ValidationError(f"{path}: not a parseable float matrix ({e})")
    if mat.size == 0 or mat.shape[0] < 1:
        raise ValidationError(f"{path}: empty representation")
    if not np.isfinite(mat).all():
        raise ValidationError(f"{path}: non-finite values")
    if n_cols is not None and mat.shape[1] != n_cols:
        raise ValidationError(
            f"{path}: {mat.shape[1]} columns, expected {n_cols} (must be "
            "consistent across the corpus)"
        )
    return mat.shape[1]


def _check_wav(path: Path) -> None:
    from scipy.io import wavfile

    try:
        sr, data = wavfile.read(path)
    except Exception as e:
        raise ValidationError(f"{path}: unreadable wav ({e})")
    if sr <= 0 or np.size(data) == 0:
        raise ValidationError(f"{path}: empty wav")


def validate_submission(root: str | Path, lan: str = "english") -> dict:
    """Raise ValidationError on the first problem; return a summary dict
    {"txt": n, "wav": n, "txt_cols": d} on success."""
    test_dir = Path(root) / "2019" / lan / "test"
    if not test_dir.is_dir():
        raise ValidationError(f"missing submission dir {test_dir}")
    txts = sorted(test_dir.glob("*.txt"))
    wavs = sorted(test_dir.glob("*.wav"))
    if not txts and not wavs:
        raise ValidationError(f"{test_dir}: no .txt or .wav artifacts")
    stems = [p.stem for p in txts]
    if len(set(stems)) != len(stems):
        raise ValidationError("duplicate txt stems")
    n_cols = None
    for p in txts:
        n_cols = _check_txt(p, n_cols)
    for p in wavs:
        _check_wav(p)
    return {"txt": len(txts), "wav": len(wavs), "txt_cols": n_cols}
