"""Dataset manifest — the reference's ``train.txt`` contract (copy of
``wavenet_autoencoders_tpu/data/manifest.py:14-68``).

Each line: ``<utterance_dump_dir>|<n_frames>|<speaker_ind>|<text>``; the
per-utterance dir contains ``wave.npy``, ``mel.npy``, ``mfcc.npy`` and,
after normalization, ``{mel,mfcc}.norm.npy``.
"""
from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path


@dataclass
class Utterance:
    prefix: str       # dump-dir prefix the npy names append to
    n_frames: int
    speaker_id: int   # -1 == unknown / single speaker
    text: str = "dummy"

    def path(self, typ: str, norm: bool = False) -> str:
        suffix = f"{typ}.norm.npy" if norm else f"{typ}.npy"
        return self.prefix + suffix


class Manifest:
    def __init__(self, utterances: list[Utterance]):
        self.utterances = utterances

    def __len__(self):
        return len(self.utterances)

    def __getitem__(self, i):
        return self.utterances[i]

    @property
    def multi_speaker(self) -> bool:
        # the first line's speaker field != -1
        return bool(self.utterances) and self.utterances[0].speaker_id != -1

    @classmethod
    def read(cls, dump_root: str | Path) -> "Manifest":
        meta = Path(dump_root) / "train.txt"
        if not meta.exists():
            raise FileNotFoundError(f"{meta} does not exist")
        utts = []
        for line in meta.read_text(encoding="utf-8").splitlines():
            if not line.strip():
                continue
            parts = line.split("|")
            utts.append(
                Utterance(
                    prefix=parts[0],
                    n_frames=int(parts[1]),
                    speaker_id=int(parts[2]),
                    text=parts[3] if len(parts) > 3 else "dummy",
                )
            )
        return cls(utts)


def write_manifest(entries, out_dir: str | Path) -> None:
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    with open(out_dir / "train.txt", "w", encoding="utf-8") as f:
        for m in entries:
            f.write("|".join(str(x) for x in m) + "\n")
