"""Metrics: ``<dir>/metrics.jsonl``, one JSON record per call (counterpart
of ``wavenet_autoencoders_tpu/train/metrics.py:14-39``). TensorBoard event
files are written too when tensorboardX is importable; it is never
required."""
from __future__ import annotations

import json
import time
from pathlib import Path


class MetricsWriter:
    def __init__(self, log_dir: str | Path, use_tensorboard: bool = True):
        self.dir = Path(log_dir)
        self.dir.mkdir(parents=True, exist_ok=True)
        self._f = open(self.dir / "metrics.jsonl", "a", buffering=1)
        self._tb = None
        if use_tensorboard:
            try:
                from tensorboardX import SummaryWriter
            except ImportError:
                pass
            else:
                self._tb = SummaryWriter(str(self.dir))

    def scalars(self, step: int, phase: str, values: dict) -> None:
        rec = {"step": int(step), "phase": phase, "time": time.time()}
        rec.update({k: float(v) for k, v in values.items()})
        self._f.write(json.dumps(rec) + "\n")
        if self._tb is not None:
            for k, v in values.items():
                self._tb.add_scalar(f"{phase} {k}", float(v), int(step))

    def close(self):
        self._f.close()
        if self._tb is not None:
            self._tb.close()
