"""A copy of the benchmark folder with tiny cells beside the real ones, for
runs on the CPU: the configurations cut to 4 layers and widths of 16, the
dump to 16 utterances, the
training computed in float32 (at widths of 16 the bf16 path's gaps are
those of single units, not of the program). Each tiny cell keeps the
limits of the real cell it stands for."""
import json
import shutil
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent
NARROW = dict(layers=4, stacks=2, residual_channels=16, gate_channels=16, skip_out_channels=16, cin_channels=8,
              gin_channels=4, n_speakers=5, encoder_hid=16, batch_size=4, max_time_steps=1280,
              compute_dtype="float32")
CELLS = {"tiny-train": ("svqwae", "svqwae-train", "tiny_dump"), "tiny-in-train": ("inae", "inae-train", "tiny_dump")}


def make(root: Path) -> Path:
    shutil.copytree(HERE, root, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    for name in ("svqwae", "inae"):
        c = json.loads((root / "configs" / f"{name}.json").read_text())
        c.update(NARROW, **({"K": 8} if name == "svqwae" else {}))
        (root / "configs" / f"tiny_{name}.json").write_text(json.dumps(c))
    t = json.loads((root / "traffic" / "train_dump.json").read_text())
    (root / "traffic" / "tiny_dump.json").write_text(json.dumps({**t, "utterances": 16}))
    for cell, (cfg, real, traffic) in CELLS.items():
        w = json.loads((root / "workloads" / f"{real}.json").read_text())
        w.update(config=f"tiny_{cfg}", traffic=traffic)
        (root / "workloads" / f"{cell}.json").write_text(json.dumps(w))
    return root


def limits(real: str) -> dict:
    return json.loads((HERE / "workloads" / f"{real}.json").read_text())["limits"]
