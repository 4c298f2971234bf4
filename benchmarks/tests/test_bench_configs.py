"""A configuration names its own plain reference (``reference``) and the
features its dump holds (``features``), so that a configuration of another
family of the port's zoo is added by files alone. In a copy of the folder:
a cell whose configuration names a reference module that exists only in
the copy runs through that module; and a tiny cell shaped as the raw-audio
WaveNet vocoder (raw samples, a mixture-of-logistics output, mel features,
no speakers), fed by a traffic generator written in the copy, hands its
reference the batches of its window's own feed. The vocoder's reference
here is a stub that records what it was given: this checks the plumbing,
not the vocoder's correctness."""
import json
from pathlib import Path

import pytest

import run
import bench_tiny as tiny
from benchlib import cells

HERE = Path(__file__).resolve().parent.parent
PRESETS = HERE.parent / "wavenet_autoencoders_tpu_torch" / "presets"
SEED = 2**31 + 29

#: a reference module that records each call's mode, batches and
#: configuration keys in ``<its name>.calls.jsonl`` beside itself, then
#: hands on to ``inner`` (a module of the same folder) or, without one,
#: returns a stub
RECORDER = '''
import json
from pathlib import Path

import torch

INNER = {inner!r}
LOG = Path(__file__).with_suffix(".calls.jsonl")


def _inner():
    import importlib.util

    spec = importlib.util.spec_from_file_location("recorded_" + INNER, Path(__file__).with_name(INNER + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def precision():
    import contextlib

    return _inner().precision() if INNER else contextlib.nullcontext()


def train_steps(w0, batches, cfg, mode="f32", block=8, rows_used=None, frozen=False):
    seen = [{{k: [str(v.dtype), list(v.shape)] for k, v in b.items()}} for b in batches]
    with LOG.open("a") as f:
        f.write(json.dumps({{"mode": mode, "batches": seen, "cfg": sorted(cfg),
                            "lengths": [b["lengths"].tolist() for b in batches]}}) + "\\n")
    if INNER:
        return _inner().train_steps(w0, batches, cfg, mode, block=block, rows_used=rows_used, frozen=frozen)
    dtype = torch.float64 if mode == "f64" else torch.float32
    p = {{k: v.detach().clone().to(dtype) for k, v in w0.items()}}
    return {{"losses": [1.0] * len(batches), "first_grad": {{k: torch.ones_like(v) for k, v in p.items()}},
            "params": p, "ema": None}}
'''

#: raw samples in [-1, 1] and unit mel frames, one speaker (-1), the
#: lengths at the quantiles of a log-uniform distribution
RAW_MEL = '''
import numpy as np

DRIVER = "train"


def generate(params, cfg, seed, out_dir):
    rng = np.random.default_rng(seed)
    hop, sr = cfg["hop_size"], cfg["sample_rate"]
    n = int(params["utterances"])
    q = (np.arange(n) + 0.5) / n
    secs = np.exp(np.log(params["seconds_min"]) + q * np.log(params["seconds_max"] / params["seconds_min"]))
    out_dir.mkdir(parents=True, exist_ok=True)
    lines = []
    for i, sec in enumerate(rng.permutation(secs)):
        frames = int(sec * sr) // hop
        d = out_dir / f"{i:05d}"
        d.mkdir()
        np.save(d / "wave.npy", np.clip(0.1 * rng.standard_normal(frames * hop), -1, 1).astype(np.float32))
        np.save(d / "mel.norm.npy", rng.standard_normal((frames, cfg["num_mels"])).astype(np.float32))
        lines.append(f"{d}/|{frames}|-1|bench")
    (out_dir / "train.txt").write_text("\\n".join(lines) + "\\n")
    return out_dir
'''


def unchanged(root: Path) -> list[str]:
    """The files of the folder that the copy holds otherwise than here."""
    return [str(p.relative_to(HERE)) for p in HERE.rglob("*")
            if p.is_file() and "tests" not in p.parts and "__pycache__" not in p.parts
            and (root / p.relative_to(HERE)).read_bytes() != p.read_bytes()]


def calls(root: Path, module: str) -> list[dict]:
    return [json.loads(x) for x in (root / "reference" / f"{module}.calls.jsonl").read_text().splitlines()]


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.make(tmp_path_factory.mktemp("bench") / "benchmarks")


def test_the_defaults_are_the_wae_reference_and_mfcc():
    for name in ("svqwae", "inae"):
        cfg = json.loads((HERE / "configs" / f"{name}.json").read_text())
        assert "reference" not in cfg and "features" not in cfg
    cell = cells.load_cell("svqwae-train")
    assert cell.features == "mfcc" and Path(cell.reference().__file__) == HERE / "reference" / "wae.py"
    cfg = {"name": "vqvae", "assumed": {}, "reference": "wae", "features": "mel"}
    assert cells.model_config(cfg) == {"name": "vqvae"}


def test_a_configuration_runs_through_the_reference_it_names(root):
    (root / "reference" / "wae_recorded.py").write_text(RECORDER.format(inner="wae"))
    c = json.loads((root / "configs" / "tiny_svqwae.json").read_text())
    (root / "configs" / "tiny_recorded.json").write_text(json.dumps({**c, "reference": "wae_recorded"}))
    w = json.loads((root / "workloads" / "tiny-train.json").read_text())
    (root / "workloads" / "tiny-recorded.json").write_text(json.dumps({**w, "config": "tiny_recorded"}))
    out = run.run_cell("tiny-recorded", SEED, 0.3, False, device="cpu", root=root)
    assert out["correct"], out["checks"]  # the named module hands on to the WAE reference
    seen = calls(root, "wae_recorded")
    assert [s["mode"] for s in seen] == ["f32", "f64"] and [len(s["batches"]) for s in seen] == [3, 1]
    assert all("reference" not in s["cfg"] and "name" in s["cfg"] for s in seen)
    assert unchanged(root) == []


def test_a_vocoder_shaped_cell_hands_its_reference_the_windows_feed(root):
    preset = json.loads((PRESETS / "vocoder_raw.json").read_text())
    cfg = {**preset, "layers": 4, "stacks": 2, "residual_channels": 16, "gate_channels": 16, "skip_out_channels": 16,
           "batch_size": 4, "max_time_steps": 1024, "compute_dtype": "float32", "fused_stack": True,
           "reference": "vocoder_stub", "features": "mel"}
    assert cfg["input_type"] == "raw" and cfg["gin_channels"] == -1 and cfg["out_channels"] == 30
    assert cfg["cin_channels"] == cfg["num_mels"] == 80 and cfg["cin_pad"] == 2
    (root / "configs" / "tiny_vocoder.json").write_text(json.dumps(cfg))
    (root / "reference" / "vocoder_stub.py").write_text(RECORDER.format(inner=""))
    (root / "traffic" / "raw_mel.py").write_text(RAW_MEL)
    (root / "traffic" / "tiny_raw_mel.json").write_text(json.dumps(
        {"kind": "raw_mel", "utterances": 12, "seconds_min": 0.2, "seconds_max": 0.5}))
    (root / "workloads" / "tiny-vocoder-train.json").write_text(json.dumps(
        {"config": "tiny_vocoder", "traffic": "tiny_raw_mel", "chips": 1, "limits": {"loss_gap": 1.0}}))
    cell = cells.load_cell("tiny-vocoder-train", root)
    assert cell.features == "mel" and cell.kind == "train"

    out = run.run_cell("tiny-vocoder-train", SEED, 0.3, False, device="cpu", root=root)
    assert out["attempted"] >= 1 and out["failed"] == 0
    assert set(out["metrics"]) == {"train_samples_per_s", "train_step_ms_p95", "setup_s"}
    assert set(out["checks"]) == {"loss_gap"}
    seen = calls(root, "vocoder_stub")
    assert [s["mode"] for s in seen] == ["f32", "f64"] and [len(s["batches"]) for s in seen] == [3, 1]
    B, T, hop, pad = 4, 1024, 256, 2
    for s in seen:
        assert "features" not in s["cfg"] and "reference" not in s["cfg"]
        for b, lengths in zip(s["batches"], s["lengths"]):
            assert set(b) == {"x", "c", "lengths"}  # no speakers without global conditioning
            assert b["x"] == ["torch.float32", [B, T]]  # raw samples, not codes
            assert b["c"] == ["torch.float32", [B, T // hop + 2 * pad, 80]]  # mel, with cin_pad frames each side
            assert b["lengths"][1] == [B] and lengths == [T] * B
    assert unchanged(root) == []
