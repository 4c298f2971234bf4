"""The ``vocoder_raw`` configuration's own pieces on the CPU: a tiny cell
shaped as it (raw samples, the 65,536-level MoL, mel features with cin_pad
2, no speakers; 4 layers at widths of 16, trained in float32 as
``bench_tiny.py`` says why) runs through ``run.run_cell`` with the real
``reference/vocoder.py`` and the real ``traffic/raw_mel_crops.py`` and
comes out correct under ``vocoder_raw-train``'s limits; with a step that leaves its
state unchanged, or one that takes half of the batch, in the program's place
it does not; and the traffic generator writes what its docstring says."""
import json
import shutil
from pathlib import Path

import numpy as np
import pytest

import run
from benchlib import cells
from test_bench_cpu_runs import half_batch, unchanged

HERE = Path(__file__).resolve().parent.parent
SEED = 2**31 + 41
TINY = dict(layers=4, stacks=2, residual_channels=16, gate_channels=16, skip_out_channels=16, batch_size=4,
            max_time_steps=1024, compute_dtype="float32")


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = tmp_path_factory.mktemp("bench") / "benchmarks"
    shutil.copytree(HERE, root, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    cfg = {**json.loads((root / "configs" / "vocoder_raw.json").read_text()), **TINY}
    (root / "configs" / "tiny_vocoder_raw.json").write_text(json.dumps(cfg))
    traffic = json.loads((root / "traffic" / "raw_mel_dump.json").read_text())
    (root / "traffic" / "tiny_raw_mel.json").write_text(json.dumps(
        {**traffic, "utterances": 12, "seconds_min": 0.2, "seconds_max": 0.5}))
    w = json.loads((root / "workloads" / "vocoder_raw-train.json").read_text())
    (root / "workloads" / "tiny-vocoder-train.json").write_text(json.dumps(
        {**w, "config": "tiny_vocoder_raw", "traffic": "tiny_raw_mel"}))
    return root


def test_the_cell_names_the_vocoder_reference_and_mel():
    cell = cells.load_cell("vocoder_raw-train")
    assert cell.features == "mel" and cell.kind == "train" and cell.chips == 1
    assert Path(cell.reference().__file__) == HERE / "reference" / "vocoder.py"
    cfg = cells.model_config(cell.config)
    assert cfg["name"] == "wavenet_vocoder" and cfg["input_type"] == "raw" and cfg["gin_channels"] == -1
    assert (cfg["out_channels"], cfg["quantize_channels"], cfg["log_scale_min"]) == (30, 65536, -16.0)


def test_a_sound_tiny_vocoder_run_is_correct(root):
    out = run.run_cell("tiny-vocoder-train", SEED, 0.3, False, device="cpu", root=root)
    assert out["correct"], out["checks"]
    assert out["attempted"] >= 1 and out["failed"] == 0
    assert set(out["checks"]) == set(json.loads((HERE / "workloads" / "vocoder_raw-train.json").read_text())["limits"])


@pytest.mark.parametrize("fault", [unchanged, half_batch], ids=["state_unchanged", "half_batch"])
def test_a_broken_vocoder_step_is_not_correct(root, fault):
    out = run.run_cell("tiny-vocoder-train", SEED, 0.3, False, device="cpu", hooks={"step": fault}, root=root)
    assert not out["correct"], out["checks"]


def _files(d: Path) -> dict:
    return {p.relative_to(d): p.read_bytes() for p in sorted(d.rglob("*")) if p.is_file()}


def test_the_raw_mel_crops_generator(tmp_path):
    gen = cells.load_module(HERE / "traffic" / "raw_mel_crops.py", "bench_traffic_raw_mel_crops_probe")
    params = {**json.loads((HERE / "traffic" / "raw_mel_dump.json").read_text()), "utterances": 8}
    cfg = cells.model_config(json.loads((HERE / "configs" / "vocoder_raw.json").read_text()))
    secs = gen.lengths(params)
    assert np.allclose(secs, 1.1 + 9.0 * (np.arange(8) + 0.5) / 8)
    a = gen.generate(params, cfg, SEED, tmp_path / "a")
    b = gen.generate(params, cfg, SEED, tmp_path / "b")
    c = gen.generate(params, cfg, SEED + 1, tmp_path / "c")

    def lines(d):
        return [x.split("|") for x in (d / "train.txt").read_text().splitlines()]

    strip = lambda d: {k: v for k, v in _files(d).items() if k.name != "train.txt"}  # noqa: E731
    assert strip(a) == strip(b) and [x[1:] for x in lines(a)] == [x[1:] for x in lines(b)]
    assert strip(a) != strip(c)
    hop, sr = cfg["hop_size"], cfg["sample_rate"]
    assert sorted(int(x[1]) for x in lines(a)) == sorted(int(s * sr) // hop for s in secs)
    rms, loudness = [], []
    for prefix, frames, speaker, _ in lines(a):
        assert speaker == "-1"
        wave, mel = np.load(prefix + "wave.npy"), np.load(prefix + "mel.norm.npy")
        rms.append(float(wave.std()))
        loudness.append(float(mel.mean()))
        assert wave.dtype == np.float32 and wave.shape == (int(frames) * hop,)
        assert np.abs(wave).max() <= 1.0 and wave.std() > 0.01
        assert mel.dtype == np.float32 and mel.shape == (int(frames), cfg["num_mels"]) == (int(frames), 80)
        assert mel.min() >= 0.0 and mel.max() <= 1.0 and mel.std() > 0.01
    # each utterance at a level of its own, and the mel frames follow it
    assert max(rms) / min(rms) > 3
    assert np.corrcoef(np.log(rms), loudness)[0, 1] > 0.9
