"""What the quality runs on the card (chip_smoke phases 13-15) and the
port's runbooks rest on, against the JAX package on the CPU:

- the frozen configs of run F (``quality2/exp/inwae_r5/config.json``: IN-WAE
  with AdaIN, frame rate 50, upsample 4 x 4 x 4 x 5, encoder 384, gin 64)
  and run K (``svqwae_r5_cs0005``: sliced VQ, commitment scale 0.005),
  narrowed to 2 layers and small widths at B=2, through three train steps
  in both packages from the same weights and batch, unfused and fused (the
  port's plain K2/K3 against the interpret-mode Pallas stack), at
  ``tests/test_torch_port_train.py``'s tolerances: metrics 1e-5 relative,
  parameters 2e-5 abs on live elements, Adam moments 1e-4 of the largest
  (the first moment holds the gradients);
- the log-window reader the phases hold their runs with, on the committed
  logs of run K and run F;
- ``bin/torch/*.sh``: each is its ``bin/`` sibling on the port's CLI, and
  ``bin/torch/run_pre.sh`` writes the files ``bin/run_pre.sh`` writes, byte
  for byte, on the wav tree of ``tests/test_e2e.py``.
"""
import os
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import pytest
from scipy.io import wavfile

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402

from _torch_port_util import to_np  # noqa: E402
from test_torch_port_train import assert_states_close, torch_batch  # noqa: E402
from wavenet_autoencoders_tpu.config import Config as JConfig  # noqa: E402
from wavenet_autoencoders_tpu.models.zoo import build_model as jbuild  # noqa: E402
from wavenet_autoencoders_tpu.train import init_state as jinit  # noqa: E402
from wavenet_autoencoders_tpu.train import make_train_step as jmake  # noqa: E402
from wavenet_autoencoders_tpu_torch.config import Config  # noqa: E402
from wavenet_autoencoders_tpu_torch.models import build_model  # noqa: E402
from wavenet_autoencoders_tpu_torch.quality import recon  # noqa: E402
from wavenet_autoencoders_tpu_torch.train.step import init_state, make_train_step  # noqa: E402
from wavenet_autoencoders_tpu_torch.utils.params import load_jax_params  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
QUALITY = ROOT / "quality2" / "exp"
RUN_F = QUALITY / "inwae_r5" / "config.json"
# the frozen configs of run K (SVQ-WAE) and run F (IN-WAE), narrowed to 2
# layers and small widths at B=2: frame rate 50, hop 160, upsample
# 4 x 4 x 4 x 5, the mu-law output, run F's AdaIN and run K's instance norm,
# sliced VQ (2 slices), commitment scale 0.005 and reseed settings kept;
# encoder_hid and gin away from the presets' (768, 32 or -1); run K's VQ
# warm-up (1000 steps) cut to 2, so the three steps cross it
NARROW = dict(layers=2, stacks=1, residual_channels=16, gate_channels=24, skip_out_channels=16, encoder_hid=24,
              cin_channels=8, gin_channels=6, n_speakers=8, batch_size=2, max_time_steps=1280,
              compute_dtype="float32", clip_thresh=1.0)
QUALITY_CONFIGS = {"run_K": ("svqwae_r5_cs0005", {"K": 8, "vq_warmup_steps": 2}), "run_F": ("inwae_r5", {})}
# run E (svqwae_r4j: time jitter from step 0, per_side false, frame rate
# 25), narrowed as run K; tests/test_torch_port_loop_parity.py runs its loops
LOOP_CONFIGS = {"run_E": ("svqwae_r4j", {"K": 8, "vq_warmup_steps": 2})}


def quality_cfgs(run, **over):
    """(JAX Config, port Config) of a narrowed quality config."""
    name, extra = {**QUALITY_CONFIGS, **LOOP_CONFIGS}[run]
    over = {**NARROW, **extra, **over}
    path = QUALITY / name / "config.json"
    return JConfig.load(path).replace(**over), Config.load(path).replace(**over)


def quality_pair(run, fused):
    """JAX (state, step_fn) and port (cfg, model, state, step_fn) of a
    narrowed quality config with the same initial weights (JAX init from
    key 0)."""
    jcfg, cfg = quality_cfgs(run, fused_stack=fused)
    jmodel = jbuild(jcfg)
    js = jinit(jcfg, jmodel, jax.random.PRNGKey(0))
    model = build_model(cfg, device="cpu")
    load_jax_params(model, to_np(js.params))
    return (js, jmake(jcfg, jmodel, donate=False)), (cfg, model, init_state(cfg, model), make_train_step(cfg, model))


def quality_batch(B=2, T=1280, hop=160, seed=0):
    rng = np.random.default_rng(seed)
    return {
        "x": rng.integers(0, 256, (B, T)).astype(np.int32),
        "y": rng.integers(0, 256, (B, T, 1)).astype(np.int32),
        "c": rng.standard_normal((B, T // hop, 39)).astype(np.float32),
        "g": np.array([1, 5], np.int32)[:B],
        "lengths": np.array([T, T - 5], np.int32)[:B],
    }


def test_run_f_config_reaches_the_port_inwae():
    cfg = Config.load(RUN_F)
    model = build_model(cfg.replace(layers=2, residual_channels=16, gate_channels=24, skip_out_channels=16),
                        device="cpu")
    assert type(model).__name__ == "INWAE" and model.adain and not cfg.ins_norm
    assert (model.encoder_hid, model.wavenet.gin_channels, cfg.frame_rate) == (384, 64, 50)
    assert model.encoder.blocks[0].w.shape[-1] == 384


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
@pytest.mark.parametrize("run", sorted(QUALITY_CONFIGS))
def test_quality_config_narrowed_train_steps_match_jax(run, fused):
    (js, jstep), (cfg, model, st, step) = quality_pair(run, fused)
    assert type(model).__name__ == {"run_K": "VQWAE", "run_F": "INWAE"}[run]
    assert (model.encoder_hid, model.wavenet.gin_channels, cfg.frame_rate) == (24, 6, 50)
    assert cfg.upsample_params["upsample_scales"] == [4, 4, 4, 5]
    if run == "run_F":
        assert model.adain and not cfg.ins_norm
    else:
        assert model.sliced and model.ins_norm and cfg.vq_commit_scale == 0.005
    b = quality_batch()
    for _ in range(3):
        js, jm = jstep(js, b, jax.random.PRNGKey(1))
        st, m = step(st, torch_batch(b))
        for k in ("loss", "recon_loss", "aux_loss", "perplexity", "grad_norm", "lr"):
            np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-5, err_msg=k)
    assert_states_close(js, st)


@pytest.mark.parametrize("run", sorted(QUALITY_CONFIGS))
def test_quality_config_abx_export_matches_jax(run, tmp_path):
    """The ABX export the quality phases score (``export_representations``:
    run K's sliced codes, run F's continuous latent) of a narrowed quality
    config, the same weights in both packages. The files agree within 1e-5
    abs (values up to ~4: the two encoders' f32 sums differ by 1-2e-6 of
    the largest value, measured at encoder widths 24 and 384, and the files
    round to '%.6f'); run K's bitrate over the same frames within 5% (it
    keys frames by their text, which that noise splits now and then)."""
    import json

    from test_torch_port_serve import _corpus
    from wavenet_autoencoders_tpu.eval.infer import export_representations as jexport
    from wavenet_autoencoders_tpu_torch.eval.infer import export_representations

    jcfg, cfg = quality_cfgs(run)
    jmodel = jbuild(jcfg)
    params, state = jmodel.init(jax.random.PRNGKey(3))
    model = build_model(cfg, device="cpu")
    load_jax_params(model, to_np(params))
    lengths = [37, 80, 230]
    scp, names = _corpus(tmp_path, lengths)
    assert jexport(jcfg, jmodel, params, state, str(scp), str(tmp_path / "jax")) == 3
    assert export_representations(cfg, model, str(scp), str(tmp_path / "port"), device="cpu") == 3
    for n, frames in zip(names, lengths):
        a, b = (np.loadtxt(tmp_path / d / "2019" / "english" / "test" / f"{n}.txt") for d in ("jax", "port"))
        assert a.shape == b.shape == (-(-frames // 2), 8)
        np.testing.assert_allclose(b, a, atol=1e-5, rtol=0)
    rates = [tmp_path / d / "bitrate.json" for d in ("jax", "port")]
    assert [p.exists() for p in rates] == [run == "run_K"] * 2
    if run == "run_K":
        ra, rb = (json.loads(p.read_text()) for p in rates)
        assert ra["n_frames"] == rb["n_frames"]
        np.testing.assert_allclose(rb["bitrate"], ra["bitrate"], rtol=0.05)


@pytest.mark.parametrize("run,first,last,lines,mean", [
    ("svqwae_r5_cs0005", 3550, 4000, 10, 3.0477),
    ("svqwae_r5_cs0005", 1050, 1500, 10, 3.2041),
    ("inwae_r5", 2550, 3000, 10, 3.0595),
], ids=["run_K_4000", "run_K_1500", "run_F_3000"])
def test_log_window_reads_the_held_records(run, first, last, lines, mean):
    got, m = recon.log_window(QUALITY / run, first, last)
    assert [r["step"] for r in got] == list(range(first, last + 1, 50))
    assert len(got) == lines and round(m, 4) == mean
    assert all(r["phase"] == "train_no_dev" for r in got)


def test_log_window_counts_the_closing_line_once(tmp_path):
    """The loop's closing line repeats the last step: one line, its loss once."""
    import json

    (tmp_path / "logs").mkdir()
    recs = [{"step": s, "phase": "train_no_dev", "loss": float(s)} for s in (1, 50, 100, 100)]
    recs.insert(2, {"step": 1, "phase": "train_no_dev_epoch", "loss": 9.0})
    (tmp_path / "logs" / "metrics.jsonl").write_text("".join(json.dumps(r) + "\n" for r in recs))
    got, m = recon.log_window(tmp_path, 50, 100)
    assert [r["step"] for r in got] == [50, 100] and m == 75.0
    assert recon.log_window(tmp_path, 200, 300)[0] == []


RUNBOOKS = ("run_pre.sh", "train.sh", "resume.sh", "run_infer19.sh", "run_syn.sh", "run_eval19.sh")


@pytest.mark.parametrize("name", RUNBOOKS)
def test_runbook_is_its_jax_sibling_on_the_port_cli(name):
    """Same arguments, stages and commands as ``bin/<name>``, with the
    JAX CLI module replaced by the port's (comments aside)."""
    def body(path):
        return [line for line in path.read_text().splitlines() if not line.startswith("#")]

    jax_lines, port_lines = body(ROOT / "bin" / name), body(ROOT / "bin" / "torch" / name)
    assert any("wavenet_autoencoders_tpu.cli.main" in line for line in jax_lines)
    assert [line.replace("wavenet_autoencoders_tpu.cli.main", "wavenet_autoencoders_tpu_torch.cli.main")
            for line in jax_lines] == port_lines
    assert os.access(ROOT / "bin" / "torch" / name, os.X_OK)


def _e2e_tree(raw: Path, sr=16000):
    """The wav tree of tests/test_e2e.py (its generator and seed)."""
    rng = np.random.default_rng(0)

    def make_wav(path, dur, f0):
        t = np.arange(int(dur * sr)) / sr
        y = 0.4 * np.sin(2 * np.pi * f0 * t) + 0.02 * rng.standard_normal(len(t))
        path.parent.mkdir(parents=True, exist_ok=True)
        wavfile.write(path, sr, (np.clip(y, -1, 1) * 32767).astype(np.int16))

    for i in range(6):
        make_wav(raw / "english/train/unit" / f"S0{i % 3:02d}_{1000 + i}.wav", 0.5, 200 + 40 * i)
    for i in range(2):
        make_wav(raw / "english/train/voice" / f"V00{i + 1}_{2000 + i}.wav", 0.5, 150 + 30 * i)
    for i in range(2):
        make_wav(raw / "english/test" / f"S090_{3000 + i}.wav", 0.4, 300 + 50 * i)


def _files(root: Path) -> dict:
    """{relative path: bytes} of every file under ``root``, with ``root``
    itself written as <root> inside them (the manifests hold absolute paths)."""
    return {str(p.relative_to(root)): p.read_bytes().replace(str(root).encode(), b"<root>")
            for p in sorted(root.rglob("*")) if p.is_file()}


def test_torch_run_pre_writes_the_files_of_the_jax_run_pre():
    # a directory whose path holds no "test": preprocess trims silence only
    # for such wav paths (pytest's tmp paths hold it)
    with tempfile.TemporaryDirectory(prefix="wae_runbook_") as d:
        d = Path(d)
        _e2e_tree(d / "raw")
        shim = d / "bin"
        shim.mkdir()
        (shim / "python").write_text(f'#!/bin/sh\nexec "{sys.executable}" "$@"\n')
        (shim / "python").chmod(0o755)
        env = {**os.environ, "PATH": f"{shim}{os.pathsep}{os.environ['PATH']}", "JAX_PLATFORMS": "cpu",
               "PYTHONPATH": os.pathsep.join(filter(None, (str(ROOT), os.environ.get("PYTHONPATH"))))}
        for name, script in (("jax", ROOT / "bin" / "run_pre.sh"), ("port", ROOT / "bin" / "torch" / "run_pre.sh")):
            (d / name).mkdir()
            out = subprocess.run(["bash", str(script), "english", str(d / "raw"), "svqwae"], cwd=d / name, env=env,
                                 capture_output=True, text=True, timeout=600)
            assert out.returncode == 0, out.stderr[-3000:]
        jax_files, port_files = _files(d / "jax"), _files(d / "port")
    assert sorted(port_files) == sorted(jax_files)
    assert "cmvn_english.npz" in jax_files and "scp/2019/2019_speaker2ind_english.json" in jax_files
    assert sum(k.endswith("mfcc.norm.npy") for k in jax_files) == 10
    for k in jax_files:
        assert port_files[k] == jax_files[k], k
