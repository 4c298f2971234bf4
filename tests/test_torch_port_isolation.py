"""The PyTorch port stands alone: it imports neither JAX nor anything of the
JAX package, and its entry points refuse to fall back to the CPU."""
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from _torch_port_util import TINY_SVQWAE  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "wavenet_autoencoders_tpu_torch"
SOURCES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]

_IMPORT_ALL = r"""
import importlib, pkgutil, sys
import wavenet_autoencoders_tpu_torch as p
for m in pkgutil.walk_packages(p.__path__, p.__name__ + "."):
    importlib.import_module(m.name)
import chip_smoke
bad = sorted(n for n in sys.modules
             if n.split(".")[0] in ("jax", "jaxlib")
             or n == "wavenet_autoencoders_tpu" or n.startswith("wavenet_autoencoders_tpu."))
print(len([n for n in sys.modules if n.startswith("wavenet_autoencoders_tpu_torch")]), bad)
sys.exit(1 if bad else 0)
"""


def test_importing_every_module_loads_no_jax_and_no_jax_package():
    out = subprocess.run(
        [sys.executable, "-c", _IMPORT_ALL], cwd=ROOT, capture_output=True, text=True, timeout=120
    )
    assert out.returncode == 0, out.stdout + out.stderr
    n_loaded = int(out.stdout.split()[0])
    assert n_loaded >= 25, out.stdout


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_source_names_no_jax_and_no_jax_package(path):
    text = path.read_text()
    assert not re.search(r"^\s*(import|from)\s+jax(lib)?\b", text, re.M)
    assert not re.search(r"\bwavenet_autoencoders_tpu\.", text)
    assert "from wavenet_autoencoders_tpu import" not in text


def test_jax_random_is_among_the_sources_checked():
    """The JAX PRNG of the port is torch ops: its source is one of the files
    checked above, and it runs with no JAX loaded."""
    assert PORT / "utils" / "jax_random.py" in SOURCES
    out = subprocess.run(
        [sys.executable, "-c", "import sys; from wavenet_autoencoders_tpu_torch.utils import jax_random as jr; "
                               "jr.normal(jr.PRNGKey(0), (3,)); print(any(n.split('.')[0] in ('jax', 'jaxlib') "
                               "for n in sys.modules))"],
        cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "False", out.stdout + out.stderr


def _no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_build_model_default_device_refuses_cpu(monkeypatch):
    from wavenet_autoencoders_tpu_torch.config import load_preset
    from wavenet_autoencoders_tpu_torch.models import build_model

    _no_cuda(monkeypatch)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_model(load_preset("svqwae", TINY_SVQWAE))


def test_serving_entry_points_default_device_refuse_cpu(monkeypatch, tmp_path):
    from wavenet_autoencoders_tpu_torch.config import load_preset
    from wavenet_autoencoders_tpu_torch.eval.infer import export_representations
    from wavenet_autoencoders_tpu_torch.eval.synthesize import batch_wavegen
    from wavenet_autoencoders_tpu_torch.models import build_model

    cfg = load_preset("svqwae", TINY_SVQWAE)
    model = build_model(cfg, device="cpu")
    _no_cuda(monkeypatch)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        batch_wavegen(cfg, model, np.zeros((1, 8, 39), np.float32))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        export_representations(cfg, model, str(tmp_path / "scp.json"), str(tmp_path))


def test_cli_default_device_refuses_cpu(monkeypatch, tmp_path):
    from wavenet_autoencoders_tpu_torch.cli.main import main

    _no_cuda(monkeypatch)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(["infer", "--preset", "svqwae", str(tmp_path / "c.npz"), "scp.json", str(tmp_path)])


def test_train_entry_points_default_device_refuse_cpu(monkeypatch, tmp_path):
    from wavenet_autoencoders_tpu_torch.cli.main import main
    from wavenet_autoencoders_tpu_torch.config import load_preset
    from wavenet_autoencoders_tpu_torch.train.loop import train

    _no_cuda(monkeypatch)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train(load_preset("svqwae", TINY_SVQWAE), str(tmp_path), str(tmp_path / "exp"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(["train", "--preset", "svqwae", str(tmp_path), str(tmp_path / "exp")])


def test_unknown_model_name_raises():
    from wavenet_autoencoders_tpu_torch.config import load_preset
    from wavenet_autoencoders_tpu_torch.models import build_model

    with pytest.raises(ValueError, match="unknown model name: no_such_model"):
        build_model(load_preset("inae", TINY_SVQWAE).replace(name="no_such_model"), device="cpu")


@pytest.mark.parametrize("module", ["parallel/distributed.py", "parallel/mesh.py", "data/native.py",
                                    "train/supervisor.py", "utils/torch_import.py", "utils/params.py",
                                    "ops/conv.py", "ops/modules.py", "models/encoder.py", "models/wavenet.py",
                                    "train/step.py", "train/checkpoint.py", "train/loop.py",
                                    "quality/__main__.py", "quality/corpus.py", "quality/recon.py", "quality/abx.py",
                                    "quality/vc_f0.py", "quality/ce_by_segment.py", "quality/run.py",
                                    "quality/trajectory.py", "quality/report.py"])
def test_data_parallel_loader_and_supervisor_modules_are_held_to_it(module):
    """The modules of the data-parallel slice, the tensor-parallel slice
    (the mesh, its collectives and the layers and training code they
    shard) and the reference-checkpoint importer are among the sources
    checked above and the modules imported; the loader's C++ source is the
    port's own copy (the port shares no file with the JAX package)."""
    assert PORT / module in SOURCES
    assert not re.search(r"^\s*(import|from)\s+jax(lib)?\b", (PORT / module).read_text(), re.M)
    assert (PORT / "native" / "dataload.cpp").exists()
    out = subprocess.run(
        [sys.executable, "-c", f"import sys, wavenet_autoencoders_tpu_torch.{module[:-3].replace('/', '.')}; "
                               "print(sorted(n for n in sys.modules if n.split('.')[0] in ('jax', 'jaxlib') "
                               "or n.startswith('wavenet_autoencoders_tpu.')))"],
        cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "[]", out.stdout + out.stderr


# the repo's quality scripts, by the module names they import under
QUALITY_SCRIPTS = ("make_synth_corpus", "abx_proxy", "quality_eval", "vc_f0_check", "ce_by_segment",
                   "run_quality_train", "run_quality_infer", "track_abx", "assemble_trajectory", "quality_report")


@pytest.mark.parametrize("module", ["corpus", "recon", "abx", "vc_f0", "ce_by_segment", "run", "trajectory",
                                    "report", "__main__"])
def test_quality_modules_import_without_side_effects(module, tmp_path):
    """Importing a quality module loads no JAX, nothing of the JAX package
    or of ``scripts/``, and leaves the working directory and ``sys.path``
    as they were."""
    code = (
        "import os, sys; cwd, path = os.getcwd(), list(sys.path); "
        f"import wavenet_autoencoders_tpu_torch.quality.{module}; "
        "bad = sorted(n for n in sys.modules if n.split('.')[0] in ('jax', 'jaxlib') "
        f"or n.startswith('wavenet_autoencoders_tpu.') or n in {QUALITY_SCRIPTS!r}); "
        "print(bad, os.getcwd() == cwd, sys.path == path)"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True, text=True, timeout=120,
                         env={**__import__("os").environ, "PYTHONPATH": str(ROOT)})
    assert out.returncode == 0 and out.stdout.split() == ["[]", "True", "True"], out.stdout + out.stderr
    text = (PORT / "quality" / f"{module}.py").read_text()
    assert "sys.path" not in text and "os.chdir" not in text


def test_quality_entry_points_default_device_refuse_cpu(monkeypatch, tmp_path):
    """The model-touching quality tools run on cuda unless asked for the CPU."""
    from wavenet_autoencoders_tpu_torch.config import load_preset
    from wavenet_autoencoders_tpu_torch.models import build_model
    from wavenet_autoencoders_tpu_torch.quality import ce_by_segment, recon, run, trajectory

    cfg = load_preset("svqwae", TINY_SVQWAE)
    cfg.save(tmp_path / "config.json")  # the preset infer reads beside the checkpoint
    model = build_model(cfg, device="cpu")
    _no_cuda(monkeypatch)
    for call in (lambda: ce_by_segment.ce_by_segment(cfg, model, tmp_path),
                 lambda: recon.reconstruction_metrics(cfg, model, tmp_path),
                 lambda: run.train_main(["--root", str(tmp_path)]),
                 lambda: run.infer_main(["--root", str(tmp_path), "c.npz", "abx"]),
                 lambda: trajectory.track(str(tmp_path), "c.npz", "t")):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
