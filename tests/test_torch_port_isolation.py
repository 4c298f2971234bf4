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
