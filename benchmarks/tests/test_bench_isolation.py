"""Nothing the benchmark runs imports JAX or the JAX package, compared by
whole top-level names (the port's name begins with the package's), and
every plain reference under ``reference/`` imports nothing of the
program."""
import ast
import json
import subprocess
import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "wavenet_autoencoders_tpu"}


def imports(path: Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


def test_no_module_imports_jax_or_the_jax_package():
    sources = sorted(HERE.rglob("*.py"))
    assert len(sources) > 20
    for path in sources:
        assert not imports(path) & FORBIDDEN, path


def test_the_reference_imports_nothing_of_the_program():
    for path in sorted((HERE / "reference").rglob("*.py")):
        assert not imports(path) & {"wavenet_autoencoders_tpu_torch", "benchlib"}, path


REFERENCES = sorted((HERE / "reference").rglob("*.py"))


@pytest.mark.parametrize("path", REFERENCES, ids=lambda p: str(p.relative_to(HERE)))
def test_every_reference_module_loads_only_the_standard_library_torch_and_numpy(path):
    # by its source, and loaded by path as the driver loads it, in a fresh interpreter
    siblings = {p.stem for p in REFERENCES}
    allowed = set(sys.stdlib_module_names) | {"torch", "numpy", "scipy"} | siblings
    assert imports(path) <= allowed, (path, imports(path) - allowed)
    code = ("import json, sys; sys.path[:0] = [%r]\n"
            "from benchlib.cells import load_module\n"
            "before = set(sys.modules)\n"
            "load_module(__import__('pathlib').Path(%r), 'bench_reference_probe')\n"
            "print(json.dumps(sorted({m.split('.')[0] for m in set(sys.modules) - before})))") % (str(HERE), str(path))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    loaded = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert not loaded & (FORBIDDEN | {"wavenet_autoencoders_tpu_torch", "benchlib", "counts", "run"}), loaded


def test_a_run_loads_no_jax():
    # every module of the harness, loaded in a fresh interpreter
    code = ("import sys; sys.path[:0] = [%r, %r]\n"
            "import run, calibrate\n"
            "from benchlib import train, cells\n"
            "cells.metric_readers()\n"
            "import wavenet_autoencoders_tpu_torch.train.loop\n"
            "print(run.forbidden_modules())") % (str(HERE.parent), str(HERE))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_the_check_compares_whole_top_level_names():
    sys.path[:0] = [str(HERE)]
    import run

    sys.modules["wavenet_autoencoders_tpu_torch_probe"] = sys
    try:
        assert "wavenet_autoencoders_tpu_torch_probe" not in run.forbidden_modules()
        sys.modules["jax.probe"] = sys
        assert "jax.probe" in run.forbidden_modules()
    finally:
        sys.modules.pop("wavenet_autoencoders_tpu_torch_probe")
        sys.modules.pop("jax.probe", None)
