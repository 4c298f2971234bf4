"""Build the port's CUDA sources into shared libraries at first use.

Each ``csrc/<name>.cu`` becomes ``_build/lib<name>-<hash>.so`` with a plain C
interface, compiled by ``nvcc`` for ``sm_90a`` and loaded with ``ctypes``.
The hash covers every file in ``csrc/``, so an edited source is rebuilt.
Sources build in parallel, one ``nvcc`` each. Nothing here runs at import.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD = Path(__file__).resolve().parent.parent / "_build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-O3", "-std=c++17", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_loaded: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build on a machine with the CUDA toolkit")


def _sources_hash() -> str:
    h = hashlib.sha256()
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def _lib_path(name: str) -> Path:
    return BUILD / f"lib{name}-{_sources_hash()}.so"


def build(names: list[str] | None = None) -> dict[str, str]:
    """Compile the named sources (default: every ``csrc/*.cu``) that have no
    library for the current hash yet. Returns {name: nvcc output}; raises
    with the compiler's output when a build fails."""
    names = names or sorted(p.stem for p in CSRC.glob("*.cu"))
    BUILD.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = _lib_path(name)
        if out.exists():
            continue
        fd, tmp = tempfile.mkstemp(dir=BUILD, suffix=".so.tmp")
        os.close(fd)
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), tmp, out)
    logs = {}
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        logs[name] = log
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(f"nvcc failed for csrc/{name}.cu:\n{log}")
        os.replace(tmp, out)
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    if name not in _loaded:
        path = _lib_path(name)
        if not path.exists():
            build([name])
        _loaded[name] = ctypes.CDLL(str(path))
    return _loaded[name]
