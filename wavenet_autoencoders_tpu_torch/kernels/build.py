"""Build the port's CUDA sources into shared libraries at first use.

Each ``csrc/<name>.cu`` becomes ``_build/lib<name>-<hash>.so`` with a plain C
interface, compiled by ``nvcc`` for ``sm_90a`` and loaded with ``ctypes``.
The hash covers every file in ``csrc/``, so an edited source is rebuilt.
Sources build in parallel, one ``nvcc`` each. Nothing here runs at import.

A target is a source's name, or a (name, defines) pair: a variant of the
source compiled with ``-D`` for each define into a library of its own (the
checks and measurements build ``decode.cu`` with ``WAE_JITTER`` or
``WAE_STAMPS``; the port itself loads the plain build).
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


def _target(t) -> tuple[str, tuple[str, ...]]:
    return (t, ()) if isinstance(t, str) else (t[0], tuple(t[1]))


def _label(name: str, defines: tuple[str, ...]) -> str:
    return "+".join((name, *defines))


def _lib_path(name: str, defines: tuple[str, ...] = ()) -> Path:
    return BUILD / f"lib{_label(name, defines)}-{_sources_hash()}.so"


def build(targets: list | None = None) -> dict[str, str]:
    """Compile the targets (default: every ``csrc/*.cu``) that have no
    library for the current hash yet. Returns {label: nvcc output}, the
    label being the name followed by ``+define`` for each define; raises
    with the compiler's output when a build fails."""
    targets = [_target(t) for t in (targets or sorted(p.stem for p in CSRC.glob("*.cu")))]
    BUILD.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, defines in targets:
        out = _lib_path(name, defines)
        if out.exists():
            continue
        fd, tmp = tempfile.mkstemp(dir=BUILD, suffix=".so.tmp")
        os.close(fd)
        cmd = [_nvcc(), *NVCC_FLAGS, *(f"-D{d}" for d in defines), "-o", tmp, str(CSRC / f"{name}.cu")]
        procs[_label(name, defines)] = (
            subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), tmp, out)
    logs = {}
    for label, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        logs[label] = log
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(f"nvcc failed for {label}:\n{log}")
        os.replace(tmp, out)
    return logs


def load(name: str, defines: tuple[str, ...] = ()) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu`` (compiled with ``-D`` for
    each define), built first if needed."""
    label = _label(name, defines)
    if label not in _loaded:
        path = _lib_path(name, defines)
        if not path.exists():
            build([(name, defines)])
        _loaded[label] = ctypes.CDLL(str(path))
    return _loaded[label]
