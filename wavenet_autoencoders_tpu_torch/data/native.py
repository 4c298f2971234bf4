"""ctypes binding of the native data loader, ``native/dataload.cpp``
(counterpart of ``wavenet_autoencoders_tpu/data/native.py``).

The library is built with ``g++`` at first use into ``_build/``, under a
name keyed by a hash of the source and the flags, written to a temporary
file and renamed into place, so concurrent first uses never load a
half-written file. ``-march=native`` is left out, so a library built on one
host runs on another; the loader only copies and converts, so its output
does not depend on the flags. ``LOADS`` counts the batches it assembled.
A failed build or load raises: there is no silent fallback (``data.dataset`` routes to the Python collate path only
the inputs the loader refuses by design).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parent.parent / "native" / "dataload.cpp"
BUILD = Path(__file__).resolve().parent.parent / "_build"
CXX_FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC", "-pthread"]

_lib: ctypes.CDLL | None = None
_lock = threading.Lock()
LOADS = 0  # batches the loader assembled


def lib_path() -> Path:
    h = hashlib.sha256(SOURCE.read_bytes() + " ".join(CXX_FLAGS).encode()).hexdigest()[:16]
    return BUILD / f"libwaedata-{h}.so"


def build() -> Path:
    """Compile the loader unless the library for this source exists;
    returns its path. Raises RuntimeError when ``g++`` is missing or fails."""
    out = lib_path()
    if out.exists():
        return out
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found: the native data loader builds with g++ at first use")
    BUILD.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=BUILD, suffix=".so.tmp")
    os.close(fd)
    try:
        r = subprocess.run([cxx, *CXX_FLAGS, "-o", tmp, str(SOURCE)], capture_output=True, text=True,
                           timeout=300)
        if r.returncode != 0:
            raise RuntimeError(f"g++ failed to build the native data loader:\n{r.stdout}{r.stderr}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def load() -> ctypes.CDLL:
    """The loaded library, built first if needed (thread-safe)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            lib.wae_load_batch.restype = ctypes.c_int
            lib.wae_load_batch.argtypes = [
                ctypes.POINTER(ctypes.c_char_p),
                ctypes.POINTER(ctypes.c_char_p),
                ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                ctypes.c_int64, ctypes.c_uint64,
                ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_float),
                ctypes.c_int,
            ]
            lib.wae_npy_shape.restype = ctypes.c_int
            lib.wae_npy_shape.argtypes = [
                ctypes.c_char_p,
                ctypes.POINTER(ctypes.c_int64),
                ctypes.POINTER(ctypes.c_int64),
            ]
            _lib = lib
    return _lib


def npy_shape(path: str) -> tuple[int, int] | None:
    """(rows, cols) of a C-order little-endian npy (cols 1 for 1-D), or
    None when the loader cannot read it."""
    r, c = ctypes.c_int64(), ctypes.c_int64()
    if load().wae_npy_shape(str(path).encode(), ctypes.byref(r), ctypes.byref(c)) != 0:
        return None
    return int(r.value), int(c.value)


class LoaderRefused(RuntimeError):
    """The loader refused an input by design (a layout or dtype it does not
    read, a misaligned or too-short utterance); the caller may use the
    Python path for it."""


def load_batch_native(
    wave_paths: list[str],
    feat_paths: list[str],
    max_steps: int,
    hop: int,
    cin_pad: int,
    feat_dim: int,
    seed: int,
    n_threads: int = 0,
):
    """Parallel mmap'd load and synchronized hop-aligned random crop of a
    whole batch; item i's crop comes from seed + 0x517CC1B727220A95·(i+1).
    Returns (x (B, max_steps) int32, c (B, frames, D) f32). Raises
    ``LoaderRefused`` with the loader's code when it refuses an input."""
    lib = load()
    B = len(wave_paths)
    frames = max_steps // hop + 2 * cin_pad
    x = np.empty((B, max_steps), np.int32)
    c = np.empty((B, frames, feat_dim), np.float32)
    wv = (ctypes.c_char_p * B)(*[str(p).encode() for p in wave_paths])
    ft = (ctypes.c_char_p * B)(*[str(p).encode() for p in feat_paths])
    rc = lib.wae_load_batch(
        wv, ft, B, max_steps, hop, cin_pad, feat_dim,
        ctypes.c_uint64(seed & 0xFFFFFFFFFFFFFFFF),
        x.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        c.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        n_threads or (os.cpu_count() or 2),
    )
    if rc != 0:
        raise LoaderRefused(f"native loader refused the batch (code {rc})")
    global LOADS
    LOADS += 1
    return x, c
