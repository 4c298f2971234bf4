"""Checkpointing in the JAX package's npz format (counterpart of
``wavenet_autoencoders_tpu/train/checkpoint.py:30-210``), so either package
resumes from the other's checkpoints:

- one ``checkpoint_step{N:09d}.npz`` with every leaf under its tree path:
  ``params/...``, ``model_state/...`` (the model's buffers: EMA codebooks,
  their statistics, code usage), ``opt_state/...`` (unless
  ``save_optimizer_state`` is off) and ``step``;
- the ``_ema`` sibling, the same payload with ``params`` replaced by the
  parameter-EMA shadow;
- rolling ``checkpoint_latest.npz`` / ``checkpoint_latest_ema.npz`` copies;
- atomic writes (temporary file + rename);
- under tensor parallelism the same keys and shapes as one process: the
  shards are gathered on save (every rank of the model group joins, rank 0
  writes), and a restore loads the full layout that ``train`` then shards;
- ``load_checkpoint`` (exact resume, optionally resetting the optimizer),
  ``restore_parts`` (shape-tolerant partial load of the weights) and
  ``freeze_config``.
"""
from __future__ import annotations

import os
import shutil
import tempfile
import threading
from pathlib import Path

import numpy as np
import torch

from wavenet_autoencoders_tpu_torch.utils.params import (
    flatten_opt_state,
    gather_params,
    flatten_state,
    flatten_tensors,
    load_flat_params,
    load_flat_state,
    unflatten_opt_state,
    unflatten_tensors,
)


def save_npz(flat: dict, path: str | Path) -> None:
    """Write ``flat`` to ``path`` atomically."""
    path = Path(path)
    fd, tmp = tempfile.mkstemp(dir=path.parent, suffix=".tmp.npz")
    os.close(fd)
    try:
        np.savez(tmp, **flat)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def snapshot(state, save_optimizer_state: bool = True) -> tuple[dict, dict | None]:
    """Host copies of a TrainState's checkpoint payloads: (main, ema or None),
    in the full layout: under tensor parallelism the shards are gathered
    over the model group, so every rank of the group calls it."""
    main = flatten_tensors(gather_params(state.params()), "params/")
    main.update(flatten_tensors(flatten_state(state.model), "model_state/"))
    main["step"] = np.int64(state.step)
    if save_optimizer_state:
        main.update(flatten_opt_state(gather_params(state.mu), gather_params(state.nu), state.count, state.lr))
    ema = None
    if state.ema is not None:
        ema = {k: v for k, v in main.items() if not k.startswith("params/")}
        ema.update(flatten_tensors(gather_params(state.ema), "params/"))
    return main, ema


def write_checkpoint(main: dict, ema: dict | None, checkpoint_dir: str | Path) -> Path:
    d = Path(checkpoint_dir)
    d.mkdir(parents=True, exist_ok=True)
    step = int(main["step"])
    path = d / f"checkpoint_step{step:09d}.npz"
    save_npz(main, path)
    shutil.copyfile(path, d / "checkpoint_latest.npz")
    if ema is not None:
        ema_path = d / f"checkpoint_step{step:09d}_ema.npz"
        save_npz(ema, ema_path)
        shutil.copyfile(ema_path, d / "checkpoint_latest_ema.npz")
    return path


def save_checkpoint(state, checkpoint_dir: str | Path, save_optimizer_state: bool = True,
                    write: bool = True) -> Path | None:
    """Write checkpoint_step{N}.npz (+ _ema) and refresh the rolling
    checkpoint_latest copies. Returns the main checkpoint's path. A rank of
    a model group other than the writer passes ``write=False``: it joins
    the gather and writes nothing."""
    snap = snapshot(state, save_optimizer_state)
    return write_checkpoint(*snap, checkpoint_dir) if write else None


class AsyncCheckpointer:
    """The state is copied to the host synchronously; the npz writes run on
    a background thread so training does not wait on the disk. ``wait()``
    before exit."""

    def __init__(self):
        self._thread: threading.Thread | None = None

    def save(self, state, checkpoint_dir, save_optimizer_state: bool = True, write: bool = True):
        self.wait()
        main, ema = snapshot(state, save_optimizer_state)
        if not write:
            return
        self._thread = threading.Thread(target=write_checkpoint, args=(main, ema, checkpoint_dir), daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None


def load_checkpoint(state, path: str | Path, reset_optimizer: bool = False):
    """Exact resume, in place: weights, model state, step, the optimizer
    state (unless ``reset_optimizer`` or the file has none) and the EMA
    shadow from the ``_ema`` sibling (a copy of the weights when there is
    none). Returns ``state``."""
    z = np.load(Path(path))
    load_flat_params(state.model, z, prefix="params/")
    load_flat_state(state.model, z)
    params = state.params()
    if "step" in z.files:
        state.step = int(z["step"])
    if not reset_optimizer and any(k.startswith("opt_state/") for k in z.files):
        state.mu, state.nu, state.count, state.lr = unflatten_opt_state(z, params)
    if state.ema is not None:
        ema_path = Path(str(path).replace(".npz", "_ema.npz"))
        if ema_path.exists():
            state.ema = unflatten_tensors(np.load(ema_path), params, "params/")
        else:
            state.ema = {k: p.detach().clone() for k, p in params.items()}
    return state


def restore_parts(model, path: str | Path, log=print) -> None:
    """Partial, shape-tolerant restore of the weights, in place: each
    parameter found in the file (as ``params/<path>``, or as ``<path>`` in a
    params-only file) with the same shape is loaded; every other keeps its
    value."""
    z = np.load(Path(path))
    skipped = []
    with torch.no_grad():
        for name, p in model.named_parameters():
            k = name.replace(".", "/")
            key = next((c for c in (f"params/{k}", k) if c in z.files), None)
            if key is not None and z[key].shape == tuple(p.shape):
                p.copy_(torch.from_numpy(np.asarray(z[key])).to(p.dtype))
            else:
                skipped.append(k)
    if skipped:
        log(f"restore_parts: kept {len(skipped)} template leaves (missing/shape-mismatch): "
            + ", ".join(skipped[:8]) + ("..." if len(skipped) > 8 else ""))


def freeze_config(cfg, checkpoint_dir: str | Path) -> None:
    d = Path(checkpoint_dir)
    d.mkdir(parents=True, exist_ok=True)
    cfg.save(d / "config.json")
