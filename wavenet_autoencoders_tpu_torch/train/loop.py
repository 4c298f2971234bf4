"""The training loop (counterpart of ``wavenet_autoencoders_tpu/train/loop.py:79-342``).

Single process on one device. Kept from the JAX loop: the log line with
``samples_per_sec``, per-epoch averages, ``checkpoint_interval``, stopping
at ``max_train_steps`` (or ``max_steps``) and ``nepochs``, the final
checkpoint, SIGTERM -> checkpoint and clean exit, and the collapse monitor
that saves and exits with code 3. The resolved config is frozen into the
checkpoint dir. Not ported yet (ROADMAP.md, queue 1): the dev pass, the
sample dumps and decode hooks, the profiler hook and multi-process
training.
"""
from __future__ import annotations

import signal
import time
from pathlib import Path

import numpy as np
import torch

from wavenet_autoencoders_tpu_torch.config import Config
from wavenet_autoencoders_tpu_torch.data.dataset import WaveDataset, data_iterator
from wavenet_autoencoders_tpu_torch.models.zoo import build_model
from wavenet_autoencoders_tpu_torch.train.checkpoint import (
    AsyncCheckpointer,
    freeze_config,
    load_checkpoint,
    restore_parts,
    save_checkpoint,
)
from wavenet_autoencoders_tpu_torch.train.metrics import MetricsWriter
from wavenet_autoencoders_tpu_torch.train.step import init_state, make_train_step
from wavenet_autoencoders_tpu_torch.utils.device import resolve_device


class CollapseAbort(SystemExit):
    """Raised (exit code 3) when the bottleneck-collapse monitor trips, so a
    watchdog can tell it from a crash and stop relaunching."""

    def __init__(self, msg: str):
        super().__init__(3)
        self.msg = msg


def batch_to_device(batch: dict, device: torch.device) -> dict:
    """Host numpy batch -> tensors on ``device`` (pinned memory and an
    asynchronous copy on CUDA)."""
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(v))
        if device.type == "cuda":
            t = t.pin_memory().to(device, non_blocking=True)
        out[k] = t
    return out


def train(
    cfg: Config,
    dump_root: str,
    checkpoint_dir: str,
    *,
    resume: str | None = None,
    restore_parts_from: str | None = None,
    reset_optimizer: bool = False,
    feat_type: str = "mfcc",
    max_steps: int | None = None,
    log_every: int = 50,
    dev_dump_root: str | None = None,
    device: str | torch.device = "cuda",
):
    """Run training on ``device`` (default cuda; raises without it); returns
    the final TrainState."""
    dev = resolve_device(device)
    if dev_dump_root is not None:
        raise NotImplementedError(
            "the dev pass is not ported yet: see ROADMAP.md, queue 1 (dev pass and eval hooks)"
        )
    ckpt_dir = Path(checkpoint_dir)
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    freeze_config(cfg, ckpt_dir)
    writer = MetricsWriter(ckpt_dir / "logs")

    model = build_model(cfg, device=dev).train()
    state = init_state(cfg, model)
    if resume:
        load_checkpoint(state, resume, reset_optimizer=reset_optimizer)
        print(f"resumed from {resume} at step {state.step}")
    elif restore_parts_from:
        restore_parts(model, restore_parts_from)

    step_fn = make_train_step(cfg, model)
    train_ds = WaveDataset(dump_root, cfg, feat_type=feat_type)
    limit = max_steps if max_steps is not None else cfg.max_train_steps
    # the sampler drops the ragged tail, so one epoch is len(ds) // batch_size steps
    steps_per_epoch = max(1, len(train_ds) // cfg.batch_size)
    it = data_iterator(train_ds, cfg, transform=lambda b: batch_to_device(b, dev))
    step = state.step
    t0, last_log_step = time.time(), step
    metrics = None
    epoch_acc, epoch_n = None, 0
    perp_ema = None  # collapse monitor: host-side perplexity EMA
    ckpt = AsyncCheckpointer()

    # SIGTERM == "checkpoint and exit cleanly" (SIGINT alone is not enough:
    # shells start background children with SIGINT ignored)
    def _on_sigterm(signum, frame):
        raise KeyboardInterrupt

    old_term = None
    try:
        old_term = signal.signal(signal.SIGTERM, _on_sigterm)
    except ValueError:  # not the main thread
        pass
    try:
        for batch in it:
            if step >= limit:
                break
            samples_per_batch = batch["x"].shape[0] * batch["x"].shape[1]
            state, metrics = step_fn(state, batch)
            step += 1

            if step % log_every == 0 or step == 1:
                m = {k: float(v) for k, v in metrics.items()}  # waits for the device
                dt = time.time() - t0
                sps = samples_per_batch * (step - last_log_step) / max(dt, 1e-9)
                m["samples_per_sec"] = sps
                writer.scalars(step, "train_no_dev", m)
                print(
                    f"step {step} loss {m['loss']:.4f} aux {m['aux_loss']:.4f} "
                    f"perp {m['perplexity']:.1f} lr {m['lr']:.2e} {sps:,.0f} samp/s",
                    flush=True,
                )
                t0, last_log_step = time.time(), step
                perp_ema = m["perplexity"] if perp_ema is None else 0.9 * perp_ema + 0.1 * m["perplexity"]
                if (
                    cfg.collapse_check_step > 0
                    and step >= cfg.collapse_check_step
                    and perp_ema < cfg.collapse_min_perplexity
                ):
                    msg = (
                        f"collapse_abort: perplexity EMA {perp_ema:.2f} < "
                        f"{cfg.collapse_min_perplexity} at step {step} — "
                        "bottleneck collapsed; aborting (exit 3)"
                    )
                    print(msg, flush=True)
                    ckpt.wait()
                    save_checkpoint(state, ckpt_dir, save_optimizer_state=cfg.save_optimizer_state)
                    writer.close()
                    raise CollapseAbort(msg)

            # per-epoch running averages, summed on the device
            m_ep = {k: metrics[k] for k in ("loss", "aux_loss", "perplexity")}
            epoch_acc = m_ep if epoch_acc is None else {k: epoch_acc[k] + m_ep[k] for k in m_ep}
            epoch_n += 1

            if step % cfg.checkpoint_interval == 0:
                ckpt.save(state, ckpt_dir, save_optimizer_state=cfg.save_optimizer_state)

            if step % steps_per_epoch == 0:
                epoch = step // steps_per_epoch
                avg_ep = {k: float(v) / epoch_n for k, v in epoch_acc.items()}
                writer.scalars(epoch, "train_no_dev_epoch", avg_ep)
                print(f"Step {step} [train_no_dev] epoch {epoch} loss {avg_ep['loss']:.4f}", flush=True)
                epoch_acc, epoch_n = None, 0
                t0, last_log_step = time.time(), step
                if epoch >= cfg.nepochs:
                    print(f"stopping: reached nepochs={cfg.nepochs}")
                    break
    except KeyboardInterrupt:
        print("interrupted — saving checkpoint before exit", flush=True)
    finally:
        if old_term is not None:
            signal.signal(signal.SIGTERM, old_term)
    if metrics is not None:
        writer.scalars(state.step, "train_no_dev", {k: float(v) for k, v in metrics.items()})
    ckpt.wait()
    save_checkpoint(state, ckpt_dir, save_optimizer_state=cfg.save_optimizer_state)
    writer.close()
    return state
