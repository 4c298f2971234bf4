"""The training loop (counterpart of ``wavenet_autoencoders_tpu/train/loop.py``).

Single process on one device. Kept from the JAX loop: the log line with
``samples_per_sec``, per-epoch averages, stopping at ``max_train_steps``
(or ``max_steps``) and ``nepochs``, the final checkpoint, SIGTERM ->
checkpoint and clean exit, and the collapse monitor that saves and exits
with code 3; and the hooks:

- every ``checkpoint_interval`` steps a checkpoint and the teacher-forced
  sample dump (``save_states``);
- every ``train_eval_interval`` steps an AR decode of a batch item
  (``eval_model``);
- with a dev dump (``dev_dump_root`` holding a ``train.txt``), one pass over
  it every ``dev_epoch_interval`` epochs at ``dev_batch_size``, written as
  the ``dev`` and ``dev_epoch`` scalars, and every
  ``test_eval_epoch_interval`` epochs an AR decode of the first dev batch;
- with ``profile_dir`` set, steps 10-15 run under ``torch.profiler`` and a
  chrome trace is written there.

The sample dump and the decode hooks use the EMA shadow once it is warm
(``_hook_params``); an exception in one is printed as ``<hook> skipped:
...`` and training goes on. The resolved config is frozen into the
checkpoint dir. Multi-process training is not ported yet (ROADMAP.md,
queue 1).
"""
from __future__ import annotations

import contextlib
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
from wavenet_autoencoders_tpu_torch.train.step import (
    ema_warm_steps,
    init_state,
    make_eval_step,
    make_sample_forward,
    make_train_step,
)
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
    eval_fn = make_eval_step(cfg, model)
    fwd_fn = make_sample_forward(cfg, model)
    train_ds = WaveDataset(dump_root, cfg, feat_type=feat_type)
    dev_ds = None
    if dev_dump_root is not None and Path(dev_dump_root, "train.txt").exists():
        dev_ds = WaveDataset(dev_dump_root, cfg, feat_type=feat_type)
    limit = max_steps if max_steps is not None else cfg.max_train_steps
    # the sampler drops the ragged tail, so one epoch is len(ds) // batch_size steps
    steps_per_epoch = max(1, len(train_ds) // cfg.batch_size)
    it = data_iterator(train_ds, cfg, transform=lambda b: batch_to_device(b, dev))
    step = state.step
    t0, last_log_step = time.time(), step
    metrics = None
    profiler = None
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
            # profiling hook: trace steps 10..15
            if cfg.profile_dir and step == 10 and profiler is None:
                profiler = _start_profiler(dev)
            if profiler is not None and step >= 15:
                _stop_profiler(profiler, cfg.profile_dir)
                profiler = None
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
                _try_save_states(cfg, fwd_fn, state, step, batch, ckpt_dir)

            if step % cfg.train_eval_interval == 0:
                _try_eval_model(cfg, state, step, batch, ckpt_dir)

            if step % steps_per_epoch == 0:
                epoch = step // steps_per_epoch
                avg_ep = {k: float(v) / epoch_n for k, v in epoch_acc.items()}
                writer.scalars(epoch, "train_no_dev_epoch", avg_ep)
                print(f"Step {step} [train_no_dev] epoch {epoch} loss {avg_ep['loss']:.4f}", flush=True)
                epoch_acc, epoch_n = None, 0
                if dev_ds is not None and epoch % max(1, cfg.dev_epoch_interval) == 0:
                    _run_dev(cfg, eval_fn, state, dev_ds, writer, step, epoch, dev, ckpt_dir,
                             do_ar_eval=epoch % cfg.test_eval_epoch_interval == 0)
                t0, last_log_step = time.time(), step  # dev time left out
                if epoch >= cfg.nepochs:
                    print(f"stopping: reached nepochs={cfg.nepochs}")
                    break
    except KeyboardInterrupt:
        print("interrupted — saving checkpoint before exit", flush=True)
    finally:
        if old_term is not None:
            signal.signal(signal.SIGTERM, old_term)
        if profiler is not None:
            _stop_profiler(profiler, cfg.profile_dir)
    if metrics is not None:
        writer.scalars(state.step, "train_no_dev", {k: float(v) for k, v in metrics.items()})
    ckpt.wait()
    save_checkpoint(state, ckpt_dir, save_optimizer_state=cfg.save_optimizer_state)
    writer.close()
    return state


def _start_profiler(dev: torch.device):
    acts = [torch.profiler.ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=acts)
    prof.start()
    return prof


def _stop_profiler(prof, profile_dir: str) -> None:
    t0 = time.perf_counter()
    prof.stop()
    out = Path(profile_dir)
    out.mkdir(parents=True, exist_ok=True)
    path = out / "trace_steps_10_15.json"
    prof.export_chrome_trace(str(path))
    print(f"profile trace written to {path} ({time.perf_counter() - t0:.2f} s)", flush=True)


@contextlib.contextmanager
def _hook_params(cfg: Config, state, step: int):
    """Lend the qualitative hooks the model: holding the EMA shadow once it
    has warmed (step >= ``ema_warm_steps``; the reference decodes with the
    shadow, but a young one is mostly random init), else the live weights.
    The shadow is copied into the parameters and the live weights are
    copied back afterwards, bit for bit: ``batch_wavegen`` folds the
    weights from the module itself."""
    if state.ema is None or step < ema_warm_steps(cfg.ema_decay):
        yield state.model
        return
    params = list(state.params().items())
    with torch.no_grad():
        live = [p.detach().clone() for _, p in params]
        for k, p in params:
            p.copy_(state.ema[k])
    try:
        yield state.model
    finally:
        with torch.no_grad():
            for (_, p), v in zip(params, live):
                p.copy_(v)


def _try_save_states(cfg: Config, fwd_fn, state, step: int, batch: dict, ckpt_dir) -> None:
    """Teacher-forced sample dump, best effort: qualitative eval must never
    kill training."""
    from wavenet_autoencoders_tpu_torch.train.eval_hooks import save_states

    t0 = time.perf_counter()
    try:
        with _hook_params(cfg, state, step):
            y_hat = fwd_fn(batch["x"], batch.get("c"), batch.get("g"))
        save_states(cfg, step, y_hat, batch, ckpt_dir)
    except Exception as e:
        print(f"save_states skipped: {type(e).__name__}: {e}", flush=True)
        return
    print(f"save_states at step {step}: {time.perf_counter() - t0:.2f} s", flush=True)


def _try_eval_model(cfg: Config, state, step: int, batch: dict, ckpt_dir, phase: str = "train_no_dev") -> None:
    """AR decode of a batch item to ``intermediate/<phase>_eval/``, best
    effort."""
    from wavenet_autoencoders_tpu_torch.train.eval_hooks import eval_model

    t0 = time.perf_counter()
    try:
        with _hook_params(cfg, state, step) as model:
            eval_model(cfg, model, step, batch, Path(ckpt_dir) / "intermediate" / f"{phase}_eval")
    except Exception as e:
        print(f"eval_model skipped: {type(e).__name__}: {e}", flush=True)
        return
    print(f"eval_model ({phase}) at step {step}: {time.perf_counter() - t0:.2f} s", flush=True)


def _run_dev(cfg: Config, eval_fn, state, dev_ds, writer, step: int, epoch: int, dev: torch.device,
             ckpt_dir, do_ar_eval: bool = False) -> None:
    """One pass over the dev dump at ``dev_batch_size``: averaged scalars
    under ``dev`` (by step) and ``dev_epoch`` (by epoch); with
    ``do_ar_eval``, an AR decode of the first dev batch."""
    t0 = time.perf_counter()
    it = data_iterator(dev_ds, cfg, batch_size=cfg.dev_batch_size, prefetch=0, epochs=1,
                       transform=lambda b: batch_to_device(b, dev))
    acc, n, first = None, 0, None
    for batch in it:
        if first is None:
            first = batch
        m = {k: float(v) for k, v in eval_fn(state, batch).items()}
        acc = m if acc is None else {k: acc[k] + m[k] for k in m}
        n += 1
    if n:
        avg = {k: v / n for k, v in acc.items()}
        writer.scalars(step, "dev", avg)
        writer.scalars(epoch, "dev_epoch", avg)
        print(
            f"Step {step} [dev] epoch {epoch} loss {avg['loss']:.4f} aux {avg['aux_loss']:.4f} "
            f"perp {avg['perplexity']:.1f} ({n} batches, {time.perf_counter() - t0:.2f} s)",
            flush=True,
        )
    if do_ar_eval and first is not None:
        _try_eval_model(cfg, state, step, first, ckpt_dir, phase="dev")
