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
checkpoint dir.

Data and tensor parallel: under a process group (``parallel.distributed``,
joined by the CLI) every rank runs this function on its device. The ranks
form the JAX package's mesh (``parallel.mesh``: ``mesh_shape["model"]``
ranks a model group, the data axis the largest divisor of the batch that
fits the rest; the ``mesh: {...}`` line is printed as the JAX loop prints
it). Rank 0's initial (or resumed) state, in the full layout, is broadcast
to all, and each rank keeps its shards of it. Each data rank loads its
slice of the global batch (the ranks of a model group the same rows); the
step and the dev pass reduce over the data group and run the sharded
layers over the model group, so the metrics are the global batch's
(``samples_per_sec`` too). Only rank 0 writes the config, the logs, the
checkpoints and the sample dumps and runs the decode hooks, from its own
rows: with a model axis every rank first joins the gather of the shards
into the full layout, and rank 0 runs the hooks on a full copy of the
model, with no collective. A SIGTERM on any rank stops every rank after
the same step (a flag all-reduced each step); the collapse monitor decides
from the global metrics, so every rank stops at the same step there too.
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
from wavenet_autoencoders_tpu_torch.parallel import distributed as dist
from wavenet_autoencoders_tpu_torch.parallel.mesh import check_mesh, mesh_axes
from wavenet_autoencoders_tpu_torch.train.checkpoint import (
    AsyncCheckpointer,
    freeze_config,
    load_checkpoint,
    restore_parts,
    save_checkpoint,
)
from wavenet_autoencoders_tpu_torch.train.metrics import MetricsWriter
from wavenet_autoencoders_tpu_torch.train.step import (
    TrainState,
    ema_warm_steps,
    init_state,
    make_eval_step,
    make_sample_forward,
    make_train_step,
    shard_state,
)
from wavenet_autoencoders_tpu_torch.utils.device import resolve_device
from wavenet_autoencoders_tpu_torch.utils.params import flatten_params, flatten_state, gather_params


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
    """Run training on ``device`` (default cuda; raises without it; a rank
    of a process group takes ``cuda:(rank % device_count)``); returns the
    final TrainState."""
    dev = dist.local_device(resolve_device(device))
    world, main = dist.world_size(), dist.is_main_process()
    ckpt_dir = Path(checkpoint_dir)
    if main:
        ckpt_dir.mkdir(parents=True, exist_ok=True)
        freeze_config(cfg, ckpt_dir)
    writer = MetricsWriter(ckpt_dir / "logs") if main else None

    model = build_model(cfg, device=dev).train()
    state = init_state(cfg, model)
    if resume:
        load_checkpoint(state, resume, reset_optimizer=reset_optimizer)
        if main:
            print(f"resumed from {resume} at step {state.step}")
    elif restore_parts_from:
        restore_parts(model, restore_parts_from)

    train_ds = WaveDataset(dump_root, cfg, feat_type=feat_type)
    dev_ds = None
    if dev_dump_root is not None and Path(dev_dump_root, "train.txt").exists():
        dev_ds = WaveDataset(dev_dump_root, cfg, feat_type=feat_type)
    check_mesh(cfg, world, ("batch_size", "dev_batch_size") if dev_ds is not None else ("batch_size",),
               shapes={k: tuple(p.shape) for k, p in state.params().items()})
    data, n_model = mesh_axes(cfg, world)
    dist.init_mesh(n_model)
    tp = n_model > 1
    # under a process group every replica starts from rank 0's state, then keeps its shards
    dist.broadcast_from_main(list(state.params().values()) + list(flatten_state(model).values())
                             + list(state.mu.values()) + list(state.nu.values())
                             + (list(state.ema.values()) if state.ema is not None else []))
    shard_state(cfg, state)
    host_slice = None
    if main:
        print(f"mesh: {dict(data=data, model=n_model)} over {world} devices", flush=True)
    if world > 1:
        host_slice = dist.host_local_batch_slice(cfg.batch_size)
        if main and not tp:
            print(f"data parallel: {world} processes, {host_slice[1]} of {cfg.batch_size} rows each", flush=True)
        elif main:
            print(f"tensor parallel: {n_model} ranks a model group, {data} data ranks of {host_slice[1]} of "
                  f"{cfg.batch_size} rows", flush=True)

    step_fn = make_train_step(cfg, model)
    eval_fn = make_eval_step(cfg, model)
    fwd_fn = make_sample_forward(cfg, model)
    full_model = None  # rank 0's full copy of a sharded model, for the hooks

    def hook_state():
        """The state the hooks run on: ``state``, or under tensor parallelism
        (a collective: every rank calls it) a TrainState over rank 0's full
        copy of the model, with the gathered weights and EMA shadow (None on
        the other ranks)."""
        nonlocal fwd_fn, full_model
        if not tp:
            return state
        params = gather_params(state.params())
        ema = gather_params(state.ema) if state.ema is not None else None
        if not main:
            return None
        if full_model is None:
            full_model = build_model(cfg, device=dev).train()
            fwd_fn = make_sample_forward(cfg, full_model)
        with torch.no_grad():
            for k, p in flatten_params(full_model).items():
                p.copy_(params[k])
            buffers = flatten_state(model)
            for k, b in flatten_state(full_model).items():
                b.copy_(buffers[k])
        return TrainState(model=full_model, mu={}, nu={}, count=state.count, lr=state.lr, ema=ema, step=state.step)
    limit = max_steps if max_steps is not None else cfg.max_train_steps
    # the sampler drops the ragged tail, so one epoch is len(ds) // batch_size steps
    steps_per_epoch = max(1, len(train_ds) // cfg.batch_size)
    it = data_iterator(train_ds, cfg, host_slice=host_slice, transform=lambda b: batch_to_device(b, dev))
    step = state.step
    t0, last_log_step = time.time(), step
    metrics = None
    profiler = None
    epoch_acc, epoch_n = None, 0
    perp_ema = None  # collapse monitor: host-side perplexity EMA
    ckpt = AsyncCheckpointer()

    # SIGTERM == "checkpoint and exit cleanly" (SIGINT alone is not enough:
    # shells start background children with SIGINT ignored). Under a process
    # group the handler only raises a flag; after each step the ranks agree
    # on it, so every rank stops after the same step and none waits in a
    # collective alone.
    stop = []

    def _on_sigterm(signum, frame):
        if world == 1:
            raise KeyboardInterrupt
        stop.append(signum)

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
            if main and cfg.profile_dir and step == 10 and profiler is None:
                profiler = _start_profiler(dev)
            if profiler is not None and step >= 15:
                _stop_profiler(profiler, cfg.profile_dir)
                profiler = None
            samples_per_batch = batch["x"].shape[0] * batch["x"].shape[1] * data
            state, metrics = step_fn(state, batch)
            step += 1
            if dist.any_rank(bool(stop)):
                print(f"interrupted at step {step} — saving checkpoint before exit", flush=True)
                break

            if step % log_every == 0 or step == 1:
                m = {k: float(v) for k, v in metrics.items()}  # waits for the device
                dt = time.time() - t0
                sps = samples_per_batch * (step - last_log_step) / max(dt, 1e-9)
                m["samples_per_sec"] = sps
                if main:
                    writer.scalars(step, "train_no_dev", m)
                    reseed = f" reseed {m['reseeded']:.0f}" if m["reseeded"] else ""
                    print(
                        f"step {step} loss {m['loss']:.4f} aux {m['aux_loss']:.4f} "
                        f"perp {m['perplexity']:.1f}{reseed} lr {m['lr']:.2e} {sps:,.0f} samp/s",
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
                    if main or tp:
                        ckpt.wait()
                        save_checkpoint(state, ckpt_dir, save_optimizer_state=cfg.save_optimizer_state, write=main)
                    if main:
                        writer.close()
                    raise CollapseAbort(msg)

            # per-epoch running averages, summed on the device
            m_ep = {k: metrics[k] for k in ("loss", "aux_loss", "perplexity")}
            epoch_acc = m_ep if epoch_acc is None else {k: epoch_acc[k] + m_ep[k] for k in m_ep}
            epoch_n += 1

            if (main or tp) and step % cfg.checkpoint_interval == 0:
                ckpt.save(state, ckpt_dir, save_optimizer_state=cfg.save_optimizer_state, write=main)
                hs = hook_state()
                if main:
                    _try_save_states(cfg, fwd_fn, hs, step, batch, ckpt_dir)

            if (main or tp) and step % cfg.train_eval_interval == 0:
                hs = hook_state()
                if main:
                    _try_eval_model(cfg, hs, step, batch, ckpt_dir)

            if step % steps_per_epoch == 0:
                epoch = step // steps_per_epoch
                if main:
                    avg_ep = {k: float(v) / epoch_n for k, v in epoch_acc.items()}
                    writer.scalars(epoch, "train_no_dev_epoch", avg_ep)
                    print(f"Step {step} [train_no_dev] epoch {epoch} loss {avg_ep['loss']:.4f}", flush=True)
                epoch_acc, epoch_n = None, 0
                if dev_ds is not None and epoch % max(1, cfg.dev_epoch_interval) == 0:
                    ar_eval = epoch % cfg.test_eval_epoch_interval == 0 and (main or tp)
                    _run_dev(cfg, eval_fn, state, dev_ds, writer, step, epoch, dev, ckpt_dir,
                             ar_state=hook_state() if ar_eval else None)
                t0, last_log_step = time.time(), step  # dev time left out
                if epoch >= cfg.nepochs:
                    if main:
                        print(f"stopping: reached nepochs={cfg.nepochs}")
                    break
    except KeyboardInterrupt:
        print("interrupted — saving checkpoint before exit", flush=True)
    finally:
        if old_term is not None:
            signal.signal(signal.SIGTERM, old_term)
        if profiler is not None:
            _stop_profiler(profiler, cfg.profile_dir)
    if main and metrics is not None:
        writer.scalars(state.step, "train_no_dev", {k: float(v) for k, v in metrics.items()})
    if main or tp:
        ckpt.wait()
        save_checkpoint(state, ckpt_dir, save_optimizer_state=cfg.save_optimizer_state, write=main)
    if main:
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
             ckpt_dir, ar_state=None) -> None:
    """One pass over the dev dump at ``dev_batch_size`` (each data rank its
    slice; the metrics are the global batch's): averaged scalars under
    ``dev`` (by step) and ``dev_epoch`` (by epoch), written when ``writer``
    is given (rank 0); given ``ar_state`` (rank 0's hook state), an AR
    decode of the first dev batch's rows of this rank from it."""
    t0 = time.perf_counter()
    host_slice = dist.host_local_batch_slice(cfg.dev_batch_size) if dist.world_size() > 1 else None
    it = data_iterator(dev_ds, cfg, batch_size=cfg.dev_batch_size, prefetch=0, epochs=1, host_slice=host_slice,
                       transform=lambda b: batch_to_device(b, dev))
    acc, n, first = None, 0, None
    for batch in it:
        if first is None:
            first = batch
        m = {k: float(v) for k, v in eval_fn(state, batch).items()}
        acc = m if acc is None else {k: acc[k] + m[k] for k in m}
        n += 1
    if n and writer is not None:
        avg = {k: v / n for k, v in acc.items()}
        writer.scalars(step, "dev", avg)
        writer.scalars(epoch, "dev_epoch", avg)
        print(
            f"Step {step} [dev] epoch {epoch} loss {avg['loss']:.4f} aux {avg['aux_loss']:.4f} "
            f"perp {avg['perplexity']:.1f} ({n} batches, {time.perf_counter() - t0:.2f} s)",
            flush=True,
        )
    if ar_state is not None and first is not None:
        _try_eval_model(cfg, ar_state, step, first, ckpt_dir, phase="dev")
