"""The train cells: the port's train step driven as its training loop drives
it, on the port's own data path, for a window of fixed seconds.

Set-up builds the model at the configuration's widths, loads the seed's
weights into it by parameter name, writes the seed's dump under TMPDIR and
starts the port's ``data_iterator`` over the configuration's ``features``
(native loader for mu-law codes, the Python collator for raw samples,
prefetch thread, the host-to-device copy in that thread, as
``train/loop.py`` passes it). It then builds one step object
(``make_train_step``: a CUDA graph on the card, step 1 eager, step 2
captured) and drives it through steps 1-3 on the iterator's batches,
keeping what the check needs (the weights before, the first moment after
step 1, the weights and the EMA shadow after step 3, the three batches);
the same object then runs the window from step 4.
Once the window has closed, the configuration's plain reference
(``Cell.reference``) takes the same weights and the three batches.

The window: a batch from the iterator (the host span ``loader_wait``),
the step, a CUDA event recorded after it; every 50th step the metrics are
read to the host, as the loop reads them. It ends once ``seconds`` have
passed on the host clock and the device has finished what was enqueued.
The end-to-end metrics: samples trained over the whole window, and the
95th percentile of every step's interval between its event and the one
before it, read once at the end. A traced run profiles a stretch of
``TRACE_STEPS`` steps from the window's ``TRACE_FROM``-th step, between
two synchronisations, and records the port's tracer
(``utils/spans.py``) over the whole window: turned on after set-up's
drain, just before the window's first step, and off (and emptied) once the
window has closed, also when the window raises; its records go to the
run's ``spans``. A run with ``trace`` false never turns it on.
"""
from __future__ import annotations

import math
import shutil
import tempfile
import time
from pathlib import Path

import torch

from benchlib import checks, trace as btrace
from benchlib.cells import Cell, model_config
from benchlib.weights import draw

LOG_EVERY = 50
SETUP_STEPS = 3  # the steps set-up drives and the check compares
TRACE_FROM, TRACE_STEPS = 20, 10
ADAM_B1 = 0.9
#: what the reference gets of a batch (``g`` only with global conditioning)
FEED = ("x", "c", "g", "lengths")


def p95(values) -> float:
    """The nearest-rank 95th percentile of all the values."""
    v = sorted(values)
    return v[max(0, math.ceil(0.95 * len(v)) - 1)]


def run(cell: Cell, seed: int, seconds: float, trace: bool, device: str, t_start: float,
        hooks: dict | None = None) -> dict:
    laps = [("start", time.perf_counter() - t_start)]

    def lap(name: str) -> None:  # set-up's phases, host seconds each
        laps.append((name, time.perf_counter() - t_start - sum(x for _, x in laps)))

    from wavenet_autoencoders_tpu_torch.config import Config
    from wavenet_autoencoders_tpu_torch.data.dataset import WaveDataset, data_iterator
    from wavenet_autoencoders_tpu_torch.kernels import glu_stack
    from wavenet_autoencoders_tpu_torch.models.zoo import build_model
    from wavenet_autoencoders_tpu_torch.train.loop import batch_to_device
    from wavenet_autoencoders_tpu_torch.train.step import init_state, make_train_step
    from wavenet_autoencoders_tpu_torch.utils import spans
    from wavenet_autoencoders_tpu_torch.utils.params import flatten_params

    lap("imports")
    hooks = hooks or {}
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    cfg_d = model_config(cell.config)
    cfg = Config().override(cfg_d)
    model = build_model(cfg, device=dev).train()
    params = flatten_params(model)
    w0 = draw({k: tuple(p.shape) for k, p in params.items()}, seed, dev)
    with torch.no_grad():
        for k, p in params.items():
            p.copy_(w0[k])
    lap("model")
    tmp = Path(tempfile.mkdtemp(prefix="wae-bench-"))
    try:
        dump = cell.generator.generate(cell.traffic, cfg_d, seed, tmp / "dump")
        lap("dump")
        it = data_iterator(WaveDataset(str(dump), cfg, feat_type=cell.features), cfg, seed=seed,
                           transform=lambda b: batch_to_device(b, dev))
        state = init_state(cfg, model)
        step_fn = hooks.get("step", lambda f: f)(make_train_step(cfg, model))
        lap("loader_and_step")

        # steps 1-3: the window's own object and feed, held against the reference
        batches, losses = [], []
        for i in range(SETUP_STEPS):
            batch = next(it)
            batches.append(batch)
            state, m = step_fn(state, batch)
            losses.append(m["loss"])
            if i == 0:
                first_grad = {k: state.mu[k] / (1.0 - ADAM_B1) for k in state.mu}
            lap(f"step{i + 1}")
        prog = {"losses": [float(x) for x in losses], "first_grad": first_grad,
                "params": {k: p.detach().clone() for k, p in flatten_params(model).items()},
                "ema": None if state.ema is None else {k: v.clone() for k, v in state.ema.items()}}
        if cuda:
            torch.cuda.synchronize(dev)
        B, T = batches[0]["x"].shape
        setup_s = time.perf_counter() - t_start
        lap("drain")

        # the window
        events, win_losses, waits = [], [], []
        prof, stretch = None, None
        window_from, recs = state.step, None
        if trace:  # the port's tracer, over the window alone
            spans.reset()
            spans.enable()
        try:
            t0 = time.perf_counter()
            start = torch.cuda.Event(enable_timing=True) if cuda else None
            if cuda:
                start.record()
            n = 0
            while True:
                if trace and n == TRACE_FROM:
                    if cuda:
                        torch.cuda.synchronize(dev)
                    prof = btrace.Profiler(cuda).__enter__()
                    win = prof.window().__enter__()
                    fwd0 = glu_stack.LAUNCHES_FWD, glu_stack.LAUNCHES_BWD
                tw = time.perf_counter()
                with torch.profiler.record_function("bench.loader_wait"):
                    batch = next(it)
                waits.append(time.perf_counter() - tw)
                with torch.profiler.record_function("bench.step"):
                    state, m = step_fn(state, batch)
                if cuda:
                    e = torch.cuda.Event(enable_timing=True)
                    e.record()
                    events.append(e)
                else:
                    events.append(time.perf_counter())
                win_losses.append(m["loss"])
                n += 1
                if state.step % LOG_EVERY == 0:
                    with torch.profiler.record_function("bench.metric_read"):
                        {k: float(v) for k, v in m.items()}
                if prof is not None and stretch is None and n == TRACE_FROM + TRACE_STEPS:
                    if cuda:
                        torch.cuda.synchronize(dev)
                    win.__exit__(None, None, None)
                    prof.__exit__(None, None, None)
                    stretch = {"steps": TRACE_STEPS, "first": TRACE_FROM,
                               "k2": glu_stack.LAUNCHES_FWD - fwd0[0], "k3": glu_stack.LAUNCHES_BWD - fwd0[1]}
                if time.perf_counter() - t0 >= seconds and (not trace or stretch is not None):
                    break
            if cuda:
                torch.cuda.synchronize(dev)
            window_s = time.perf_counter() - t0
        finally:
            if trace:
                spans.disable()
                recs = spans.records()
                spans.reset()
        if cuda:
            marks = [start.elapsed_time(e) for e in events]
        else:
            marks = [(e - t0) * 1e3 for e in events]
        intervals = [b - a for a, b in zip([0.0] + marks[:-1], marks)]
        memory_peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
        nonfinite = int((~torch.isfinite(torch.stack(win_losses).float())).sum())
        result = {
            "setup_s": setup_s, "setup_laps": laps, "attempted": n, "failed": nonfinite, "memory_peak_bytes": memory_peak,
            "end_to_end": {"train_samples_per_s": {"value": n * B * T / window_s, "unit": "samples/s"},
                           "train_step_ms_p95": {"value": p95(intervals), "unit": "ms"}},
            "run": {"kind": "train", "cfg": cfg_d, "B": B, "T": T, "steps": n, "window_s": window_s,
                    "intervals_ms": intervals, "loader_wait_s": waits, "stretch": stretch,
                    "trace": None if prof is None else prof.trace, "window_from": window_from},
        }
        if trace:
            result["run"]["spans"] = recs
        del state, step_fn, model, params, it, m
        if cuda:
            torch.cuda.empty_cache()

        # the reference, once the window has closed and the program's state is freed
        reference = cell.reference()
        feed = [{k: b[k] for k in FEED if k in b} for b in batches]
        with reference.precision():
            ref = reference.train_steps(w0, feed, cfg_d, "f32")
            grad64 = reference.train_steps(w0, feed[:1], cfg_d, "f64")["first_grad"]
        numbers = checks.train_numbers(prog, ref, w0, grad64)
        numbers["nonfinite"] = float(nonfinite)
        result["numbers"] = numbers
        if "after_reference" in hooks:  # the calibration's controls and faults
            result["calibration"] = hooks["after_reference"](w0=w0, feed=feed, ref=ref, grad64=grad64,
                                                             cfg=cfg_d, prog=prog, reference=reference)
        return result
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
