"""The port's tracer (``utils/spans.py``) on the CPU, over the loop's own
data path and train step at a tiny svqwae: off it records nothing; on, the
spans nest as the work does across the prefetch thread and the main
thread, each step carries the batch that ``data.wait`` handed out, the
counters count what happened, and the spans lie on ``torch.profiler``'s
clock. The graphed step runs through ``GraphedStep`` with its CUDA calls
replaced (``CpuGraph``), so its warm-up, capture and launch spans are the
real ones."""
import contextlib
import statistics
import threading
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from wavenet_autoencoders_tpu_torch.config import load_preset  # noqa: E402
from wavenet_autoencoders_tpu_torch.data.dataset import WaveDataset, data_iterator  # noqa: E402
from wavenet_autoencoders_tpu_torch.models import build_model  # noqa: E402
from wavenet_autoencoders_tpu_torch import kernels  # noqa: E402
from wavenet_autoencoders_tpu_torch.train.graph import GraphedStep, StatePointers  # noqa: E402
from wavenet_autoencoders_tpu_torch.train.loop import batch_to_device  # noqa: E402
from wavenet_autoencoders_tpu_torch.train.step import init_state, make_train_step  # noqa: E402
from wavenet_autoencoders_tpu_torch.utils import spans  # noqa: E402

TINY = ("layers=4,stacks=2,residual_channels=16,gate_channels=32,skip_out_channels=16,encoder_hid=16,"
        "cin_channels=8,gin_channels=4,n_speakers=8,K=8,out_channels=32,quantize_channels=32,"
        'max_time_steps=128,hop_size=4,compute_dtype=float32,batch_size=2,upsample_params={"upsample_scales": [4, 4]}')
STEPS = 6


@pytest.fixture(autouse=True)
def no_recording():
    spans.reset()
    yield
    spans.reset()


class CpuGraph(GraphedStep):
    """``GraphedStep`` with its CUDA calls replaced: the first step runs the
    body as it is; the "capture" keeps the body over the static batch
    buffers as a graph whose replay runs it and writes into the first
    replay's outputs; ``_replay`` is the real one."""

    def _warm(self, body, state):
        return body(state, self.static)

    def _capture(self, body, state):
        def replay():
            out = body(state, self.static)
            if self.out is None:
                self.out = out
            else:
                for k, v in out.items():
                    self.out[k].copy_(v)

        self.graph = types.SimpleNamespace(replay=replay)
        self.launches = dict.fromkeys(kernels.COUNTERS, 0)
        self.pointers = StatePointers(state)


def _dump(root, n_utts=8, frames=40, hop=4):
    rng = np.random.default_rng(0)
    lines = []
    for i in range(n_utts):
        d = root / f"V00{i % 2 + 1}_{i}"
        d.mkdir(parents=True)
        np.save(d / "wave.npy", rng.integers(0, 32, frames * hop))
        np.save(d / "mfcc.norm.npy", rng.standard_normal((frames, 39)).astype(np.float32))
        lines.append(f"{d}/|{frames}|{i % 2}|dummy")
    (root / "train.txt").write_text("\n".join(lines) + "\n")
    return root


def window(tmp_path, monkeypatch, on: bool):
    """STEPS steps of the graphed tiny step on the prefetched data path,
    the tracer on from the start when ``on``."""
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    cfg = load_preset("svqwae", TINY)
    model = build_model(cfg, device="cpu").train()
    state = init_state(cfg, model)
    step_fn = make_train_step(cfg, model)
    step_fn.runner = CpuGraph(step_fn.device)
    if on:
        spans.enable()
    it = data_iterator(WaveDataset(str(_dump(tmp_path / "dump")), cfg), cfg,
                       transform=lambda b: batch_to_device(b, torch.device("cpu")))
    for _ in range(STEPS):
        state, _ = step_fn(state, next(it))
    spans.disable()
    return spans.records()


def test_off_records_nothing(tmp_path, monkeypatch):
    assert spans.span("step") is spans.span("data.wait", batch=3)  # one shared no-op
    assert window(tmp_path, monkeypatch, on=False) == {}
    spans.enable()
    with spans.span("on"):
        spans.count("c")
    spans.disable()
    with spans.span("off"):
        spans.count("c")
    rec = spans.records()
    assert [s.name for s in rec["spans"]] == ["on"] and rec["counters"] == {"c": 1}


def test_spans_nest_across_the_prefetch_thread_and_the_main_thread(tmp_path, monkeypatch):
    rec = window(tmp_path, monkeypatch, on=True)
    by_id = {s.id: s for s in rec["spans"]}
    main = threading.get_native_id()
    names = {s.name for s in rec["spans"]}
    assert names == {"data.build", "data.load", "data.to_device", "data.wait", "step", "step.warm", "step.capture",
                     "step.launch"}
    for s in rec["spans"]:
        up = by_id.get(s.parent)
        assert (up.name if up else None) == {
            "data.load": "data.build", "data.to_device": "data.build", "step.warm": "step",
            "step.capture": "step", "step.launch": "step"}.get(s.name), s
        if up is not None:
            assert up.start_ns <= s.start_ns <= s.end_ns <= up.end_ns and up.thread == s.thread
        assert (s.thread == main) == (s.name.split(".")[0] == "step" or s.name == "data.wait"), s
    steps = [s for s in rec["spans"] if s.name == "step"]
    assert [s.step for s in steps] == list(range(STEPS))
    kids = [[k.name for k in rec["spans"] if k.parent == s.id] for s in steps]
    assert kids == [["step.warm"], ["step.capture", "step.launch"]] + [["step.launch"]] * (STEPS - 2)
    waits = [s.ready for s in rec["spans"] if s.name == "data.wait"]
    assert len(waits) == STEPS and all(0 <= r <= 3 for r in waits)


def test_a_step_carries_the_batch_that_data_wait_handed_out(tmp_path, monkeypatch):
    rec = window(tmp_path, monkeypatch, on=True)
    waits = [s for s in rec["spans"] if s.name == "data.wait"]
    steps = [s for s in rec["spans"] if s.name == "step"]
    assert [s.batch for s in waits] == [s.batch for s in steps] == list(range(1, STEPS + 1))
    for w, s in zip(waits, steps):
        assert w.end_ns <= s.start_ns
    for s in rec["spans"]:
        if s.name.startswith("step."):  # a child carries its step's tags
            up = next(p for p in steps if p.id == s.parent)
            assert (s.step, s.batch) == (up.step, up.batch)
        if s.name in ("data.load", "data.to_device"):
            assert s.batch == next(p for p in rec["spans"] if p.id == s.parent).batch


def test_the_counters(tmp_path, monkeypatch):
    rec = window(tmp_path, monkeypatch, on=True)
    builds = [s for s in rec["spans"] if s.name == "data.build"]
    assert sorted(s.batch for s in builds) == list(range(1, len(builds) + 1)) and len(builds) >= STEPS
    assert rec["counters"] == {"data.batches": len(builds), "step.captures": 1, "step.replays": STEPS - 1}
    by_id = {s.id: s for s in rec["spans"]}
    # each count is attributed to the span it was counted in
    assert {(n, k, by_id[p].name) for n, k, p in rec["counts"]} == {
        ("data.batches", 1, "data.build"), ("step.captures", 1, "step"), ("step.replays", 1, "step")}
    assert rec["dropped"] == 0
    assert {"kernels.decode.LAUNCHES", "kernels.glu_stack.LAUNCHES_FWD", "kernels.glu_stack.LAUNCHES_BWD",
            "kernels.threefry.LAUNCHES"} <= set(rec["levels"])
    # a full buffer drops what comes beyond it, and says how much
    spans.enable(capacity=4)
    for _ in range(3):
        with spans.span("a"):
            spans.count("c")
    spans.disable()
    rec = spans.records()
    assert len(rec["spans"]) + len(rec["counts"]) == 4 and rec["dropped"] == 2


def test_every_kernel_launch_counter_is_listed_once_and_is_a_tracer_level():
    """``kernels.COUNTERS`` names every ``LAUNCHES*`` int of every kernel
    module, each once, and the tracer's levels beyond ``level()``'s are
    those names, in that order, at the counters' values."""
    import importlib
    import pkgutil

    found = set()
    for info in pkgutil.iter_modules(kernels.__path__):
        module = importlib.import_module(f"{kernels.__name__}.{info.name}")
        found |= {f"kernels.{info.name}.{a}" for a in vars(module) if a.startswith("LAUNCHES")}
    assert len(set(kernels.COUNTERS)) == len(kernels.COUNTERS)
    assert set(kernels.COUNTERS) == found
    spans.enable()
    spans.disable()
    levels = spans.records()["levels"]
    assert [k for k in levels if k not in spans._LEVELS] == list(kernels.COUNTERS)
    assert {k: levels[k] for k in kernels.COUNTERS} == kernels.launches()


def test_spans_lie_on_the_profilers_clock():
    spans.enable()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        for i in range(100):
            with spans.span("probe", step=i), torch.profiler.record_function(f"probe{i}"):
                torch.ones(64).sum()
    spans.disable()
    ranges = {e.name(): (e.start_ns(), e.end_ns()) for e in prof.profiler.kineto_results.events()
              if e.name().startswith("probe")}
    mine = [s for s in spans.records()["spans"] if s.name == "probe"]
    assert len(mine) == len(ranges) == 100
    starts = [abs(ranges[f"probe{s.step}"][0] - s.start_ns) for s in mine]
    ends = [abs(ranges[f"probe{s.step}"][1] - s.end_ns) for s in mine]
    assert statistics.median(starts) < 50_000 and statistics.median(ends) < 50_000, (starts, ends)


def _raw_dump(root, n_utts=6, frames=40, hop=4, mels=8):
    """Scalar samples in [-1, 1] and mel frames, no speakers: the input the
    native loader does not take."""
    rng = np.random.default_rng(1)
    lines = []
    for i in range(n_utts):
        d = root / f"R{i}"
        d.mkdir(parents=True)
        np.save(d / "wave.npy", rng.uniform(-1, 1, frames * hop).astype(np.float32))
        np.save(d / "mel.norm.npy", rng.uniform(0, 1, (frames, mels)).astype(np.float32))
        lines.append(f"{d}/|{frames}|-1|dummy")
    (root / "train.txt").write_text("\n".join(lines) + "\n")
    return root


def _batches(tmp_path, path: str, on: bool, n: int = 4):
    """``n`` batches from ``data_iterator`` without prefetch (the caller's
    thread makes each), on the native loader's path (mu-law input) or the
    Python collator's (mu-law input with ``use_native=False``, or scalar
    input), the tracer on when ``on``."""
    if path == "raw":
        cfg = load_preset("vocoder_raw", "hop_size=4,max_time_steps=128,batch_size=2")
        ds = WaveDataset(str(_raw_dump(tmp_path / "dump")), cfg, feat_type="mel")
    else:
        cfg = load_preset("svqwae", TINY)
        ds = WaveDataset(str(_dump(tmp_path / "dump")), cfg)
    if on:
        spans.enable()
    it = data_iterator(ds, cfg, prefetch=0, use_native=path == "native")
    for _ in range(n):
        next(it)
    spans.disable()
    return spans.records()


@pytest.mark.parametrize("path", ["raw", "mulaw_python"])
def test_the_python_collator_records_its_span_and_counter_once_a_batch(tmp_path, path):
    rec = _batches(tmp_path, path, on=True)
    by_id = {s.id: s for s in rec["spans"]}
    builds = [s for s in rec["spans"] if s.name == "data.build"]
    collates = [s for s in rec["spans"] if s.name == "data.collate"]
    assert len(builds) == 4 and [s.batch for s in collates] == [1, 2, 3, 4]
    for s in collates:
        load = by_id[s.parent]
        assert load.name == "data.load" and by_id[load.parent].name == "data.build"
        assert load.start_ns <= s.start_ns <= s.end_ns <= load.end_ns
    assert rec["counters"] == {"data.batches": 4, "data.collated": 4}
    assert sorted((n, k, by_id[p].name) for n, k, p in rec["counts"] if n == "data.collated") == [
        ("data.collated", 1, "data.collate")] * 4


def test_the_native_loader_records_no_collate(tmp_path):
    rec = _batches(tmp_path, "native", on=True)
    assert {s.name for s in rec["spans"]} == {"data.build", "data.load"}
    assert rec["counters"] == {"data.batches": 4}


@pytest.mark.parametrize("path", ["raw", "native"])
def test_off_the_data_path_records_nothing(tmp_path, path):
    assert _batches(tmp_path, path, on=False) == {}
