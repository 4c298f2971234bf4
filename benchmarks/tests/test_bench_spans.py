"""The port's tracer in the benchmark's train run: a traced run (``--trace
1``) records it over the window into ``run["spans"]``, a run of ``--trace
0`` never turns it on, and the tracer is off and empty after either, also
after a window that raises. The readers of its spans take the window's
steps before the profiler first ran, and a reader added to a copy of the
folder reads a counter of the program by that file alone. Also the host
spans per step (``benchlib/span_rows.py``, which ``span_report.py`` prints),
the device idle inside the launch spans from a hand-built trace, and on
the card (``-m chip``) the ``step.launch`` spans against the profiler's
``cudaGraphLaunch`` calls, and the traced run's launch read below the
profiler's."""
import time
from pathlib import Path

import pytest
import torch

import run
import span_report as sr
import bench_tiny as tiny
from benchlib import cells
from benchlib import train as btrain
from benchlib.cells import load_cell
from benchlib.span_rows import before_profiler, per_step
from benchlib.trace import Trace

SEED = 2**31 + 23
NEW = ("batch_build_ms.train", "step_host_ms.train", "graph_launch_ms.train", "graph_nodes.train")
READERS = cells.metric_readers()
PREFETCH = 3  # data_iterator's default: batches made before the tracer turned on sit in its queue, one more in hand


@pytest.fixture
def spans():
    from wavenet_autoencoders_tpu_torch.utils import spans

    spans.reset()
    yield spans
    spans.reset()


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.make(tmp_path_factory.mktemp("bench") / "benchmarks")


@pytest.fixture(scope="module")
def traced(root):
    """A traced tiny run: the driver's result and whether the tracer was
    left on or holding records."""
    from wavenet_autoencoders_tpu_torch.utils import spans

    spans.reset()
    r = btrain.run(load_cell("tiny-train", root), SEED, 0.5, True, "cpu", time.perf_counter())
    after = (spans.enabled(), spans.records())
    spans.reset()
    return r, after


def test_a_tiny_traced_run_reads_every_steps_spans(root, traced, spans):
    r, _ = traced
    run_ = r["run"]
    assert run_["window_from"] == btrain.SETUP_STEPS
    recs = run_["spans"]
    assert recs["dropped"] == 0
    rows = per_step(recs, run_["intervals_ms"], run_["window_from"])
    # every window step has its step span, and consumes the batch after its own
    assert [x["step"] for x in rows] == list(range(run_["window_from"], run_["window_from"] + r["attempted"]))
    assert [x["batch"] for x in rows] == [x["step"] + 1 for x in rows]
    for x in rows:
        assert x["step_ms"] > 0 and x["host_ms"] == x["step_ms"] and x["wait_ms"] >= 0
        assert x["launch_ms"] == 0 and x["inputs_wait_ms"] == 0 and x["launches"] == 0  # the eager step on the CPU
    # every batch made after the tracer turned on has its build; those made before sit at the window's start
    built = [x["build_ms"] is not None for x in rows]
    first = built.index(True)
    assert first <= PREFETCH + 1 and all(built[first:]), built
    assert "graph.nodes" not in recs["levels"] or recs["levels"]["graph.nodes"] > 0
    # span_report's run of --trace 0: the tracer turned on by its wrapper after set-up, the same rows
    cell = load_cell("tiny-train", root)
    r0 = btrain.run(cell, SEED, 0.2, False, "cpu", time.perf_counter(), {"step": sr.tracer_after_setup(True)})
    spans.disable()
    rows0 = per_step(spans.records(), r0["run"]["intervals_ms"], r0["run"]["window_from"])
    assert [x["step"] for x in rows0] == list(range(btrain.SETUP_STEPS, btrain.SETUP_STEPS + r0["attempted"]))
    # the tracer off behind the same wrapper: nothing recorded
    spans.reset()
    btrain.run(cell, SEED, 0.2, False, "cpu", time.perf_counter(), {"step": sr.tracer_after_setup(False)})
    assert spans.records() == {}


def test_the_four_readers_read_the_traced_run_before_the_profiler(root, traced):
    r, _ = traced
    run_ = r["run"]
    rows = before_profiler(run_)
    assert [x["i"] for x in rows] == list(range(btrain.TRACE_FROM))
    got = {name: READERS[name].read(run_) for name in NEW}
    assert got["batch_build_ms.train"] > 0 and got["step_host_ms.train"] > 0
    # the CPU's step is eager: no graph launched, none captured
    assert got["graph_launch_ms.train"] is None and got["graph_nodes.train"] is None
    line = cells.read_metrics(run_, root)
    assert {k for k in NEW if k in line} == {"batch_build_ms.train", "step_host_ms.train"}


def test_a_run_of_trace_0_never_turns_the_tracer_on(root, spans):
    seen = []

    def watch(fn):
        def step(state, batch):
            seen.append(spans.enabled())
            state, m = fn(state, batch)
            seen.append(spans.enabled())
            return state, m

        return step

    r = btrain.run(load_cell("tiny-train", root), SEED, 0.3, False, "cpu", time.perf_counter(), {"step": watch})
    assert len(seen) == 2 * (btrain.SETUP_STEPS + r["attempted"]) and not any(seen)
    assert "spans" not in r["run"] and spans.records() == {}
    assert all(READERS[name].read(r["run"]) is None for name in NEW)


def test_the_tracer_is_off_and_empty_after_a_run_and_after_a_window_that_raises(root, traced, spans):
    assert traced[1] == (False, {})

    def fail_in_window(fn):
        calls = iter(range(1, 10**6))

        def step(state, batch):
            if next(calls) == btrain.SETUP_STEPS + 3:
                assert spans.enabled()  # inside the traced window
                raise RuntimeError("planted")
            return fn(state, batch)

        return step

    with pytest.raises(RuntimeError, match="planted"):
        btrain.run(load_cell("tiny-train", root), SEED, 0.3, True, "cpu", time.perf_counter(),
                   {"step": fail_in_window})
    assert not spans.enabled() and spans.records() == {}


def _span(i, name, a, b, parent=None, step=None, batch=None):
    from wavenet_autoencoders_tpu_torch.utils.spans import Span

    return Span(i, name, int(a * 1e6), int(b * 1e6), 1, parent, step, batch, None)


def test_host_span_readers_take_the_steps_before_the_stretch_alone():
    # three window steps from step 3, the stretch from window step 2: its launch reads the profiler's 9 ms
    recs = {"spans": [], "counts": [], "counters": {}, "levels": {"graph.nodes": 1234}, "dropped": 0}
    for i, (host, launch, build) in enumerate([(3.0, 0.2, 10.0), (3.4, 0.3, 12.0), (2.0, 9.0, 30.0)]):
        k, t = 10 * i, 100.0 * i
        recs["spans"] += [_span(k, "data.build", t, t + build, batch=4 + i),
                          _span(k + 1, "step", t + 50, t + 50 + host + launch, step=3 + i, batch=4 + i),
                          _span(k + 2, "step.launch", t + 50 + host, t + 50 + host + launch, parent=k + 1)]
    run_ = {"kind": "train", "intervals_ms": [80.0, 80.0, 80.0], "window_from": 3, "spans": recs,
            "stretch": {"first": 2, "steps": 1}}
    got = {name: READERS[name].read(run_) for name in NEW}
    assert got == pytest.approx({"batch_build_ms.train": 11.0, "step_host_ms.train": 3.2,
                                 "graph_launch_ms.train": 0.25, "graph_nodes.train": 1234})
    for lost in ({**recs, "dropped": 1}, {}):  # a span dropped, or no records: nothing read
        assert all(READERS[name].read({**run_, "spans": lost}) is None for name in NEW)


def test_a_reader_added_as_a_file_reads_the_programs_counter(tmp_path):
    root = tiny.make(tmp_path / "benchmarks")
    before = {p: p.read_bytes() for p in root.rglob("*") if p.is_file()}
    (root / "metrics" / "batches_seen.py").write_text(
        'UNIT = "batches"\n\n\ndef read(run):\n'
        '    return run["spans"]["counters"].get("data.batches") if run.get("spans") else None\n')
    line = run.run_cell("tiny-train", SEED, 0.3, True, device="cpu", root=root)
    assert line["correct"], line["checks"]
    seen = line["metrics"]["batches_seen"]
    # the window's batches, less those made before the tracer turned on, plus those made ahead
    assert seen["unit"] == "batches"
    assert line["attempted"] - PREFETCH - 1 <= seen["value"] <= line["attempted"] + PREFETCH + 1
    assert "batches_seen" not in run.run_cell("tiny-train", SEED, 0.2, False, device="cpu", root=root)["metrics"]
    assert all(p.read_bytes() == b for p, b in before.items())
    assert sorted(p.relative_to(root) for p in root.rglob("*") if p.is_file() and p not in before
                  and "__pycache__" not in p.parts) == [Path("metrics/batches_seen.py")]


def test_launch_idle_is_the_idle_inside_the_launch_spans_from_the_first_operation():
    from wavenet_autoencoders_tpu_torch.utils.spans import Span

    tr = Trace(device=[("k", 100, 200), ("k", 250, 400), ("k", 450, 500)], lo=0, hi=600)
    launch = lambda a, b: Span(0, "step.launch", a, b, 1, None, None, None, None)  # noqa: E731
    # idle: [0, 100) before the first operation (left out), [200, 250), [400, 450), [500, 600)
    recs = {"spans": [launch(50, 220), launch(380, 430), launch(520, 530)]}
    assert sr.launch_idle_ms(tr, recs, {"steps": 2}) == pytest.approx((20 + 30 + 10) / 1e6 / 2)


@pytest.mark.chip
def test_a_traced_runs_graph_launch_reads_below_the_profilers(cuda):
    # the profiler lengthens cudaGraphLaunch to ~2-10 ms from its stretch on; before it, ~0.2 ms
    run.cache_dirs()
    out = run.run_cell("svqwae-train", SEED, 10.0, True)
    assert out["correct"], out["checks"]
    m = out["metrics"]
    assert set(NEW) <= set(m), sorted(m)
    assert 0 < m["graph_launch_ms.train"]["value"] < 1.0, m["graph_launch_ms.train"]
    assert m["graph_nodes.train"]["value"] > 0


@pytest.mark.chip
def test_launch_spans_agree_with_cuda_graph_launch_on_the_card(cuda, spans):
    first, steps = 5, 10  # the profiler's start and end take seconds: the window of 20 s outlasts them
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    on_card = torch.autograd.DeviceType.CUDA
    held = {}

    def hook(fn):
        def step(state, batch):
            if state.step == first:
                torch.cuda.synchronize()
                held["prof"] = torch.profiler.profile(activities=acts)
                held["prof"].__enter__()
                spans.enable()
            state, m = fn(state, batch)
            if state.step == first + steps:
                torch.cuda.synchronize()
                spans.disable()
                held["prof"].__exit__(None, None, None)
                held["events"] = [(e.name(), e.device_type() == on_card, e.start_ns(), e.end_ns(), e.correlation_id())
                                  for e in held["prof"].profiler.kineto_results.events()]
            return state, m

        return step

    run.cache_dirs()
    out = run.run_cell("svqwae-train", SEED, 20.0, False, hooks={"step": hook})
    assert out["correct"], out["checks"]
    assert "events" in held, f"the window ended before step {first + steps}: {out['attempted']} steps"
    recs = spans.records()
    launches = sorted((s for s in recs["spans"] if s.name == "step.launch"), key=lambda s: s.start_ns)
    events = held["events"]
    calls = sorted((e for e in events if e[0] == "cudaGraphLaunch" and not e[1]), key=lambda e: e[2])
    assert len(launches) == len(calls) == steps
    span_ns = sum(s.end_ns - s.start_ns for s in launches)
    call_ns = sum(b - a for _, _, a, b, _ in calls)
    print(f"step.launch {span_ns / steps / 1e3:.1f} us a step, cudaGraphLaunch {call_ns / steps / 1e3:.1f} us")
    assert abs(span_ns - call_ns) <= max(0.05 * call_ns, 20_000 * steps), (span_ns, call_ns)
    for s, (_, _, a, b, corr) in zip(launches, calls):
        assert s.start_ns - 20_000 <= a and b <= s.end_ns + 20_000, (s, a, b)
        ops = [e[2] for e in events if e[1] and e[4] == corr]
        # the replay's operations: after its launch began, and no more than the captured graph's nodes
        assert ops and min(ops) > s.start_ns, (s, corr, len(ops))
        assert len(ops) <= recs["levels"]["graph.nodes"], (len(ops), recs["levels"]["graph.nodes"])
    print(f"graph.nodes {recs['levels']['graph.nodes']}, device operations a replay {len(ops)}")
