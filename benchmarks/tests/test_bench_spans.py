"""The port's tracer read through the benchmark's train run (``span_report.py``):
a tiny traced run on the CPU gives every step its host spans and its
batch's wait and build, with no launch on the CPU; the device idle inside
the launch spans is read from a hand-built trace; and on the card
(``-m chip``) the ``step.launch`` spans agree with the profiler's
``cudaGraphLaunch`` calls, and each replay's kernels start after its
launch span began."""
import pytest
import torch

import run
import span_report as sr
import bench_tiny as tiny
from benchlib import train as btrain
from benchlib.cells import load_cell
from benchlib.trace import Trace

SEED = 2**31 + 23


@pytest.fixture
def spans():
    from wavenet_autoencoders_tpu_torch.utils import spans

    spans.reset()
    yield spans
    spans.reset()


def test_a_tiny_traced_run_reads_every_steps_spans(tmp_path, spans):
    import time

    cell = load_cell("tiny-train", tiny.make(tmp_path / "benchmarks"))
    r = btrain.run(cell, SEED, 0.5, True, "cpu", time.perf_counter(), {"step": sr.tracer_after_setup(True)})
    spans.disable()
    recs = spans.records()
    rows = sr.per_step(recs, r["run"]["intervals_ms"])
    assert [x["step"] for x in rows] == list(range(sr.WINDOW_FROM, sr.WINDOW_FROM + r["attempted"]))
    assert [x["batch"] for x in rows] == [x["step"] + 1 for x in rows]
    for x in rows:
        assert x["step_ms"] > 0 and x["host_ms"] == x["step_ms"] and x["wait_ms"] >= 0
        assert x["launch_ms"] == 0 and x["inputs_wait_ms"] == 0  # the eager step on the CPU
    assert any(x["build_ms"] for x in rows)
    assert "graph.nodes" not in recs["levels"] or recs["levels"]["graph.nodes"] > 0
    # the tracer off behind the same wrapper: nothing recorded
    spans.reset()
    btrain.run(cell, SEED, 0.2, False, "cpu", time.perf_counter(), {"step": sr.tracer_after_setup(False)})
    assert spans.records() == {}


def test_launch_idle_is_the_idle_inside_the_launch_spans_from_the_first_operation():
    from wavenet_autoencoders_tpu_torch.utils.spans import Span

    tr = Trace(device=[("k", 100, 200), ("k", 250, 400), ("k", 450, 500)], lo=0, hi=600)
    launch = lambda a, b: Span(0, "step.launch", a, b, 1, None, None, None, None)  # noqa: E731
    # idle: [0, 100) before the first operation (left out), [200, 250), [400, 450), [500, 600)
    recs = {"spans": [launch(50, 220), launch(380, 430), launch(520, 530)]}
    assert sr.launch_idle_ms(tr, recs, {"steps": 2}) == pytest.approx((20 + 30 + 10) / 1e6 / 2)


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
