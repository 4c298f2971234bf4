"""Runs a train cell of the benchmark with the port's tracer on for its whole
window (``wavenet_autoencoders_tpu_torch/utils/spans.py``), or off, and
reads the spans per step:

    python3 benchmarks/span_report.py --workload inae-train --seed 7 [--seconds 45] [--tracer on|off] [--trace 0|1]

from the root of a checkout. Not a run of the benchmark: one run a
process of a cell's train run (``benchlib/train.py:run``, as ``run.py``
calls it). With ``--trace 0`` its step object is wrapped so that the
tracer turns on after set-up's steps (the same wrapper whether on or
off); with ``--trace 1`` the driver records the tracer over the window
itself (``run["spans"]``), so ``--tracer off`` is refused there. It prints the end-to-end
numbers and ``correct``; with the tracer on, per window step the host
times of its spans (``benchlib/span_rows.py:per_step``: ``launch`` =
``step.launch``, ``inputs_wait`` = ``step.inputs_wait``, ``host`` =
``step`` less both, ``wait`` = the ``data.wait`` of its batch, ``build`` =
that batch's ``data.build``) and
its ``host.pinned_allocs``, summarised for the slow and the fast steps
(a step is slow whose device interval exceeds the median of the window's
second half by more than ``SLOW_MS``), and the per-layer numbers these
give over the window's steps outside the profiled stretch and the step
after it (``launch_idle_ms`` from the stretch, with ``--trace 1``). The
profiler lengthens ``cudaGraphLaunch`` from its stretch on, so with
``--trace 1`` these means read it; the benchmark's readers
(``metrics/graph_launch_ms.train.py`` ...) take the steps before it.
With ``--out`` it appends the run's JSON line, per-step rows included, to
that file.
Needs a CUDA card.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import itertools  # noqa: E402
import json  # noqa: E402
import statistics  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
sys.path[:0] = [str(ROOT), str(HERE)]

SLOW_MS = 0.5  # inae's slow steps take ~1.3 ms more than its fast ones


def tracer_after_setup(on: bool):
    """A step wrapper (the harness's ``step`` hook) that turns the tracer on
    once set-up's steps (the first ``SETUP_STEPS`` calls) are done, when
    ``on``."""
    from benchlib.train import SETUP_STEPS
    from wavenet_autoencoders_tpu_torch.utils import spans

    calls = itertools.count(1)

    def hook(fn):
        def step(state, batch):
            state, m = fn(state, batch)
            if next(calls) == SETUP_STEPS and on:
                spans.enable()
            return state, m

        return step

    return hook


def summary(rows: list[dict]) -> dict:
    keys = ("interval_ms", "step_ms", "launch_ms", "inputs_wait_ms", "host_ms", "wait_ms", "build_ms", "pinned_allocs")
    out = {"steps": len(rows), "first": rows[0]["i"] if rows else None, "last": rows[-1]["i"] if rows else None}
    for k in keys:
        v = [r[k] for r in rows if r[k] is not None]
        out[k] = statistics.median(v) if v else None
    out["pinned_allocs_sum"] = sum(r["pinned_allocs"] for r in rows)
    return out


def launch_idle_ms(tr, recs: dict, stretch: dict) -> float | None:
    """Device idle inside ``step.launch`` spans over the stretch, from its
    first device operation, a step."""
    ops = [a for _, a, _ in tr.clipped()]
    if not ops:
        return None
    lo = min(ops)
    launches = [(s.start_ns, s.end_ns) for s in recs["spans"] if s.name == "step.launch"]
    idle = 0
    for a, b in tr.gaps():
        a = max(a, lo)
        for la, lb in launches:
            idle += max(0, min(b, lb) - max(a, la))
    return idle / 1e6 / stretch["steps"]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=45.0)
    ap.add_argument("--tracer", choices=("on", "off"), default="on")
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    if args.trace and args.tracer == "off":
        ap.error("--trace 1 records the tracer over the window itself; --tracer off needs --trace 0")

    import run

    run.cache_dirs()
    import torch

    torch.set_num_threads(1)
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    from benchlib import checks
    from benchlib import train as btrain
    from benchlib.cells import load_cell
    from benchlib.span_rows import per_step
    from wavenet_autoencoders_tpu_torch.kernels import build
    from wavenet_autoencoders_tpu_torch.utils import spans

    build.build()
    cell = load_cell(args.workload)
    r = btrain.run(cell, args.seed, args.seconds, bool(args.trace), "cuda", T_START,
                   {"step": tracer_after_setup(args.tracer == "on" and not args.trace)})
    run_ = r["run"]
    if args.trace:
        recs = run_["spans"]
    else:
        spans.disable()
        recs = spans.records()
        spans.reset()
    correct = checks.judge(r["numbers"], cell.limits)[0] and r["failed"] == 0
    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    e2e = {k: v["value"] for k, v in r["end_to_end"].items()}
    line = {"workload": args.workload, "seed": args.seed, "tracer": args.tracer, "trace": args.trace, "gpu": gpu,
            "correct": correct, "setup_s": r["setup_s"], **e2e, "steps": r["attempted"]}
    if recs:
        rows = per_step(recs, run_["intervals_ms"], run_["window_from"])
        s = run_["stretch"]
        skip = set(range(s["first"], s["first"] + s["steps"] + 1)) if s else set()
        kept = [x for x in rows if x["i"] not in skip]
        half = [x["interval_ms"] for x in rows[len(rows) // 2:]]
        fast_ms = statistics.median(half)
        slow = [x for x in kept if x["interval_ms"] > fast_ms + SLOW_MS]
        fast = [x for x in kept if x["interval_ms"] <= fast_ms + SLOW_MS]
        mean = lambda k: statistics.fmean(x[k] for x in kept if x[k] is not None)  # noqa: E731
        line.update({
            "records": {"spans": len(recs["spans"]), "dropped": recs["dropped"], "counters": recs["counters"],
                        "levels": recs["levels"]},
            "metrics": {"batch_wait_ms": mean("wait_ms"), "batch_build_ms": mean("build_ms"),
                        "graph_launch_ms": mean("launch_ms"), "step_host_ms": mean("host_ms"),
                        "launch_idle_ms": launch_idle_ms(run_["trace"], recs, s) if run_["trace"] else None,
                        "graph_nodes": recs["levels"].get("graph.nodes")},
            "fast_interval_ms": fast_ms, "slow": summary(slow), "fast": summary(fast),
            "slow_steps": [x["i"] for x in slow][:400], "rows": rows})
    if args.out:
        out = Path(args.out)
        out.parent.mkdir(parents=True, exist_ok=True)
        with out.open("a") as f:
            f.write(json.dumps(line) + "\n")
    brief = {k: v for k, v in line.items() if k not in ("rows", "slow_steps")}
    print(json.dumps(brief), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
