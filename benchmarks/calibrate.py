"""Readings that the limits of a train cell's check are set from (not run by
the benchmark's own runs):

    python3 benchmarks/calibrate.py --workload <cell> --seeds 1,2,3 [--seconds S]

For each seed, in one process: a run of the cell (set-up, a window of
``--seconds``, its check), and beside the program's numbers the same
numbers read off

- the control: the configuration's plain reference (``Cell.reference``)
  computed one type below the configuration's bfloat16, in float8 (its
  'fp8' mode), put in the program's place;
- the faults "half of the batch left out" (the reference over the batch's
  first half, the mean taken over it) and "a step that returns its state
  unchanged" (the reference's steps without their updates), each in the
  program's place;

and, as a diagnostic of the program's own rounding, the reference in
bfloat16 (``bf16``); the leaves with widest gaps; and per leaf the
elements the change leaves out (``checks.counted``). Prints one JSON line
a seed.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE.parent), str(HERE)]


def worst(prog, ref, w0, grad64, n=3):
    """The leaves with the widest gaps of the first gradient and of the change."""
    from benchlib import checks

    g_ref = checks.norms(ref["first_grad"])
    keep = checks.counted(ref["first_grad"], grad64)
    delta = lambda tree: {k: (tree[k].double() - w0[k].double())[m] for k, m in keep.items()}  # noqa: E731
    out = {}
    for name, a, b in (("grad", checks.norms(prog["first_grad"]), g_ref),
                       ("change", checks.norms(delta(prog["params"])), checks.norms(delta(ref["params"])))):
        gaps = checks.leaf_gaps(a, b)
        out[name] = [[k, round(gaps[k], 5), a[k], b[k]] for k in sorted(gaps, key=lambda k: -gaps[k])[:n]]
    return out


def train_hook(w0, feed, ref, grad64, cfg, prog, reference):
    from benchlib import checks

    import torch

    steps = reference.train_steps
    with reference.precision():
        fp8 = steps(w0, feed, cfg, "fp8")
        bf16 = steps(w0, feed, cfg, "bf16")
        half = steps(w0, feed, cfg, "f32", rows_used=torch.arange(feed[0]["x"].shape[0] // 2,
                                                                   device=feed[0]["x"].device))
        frozen = steps(w0, feed, cfg, "f32", frozen=True)
    keep = checks.counted(ref["first_grad"], grad64)
    left_out = {k: [int(g.numel() - (keep[k].sum() if k in keep else 0)), int(g.numel())]
                for k, g in ref["first_grad"].items()}
    return {"control": checks.train_numbers(fp8, ref, w0, grad64),
            "fault": checks.train_numbers(half, ref, w0, grad64),
            "unchanged": checks.train_numbers(frozen, ref, w0, grad64),
            "bf16": checks.train_numbers(bf16, ref, w0, grad64),
            "left_out": {k: v for k, v in left_out.items() if v[0]},
            "worst": {"program": worst(prog, ref, w0, grad64), "control": worst(fp8, ref, w0, grad64),
                      "fault": worst(half, ref, w0, grad64)}}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=0.0)
    args = ap.parse_args()
    import run
    import torch

    run.cache_dirs()
    torch.set_num_threads(1)
    from wavenet_autoencoders_tpu_torch.kernels import build

    build.build()
    import importlib

    from benchlib.cells import load_cell

    cell = load_cell(args.workload)
    driver = importlib.import_module(run.DRIVERS[cell.kind])
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        r = driver.run(cell, seed, args.seconds, False, "cuda", t0, {"after_reference": train_hook})
        cal = r["calibration"]
        print(json.dumps({"seed": seed, "program": r["numbers"], **cal, "failed": r["failed"],
                          "end_to_end": r["end_to_end"], "setup_s": r["setup_s"],
                          "seconds": time.perf_counter() - t0}), flush=True)
    bad = run.forbidden_modules()
    if bad:
        print(f"JAX or the JAX package is loaded: {bad}", file=sys.stderr)
        return 3
    return 0


if __name__ == "__main__":
    sys.exit(main())
