"""The benchmark of the PyTorch/CUDA port (``wavenet_autoencoders_tpu_torch``).

    python3 benchmarks/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the cards the cell asks
for. It runs one cell (``benchmarks/workloads/<cell>.json``): set-up, a
window of ``--seconds``, the check of what the window produced against the
plain reference, and prints one JSON line last on standard output: with
``--trace 0`` the cell's end-to-end metrics, with ``--trace 1`` its
per-layer metrics (``benchmarks/metrics``) and the breakdown of a profiled
stretch. Each number the check compares is printed beside its limit as the
last lines on standard error and under ``checks``, the line's last key.

It exits non-zero and prints no result without CUDA or with fewer cards
than the cell asks for, and when JAX or the JAX package was loaded.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "wavenet_autoencoders_tpu")
DRIVERS = {"train": "benchlib.train"}


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's, Flax's or the JAX
    package's, compared whole (the port's name begins with the package's)."""
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN)


def cache_dirs() -> None:
    """Every build and kernel cache at a fixed path inside the checkout."""
    cache = ROOT / ".bench_cache"
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(cache / sub)


def run_cell(name: str, seed: int, seconds: float, trace: bool, device: str = "cuda", hooks=None,
             t_start: float | None = None, root: Path = HERE, info: dict | None = None) -> dict:
    """One run of a cell; returns the result line's object (``info`` gets
    set-up's phases). ``device``, ``hooks`` (planted faults) and ``root`` (a
    copy of this folder) are for the tests' CPU runs."""
    import importlib

    from benchlib import checks
    from benchlib.cells import load_cell, read_metrics

    cell = load_cell(name, root)
    driver = importlib.import_module(DRIVERS[cell.kind])
    r = driver.run(cell, seed, seconds, trace, device, T_START if t_start is None else t_start, hooks)
    bad = forbidden_modules()
    if bad:
        raise SystemExit(f"JAX or the JAX package is loaded: {', '.join(bad)}")
    correct, shown = checks.judge(r["numbers"], cell.limits)
    correct = correct and r["failed"] == 0
    import torch

    if device == "cuda":
        dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": cell.chips,
               "memory_peak_bytes": int(r["memory_peak_bytes"])}
    else:
        dev = {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    line = {"correct": bool(correct), "attempted": int(r["attempted"]), "failed": int(r["failed"])}
    if trace:
        run = r["run"]
        line["metrics"] = read_metrics(run, root)
        tr = run.get("trace")
        if tr is not None:
            dev["busy_s"], dev["window_s"] = tr.busy_s(), tr.window_s
        line["device"] = dev
        if tr is not None:
            line["breakdown"] = tr.breakdown()
    else:
        line["metrics"] = {**r["end_to_end"], "setup_s": {"value": r["setup_s"], "unit": "s"}}
        line["device"] = dev
    line["checks"] = shown
    if info is not None:
        info["setup_laps"] = r["setup_laps"]
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cache_dirs()
    sys.path[:0] = [str(ROOT), str(HERE)]

    import torch

    t_torch = time.perf_counter() - T_START
    # one intra-op thread: set-up's host work runs no faster on a pool of
    # threads that spin beside the loader's thread, and varies more
    torch.set_num_threads(1)
    from benchlib.cells import load_cell

    chips = load_cell(args.workload).chips
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"needs {chips} CUDA device(s); found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    from wavenet_autoencoders_tpu_torch.kernels import build

    build.build()  # every kernel of the port, in parallel, where the checkout has no build yet
    t_build = time.perf_counter() - T_START
    info = {}
    line = run_cell(args.workload, args.seed, args.seconds, bool(args.trace), info=info)
    bad = forbidden_modules()
    if bad:
        print(f"JAX or the JAX package is loaded: {', '.join(bad)}", file=sys.stderr)
        return 3
    laps = [("import_torch", t_torch), ("cuda_and_build", t_build - t_torch)] + [
        (k, v - t_build if k == "start" else v) for k, v in info["setup_laps"]]
    print("setup_s by phase: " + ", ".join(f"{k} {v:.3f}" for k, v in laps), file=sys.stderr)
    for name, c in line["checks"].items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
