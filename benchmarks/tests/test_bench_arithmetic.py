"""The harness's arithmetic on fabricated inputs: the tail over every step,
the whole step's share of the peak, the idle share and the gaps from
profiler intervals, and the form of a run's last line."""
import json
import subprocess
import sys
from pathlib import Path

import pytest

from benchlib import cells
from benchlib.trace import Trace
from benchlib.train import p95
import bench_tiny as tiny

HERE = Path(__file__).resolve().parent.parent
READERS = cells.metric_readers()


def test_p95_is_over_every_step_not_chunks():
    steps = [100.0] * 94 + [150.0] * 6  # 6 slow steps in 100: above the 95th rank
    assert p95(steps) == 150.0
    chunks = [p95(steps[i : i + 50]) for i in (0, 50)]  # a per-chunk statistic would hide them
    assert min(chunks) == 100.0
    assert p95(list(reversed(steps))) == 150.0 and p95([3.0]) == 3.0


def test_train_mfu_leaves_out_the_profiled_stretch():
    cfg = json.loads((HERE / "configs" / "svqwae.json").read_text())
    iv = [100.0] * 40
    iv[21:32] = [500.0] * 11
    run = {"kind": "train", "cfg": cfg, "B": 40, "T": 5120, "intervals_ms": iv,
           "stretch": {"first": 21, "steps": 10}}
    from counts.flops import H100_BF16_FLOPS, train_step_flop

    want = 100.0 * train_step_flop(cfg, 40, 5120) / 0.1 / H100_BF16_FLOPS
    assert READERS["train_mfu"].read(run) == pytest.approx(want)


def test_idle_share_and_gaps_from_profiler_intervals():
    t = Trace(device=[("a", 0, 40), ("b", 30, 50), ("c", 70, 80), ("d", 95, 130)],
              host=[("bench.window", 10, 110), ("bench.loader_wait", 50, 72), ("aten::copy_", 55, 65)],
              lo=10, hi=110)
    assert t.busy_s() == pytest.approx((40 + 10 + 15) / 1e9)  # [10,50], [70,80], [95,110]
    assert t.gaps() == [(50, 70), (80, 95)]
    run = {"kind": "train", "trace": t}
    assert READERS["device_idle_share.train"].read(run) == pytest.approx(35.0)
    assert READERS["device_idle_share.train"].read({"kind": "train", "trace": None}) is None
    b = t.breakdown()
    assert b["idle_gaps"][0] == ["bench.loader_wait / aten::copy_", 20 / 1e9]
    assert b["device_ops"][0] == ["a", 30 / 1e9] and len(b["device_ops"]) == 4


def test_no_result_without_a_card_or_without_the_program(tmp_path):
    import shutil

    shutil.copytree(HERE, tmp_path / "benchmarks", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(HERE.parent / "BENCHMARK.json", tmp_path)
    for cwd in (HERE.parent, tmp_path):
        out = subprocess.run([sys.executable, "benchmarks/run.py", "--workload", "svqwae-train", "--seed",
                              str(2**31 + 3), "--seconds", "1", "--trace", "0"], cwd=cwd, capture_output=True,
                             text=True, timeout=120)
        assert out.returncode != 0 and out.stdout.strip() == "", out


def test_the_last_line_has_its_form(tmp_path, monkeypatch):
    import run

    root = tiny.make(tmp_path / "benchmarks")
    out = run.run_cell("tiny-in-train", 2**31 + 5, 0.3, True, device="cpu", root=root)
    assert list(out) == ["correct", "attempted", "failed", "metrics", "device", "breakdown", "checks"]
    assert {"loader_wait_ms.train", "train_mfu"} <= set(out["metrics"])
    assert all(set(m) == {"value", "unit"} for m in out["metrics"].values())
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    assert all(set(c) == {"value", "limit"} for c in out["checks"].values())
    json.dumps(out)
