"""A short run of every cell on the card, its check included (the card's
kernels have no CPU mode): ``python -m pytest benchmarks/tests -q -m chip``."""
import json
from pathlib import Path

import pytest

import run

CELLS = [w["name"] for w in json.loads((Path(__file__).resolve().parents[2] / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.chip
@pytest.mark.parametrize("cell", CELLS)
def test_a_short_run_on_the_card_is_correct(cuda, cell):
    run.cache_dirs()
    out = run.run_cell(cell, 2**31 + 17, 3.0, False)
    assert out["correct"], out["checks"]
    assert out["device"]["platform"] == "gpu" and out["device"]["memory_peak_bytes"] > 0
