"""BENCHMARK.json resolves by name: every cell's configuration, traffic
and the metric readers; names and units keep to their characters; a cell
added as files to a copy of the folder is found without editing any file
that is there."""
import json
import re
import shutil
from pathlib import Path

import pytest

from benchlib import cells

HERE = Path(__file__).resolve().parent.parent
MANIFEST = json.loads((HERE.parent / "BENCHMARK.json").read_text())
KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
LINE = re.compile(r"^[^\n\t]{1,200}$")


def test_the_manifests_keys_and_limits():
    assert set(MANIFEST) == KEYS
    assert MANIFEST["command"] == ["python3", "benchmarks/run.py"] and MANIFEST["paths"] == ["benchmarks"]
    assert 1 <= MANIFEST["run_seconds"] <= 51
    assert len((HERE.parent / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    names = [e["name"] for k in ("configs", "workloads", "end_to_end", "per_layer") for e in MANIFEST[k]]
    assert len(names) == len(set(names))
    for n in names:
        assert cells.NAME.match(n), n
    for m in MANIFEST["end_to_end"] + MANIFEST["per_layer"]:
        assert cells.UNIT.match(m["unit"]) and m["better"] in ("lower", "higher"), m
    for e in MANIFEST["end_to_end"]:
        assert e["source"] in ("host_clock", "device_trace") and 0.01 <= e["bound"] <= 0.25
    assert any(e["name"] == "setup_s" for e in MANIFEST["end_to_end"])
    for c in MANIFEST["configs"] + MANIFEST["workloads"]:
        assert LINE.match(c["why"]), c
    pairs = [(w["config"], w["traffic"]) for w in MANIFEST["workloads"]]
    assert len(pairs) == len(set(pairs))


@pytest.mark.parametrize("w", MANIFEST["workloads"], ids=lambda w: w["name"])
def test_every_cell_resolves_by_name(w):
    cell = cells.load_cell(w["name"])
    assert (cell.config_name, cell.traffic_name, cell.chips) == (w["config"], w["traffic"], w["chips"])
    conf = next(c for c in MANIFEST["configs"] if c["name"] == w["config"])
    assert (HERE.parent / conf["file"]).resolve() == (HERE / "configs" / f"{w['config']}.json").resolve()
    assert cell.kind == "train" and cell.limits
    e2e = {e["name"] for e in MANIFEST["end_to_end"] if w["name"] in e.get("workloads", [w["name"]])}
    assert "setup_s" in e2e and len(e2e) >= 2
    per = [m for m in MANIFEST["per_layer"] if w["name"] in m.get("workloads", [])]
    assert per and all(m["moves"] in e2e for m in per)


def test_every_per_layer_metric_has_its_reader():
    readers = cells.metric_readers()
    for m in MANIFEST["per_layer"]:
        assert readers[m["name"]].UNIT == m["unit"], m["name"]
    layers = {m["layer"] for m in MANIFEST["per_layer"]}
    assert all(LINE.match(x) for x in layers)


def test_a_new_cell_is_found_from_files_alone(tmp_path):
    root = tmp_path / "benchmarks"
    shutil.copytree(HERE, root, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    before = {p: p.read_bytes() for p in root.rglob("*") if p.is_file()}
    (root / "traffic" / "train_short.json").write_text(json.dumps(
        {"kind": "train_crops", "utterances": 64, "seconds_min": 1.0, "seconds_max": 2.0,
         "level_min": 0.05, "level_max": 0.2}))
    (root / "workloads" / "inae-train-short.json").write_text(json.dumps(
        {"config": "inae", "traffic": "train_short", "chips": 1, "limits": {"loss_gap": 1.0}}))
    (root / "metrics" / "steps_seen.py").write_text(
        "UNIT = 'steps'\n\ndef read(run):\n    return run.get('steps')\n")
    cell = cells.load_cell("inae-train-short", root)
    assert cell.config["name"] == "inae" and cell.kind == "train" and cell.traffic["utterances"] == 64
    assert cells.read_metrics({"kind": "train", "steps": 7, "loader_wait_s": []}, root)["steps_seen"] == {
        "value": 7.0, "unit": "steps"}
    assert all(p.read_bytes() == b for p, b in before.items())


def test_a_malformed_name_is_refused():
    with pytest.raises(ValueError):
        cells.load_cell("no such/cell")
