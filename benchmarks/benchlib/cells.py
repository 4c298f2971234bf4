"""Everything of a cell found by name, so that a later change adds a cell,
a configuration, a traffic mix or a metric by adding files alone:

- ``workloads/<cell>.json``: the cell's configuration, traffic mix, chips
  and the limit of each number its check compares;
- ``configs/<config>.json``: the configuration as it is run (the model's
  keys; ``assumed`` lists what was set here rather than taken from the
  source);
- ``traffic/<traffic>.json``: the mix's parameters, with its ``kind``, the
  seeded generator ``traffic/<kind>.py`` that reads them;
- ``metrics/<metric>.py``: one reader per per-layer metric (``UNIT`` and
  ``read(run)``, which returns None where the run holds nothing to read).
"""
from __future__ import annotations

import importlib.util
import json
import re
from dataclasses import dataclass
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def check_name(name: str) -> str:
    if not NAME.match(name):
        raise ValueError(f"{name!r} is not a benchmark name (letters, digits, '_', '.', '-'; at most 64)")
    return name


def load_module(path: Path, name: str):
    """The module of a file by path (file names may hold dots)."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _json(path: Path) -> dict:
    if not path.is_file():
        raise FileNotFoundError(f"no {path.relative_to(HERE.parent)}")
    return json.loads(path.read_text())


@dataclass
class Cell:
    name: str
    config_name: str
    config: dict
    traffic_name: str
    traffic: dict
    generator: object
    chips: int
    limits: dict

    @property
    def kind(self) -> str:
        return self.generator.DRIVER


def load_cell(name: str, root: Path = HERE) -> Cell:
    spec = _json(root / "workloads" / f"{check_name(name)}.json")
    cfg_name, traffic_name = check_name(spec["config"]), check_name(spec["traffic"])
    config = _json(root / "configs" / f"{cfg_name}.json")
    traffic = _json(root / "traffic" / f"{traffic_name}.json")
    kind = check_name(traffic["kind"])
    gen = load_module(root / "traffic" / f"{kind}.py", f"bench_traffic_{kind}")
    return Cell(name, cfg_name, config, traffic_name, traffic, gen, int(spec.get("chips", 1)), dict(spec["limits"]))


def model_config(config: dict) -> dict:
    """The configuration's model keys (without ``assumed``)."""
    return {k: v for k, v in config.items() if k != "assumed"}


def metric_readers(root: Path = HERE) -> dict:
    """{metric name: reader module} for every ``metrics/<name>.py``."""
    out = {}
    for path in sorted((root / "metrics").glob("*.py")):
        name = check_name(path.name[: -len(".py")])
        mod = load_module(path, "bench_metric_" + name.replace(".", "_").replace("-", "_"))
        if not UNIT.match(mod.UNIT):
            raise ValueError(f"metric {name}: unit {mod.UNIT!r}")
        out[name] = mod
    return out


def read_metrics(run, root: Path = HERE) -> dict:
    """{name: {value, unit}} of every reader that finds something in ``run``."""
    out = {}
    for name, mod in metric_readers(root).items():
        value = mod.read(run)
        if value is not None:
            out[name] = {"value": float(value), "unit": mod.UNIT}
    return out
