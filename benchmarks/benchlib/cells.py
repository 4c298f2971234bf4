"""Everything of a cell found by name, so that a later change adds a cell,
a configuration, a traffic mix or a metric by adding files alone:

- ``workloads/<cell>.json``: the cell's configuration, traffic mix, chips
  and the limit of each number its check compares;
- ``configs/<config>.json``: the configuration as it is run (the model's
  keys; ``assumed`` lists what was set here rather than taken from the
  source). Two more keys stand outside the model's, as ``assumed`` does:
  ``reference``, the plain reference's module ``reference/<name>.py``
  (default ``wae``), and ``features``, the conditioning features the dump
  holds and the loader reads, ``mfcc`` or ``mel`` (default ``mfcc``);
- ``traffic/<traffic>.json``: the mix's parameters, with its ``kind``, the
  seeded generator ``traffic/<kind>.py`` that reads them;
- ``metrics/<metric>.py``: one reader per per-layer metric (``UNIT`` and
  ``read(run)``, which returns None where the run holds nothing to read).

The ``run`` a reader gets (``benchlib/train.py``, a train cell).
``run.py`` calls the readers in ``--trace 1`` runs alone; a reader
returns None on a run that lacks what it reads, as a ``--trace 0`` run
lacks the keys marked "traced":

- ``kind`` (``"train"``), ``cfg`` (the model's keys), ``B``, ``T``;
- ``steps``, ``window_s``: the window's steps and host seconds;
- ``intervals_ms``: each window step's device interval (CUDA events);
- ``loader_wait_s``: each window step's wait for its batch (host);
- ``window_from``: the state's step at the window's first step (set-up
  drives ``SETUP_STEPS`` before it), so window step ``i`` is the port's
  step ``window_from + i``;
- ``stretch`` (traced; None otherwise): the profiled stretch, ``first``
  (its first window step), ``steps``, ``k2`` and ``k3`` (launches in it);
- ``trace`` (traced; None otherwise): the stretch's device trace
  (``benchlib/trace.py:Trace``);
- ``spans`` (traced; absent otherwise): the port's tracer over the whole
  window, as ``wavenet_autoencoders_tpu_torch.utils.spans.records()``
  gives it: ``spans`` (``Span``), ``counters``, ``counts``, ``levels``,
  ``dropped``. Spans are read per window step through
  ``benchlib/span_rows.py``; host spans only before the stretch
  (``before_profiler``), since the profiler slows the host from it on.

A reference module (``reference/<name>.py``) is plain PyTorch that imports
nothing of the program, and offers

- ``precision()``: a context in which its float32 products are float32
  (TF32 off), restored after;
- ``train_steps(w0, batches, cfg, mode, block=, rows_used=, frozen=)``:
  Adam steps from weights ``w0`` ({parameter path: tensor}) over
  ``batches``, one step a batch, the loss a mean over ``rows_used`` (all
  rows by default), the batch taken ``block`` rows at a time; ``frozen``
  is a step that leaves its state unchanged. ``mode`` is ``f32``, ``f64``
  (the yardstick of float32's rounding), ``bf16`` or ``fp8`` (the control,
  one type below the configurations' bfloat16). Each batch holds ``x``
  (B, T): integer codes, or float samples for raw input; ``c`` (B,
  frames, features), the crop's frames with ``cin_pad`` frames each side;
  ``lengths`` (B,); and ``g`` (B,), the speakers, where the configuration
  has global conditioning. Returns ``losses`` (one a step),
  ``first_grad`` (the first step's gradients as Adam's state holds them),
  ``params`` and ``ema`` (the weights and the EMA shadow after the last
  step; ``ema`` None without one).
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
#: a configuration's keys that are not the model's
OUTSIDE_MODEL = ("assumed", "reference", "features")
FEATURES = ("mfcc", "mel")


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
    root: Path = HERE

    @property
    def kind(self) -> str:
        return self.generator.DRIVER

    @property
    def features(self) -> str:
        """The conditioning features the loader reads, ``mfcc`` or ``mel``."""
        feats = self.config.get("features", "mfcc")
        if feats not in FEATURES:
            raise ValueError(f"configuration {self.config_name}: features {feats!r} is not one of {FEATURES}")
        return feats

    def reference(self):
        """The configuration's plain reference module, from this cell's folder."""
        name = check_name(self.config.get("reference", "wae"))
        return load_module(self.root / "reference" / f"{name}.py", f"bench_reference_{name}")


def load_cell(name: str, root: Path = HERE) -> Cell:
    spec = _json(root / "workloads" / f"{check_name(name)}.json")
    cfg_name, traffic_name = check_name(spec["config"]), check_name(spec["traffic"])
    config = _json(root / "configs" / f"{cfg_name}.json")
    traffic = _json(root / "traffic" / f"{traffic_name}.json")
    kind = check_name(traffic["kind"])
    gen = load_module(root / "traffic" / f"{kind}.py", f"bench_traffic_{kind}")
    return Cell(name, cfg_name, config, traffic_name, traffic, gen, int(spec.get("chips", 1)), dict(spec["limits"]),
                root)


def model_config(config: dict) -> dict:
    """The configuration's model keys (without ``OUTSIDE_MODEL``'s)."""
    return {k: v for k, v in config.items() if k not in OUTSIDE_MODEL}


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
