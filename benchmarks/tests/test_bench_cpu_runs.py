"""Whole runs of tiny cells on the CPU (the look for a card skipped), with
the timed path sound and broken underneath: a sound run comes out correct,
and each planted fault that a cell can have comes out not correct under
the real cell's limits; the control (the reference in float8) fails them
too. The port runs on the CPU with its plain kernels."""
import pytest
import torch

import run
from reference import wae as ref
import bench_tiny as tiny

SEED = 2**31 + 11


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.make(tmp_path_factory.mktemp("bench") / "benchmarks")


def unchanged(step_fn):
    from wavenet_autoencoders_tpu_torch.train.graph import state_tensors

    def step(state, batch):
        keep = {k: t.detach().clone() for k, t in state_tensors(state).items()}
        state, m = step_fn(state, batch)
        with torch.no_grad():
            for k, t in state_tensors(state).items():
                t.copy_(keep[k])
        return state, m

    return step


def half_batch(step_fn):
    return lambda state, batch: step_fn(state, {k: v[: v.shape[0] // 2] for k, v in batch.items()})


def one_leaf_unchanged(step_fn, leaf="wavenet/post2/b"):
    """A step that updates every leaf but one, which keeps its value."""
    from wavenet_autoencoders_tpu_torch.utils.params import flatten_params

    def step(state, batch):
        p = flatten_params(state.model)[leaf]
        keep = p.detach().clone()
        state, m = step_fn(state, batch)
        with torch.no_grad():
            p.copy_(keep)
        return state, m

    return step


def line(root, cell, hooks=None, trace=False):
    return run.run_cell(cell, SEED, 0.5, trace, device="cpu", hooks=hooks, root=root)


@pytest.mark.parametrize("cell", ["tiny-train", "tiny-in-train"])
def test_a_sound_train_run(root, cell):
    out = line(root, cell)
    assert out["correct"], out["checks"]
    assert list(out) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert set(out["metrics"]) == {"train_samples_per_s", "train_step_ms_p95", "setup_s"}
    assert out["attempted"] >= 1 and out["failed"] == 0


@pytest.mark.parametrize("fault", [unchanged, half_batch, one_leaf_unchanged],
                         ids=["state_unchanged", "half_batch", "one_leaf_unchanged"])
def test_a_broken_train_step_is_not_correct(root, fault):
    out = line(root, "tiny-train", {"step": fault})
    assert not out["correct"], out["checks"]


def _tiny_cfg(root, name):
    import json

    return json.loads((root / "configs" / f"tiny_{name}.json").read_text())


def test_the_control_fails_the_train_limits(root):
    from benchlib import checks
    from benchlib.weights import draw

    cfg = {k: v for k, v in _tiny_cfg(root, "svqwae").items() if k != "assumed"}
    from wavenet_autoencoders_tpu_torch.config import Config
    from wavenet_autoencoders_tpu_torch.models.zoo import build_model
    from wavenet_autoencoders_tpu_torch.utils.params import flatten_params

    model = build_model(Config().override(cfg), device="cpu")
    w0 = draw({k: tuple(p.shape) for k, p in flatten_params(model).items()}, SEED, "cpu")
    g = torch.Generator().manual_seed(0)
    B, T = 4, 1280
    feed = [{"x": torch.randint(0, 256, (B, T), generator=g, dtype=torch.int32),
             "c": torch.randn(B, T // 160, 39, generator=g), "g": torch.randint(0, 5, (B,), generator=g),
             "lengths": torch.full((B,), T, dtype=torch.int32)} for _ in range(3)]
    f32 = ref.train_steps(w0, feed, cfg, "f32")
    grad64 = ref.train_steps(w0, feed[:1], cfg, "f64")["first_grad"]
    low = ref.train_steps(w0, feed, cfg, "fp8")
    ok, shown = checks.judge({**checks.train_numbers(low, f32, w0, grad64), "nonfinite": 0.0},
                             tiny.limits("svqwae-train"))
    assert not ok, shown


def test_the_change_leaves_out_the_gradients_that_are_nought_to_rounding():
    from benchlib import checks

    f64 = torch.float64
    g64 = {"a": torch.tensor([1.0, 0.0, 1e-12, -2.0], dtype=f64), "b": torch.zeros(3, dtype=f64),
           "c": torch.zeros(2, dtype=f64)}
    g32 = {"a": torch.tensor([1.0 + 1e-7, 1e-9, 1e-9, -2.0]), "b": torch.tensor([1e-9, 1e-9, -1e-9]),
           "c": torch.zeros(2)}
    keep = checks.counted(g32, g64)
    assert sorted(keep) == ["a", "c"] and keep["a"].tolist() == [True, False, False, True] and keep["c"].all()
    w0 = {"a": torch.zeros(4), "b": torch.zeros(3), "c": torch.zeros(2)}
    moved = {"a": torch.tensor([1.0, 5.0, 5.0, 1.0]), "b": torch.ones(3), "c": torch.zeros(2)}
    sound = {"losses": [1.0], "first_grad": g32, "params": moved, "ema": None}
    off = {**sound, "params": {**moved, "a": torch.tensor([1.0, -3.0, 7.0, 1.0]), "b": torch.full((3,), 9.0)}}
    # what moves only where the gradient is rounding is not compared
    assert checks.train_numbers(off, sound, w0, g64)["change_worst"] == 0.0
    twice = {**sound, "params": {**moved, "a": torch.tensor([2.0, 5.0, 5.0, 2.0])}}
    assert checks.train_numbers(twice, sound, w0, g64)["change_worst"] == pytest.approx(1.0)
    # what neither side's gradient moves must stay where it was
    stray = {**sound, "params": {**moved, "c": torch.ones(2)}}
    assert checks.train_numbers(stray, sound, w0, g64)["change_worst"] > 0.5
