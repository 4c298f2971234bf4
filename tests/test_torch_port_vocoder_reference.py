"""The port's raw-audio WaveNet vocoder (``vocoder_raw``: scalar input, a
10-component discretized mixture of logistics over 65,536 levels, mel
conditioning through ``ConvInUpsampleNetwork`` with cin_pad 2, no speakers)
held on the CPU against the benchmark's plain reference of it,
``benchmarks/reference/vocoder.py``, loaded by path as the benchmark loads
it: three Adam steps of the port's train step (fused and unfused stack)
from the benchmark's seeded weights (``benchmarks/benchlib/weights.py``) at
4 layers, 16 residual and skip channels, 32 gate channels, B = 2 × 1,024,
float32; and the MoL loss alone, in float64 at 65,536 levels and in
float32 at 256. A planted fault in the port's MoL fails the comparison.

The tolerances, and why:

- At 65,536 levels a bin's probability is the difference of two sigmoids
  3e-5 / scale apart, so its float32 gradient keeps some three decimal
  digits fewer than float32 holds: the float32 reference's own first
  gradient lies 7e-5 of the largest gradient from the float64 one. The
  port's first gradient is held to the float64 reference within 1e-3 of
  that largest gradient (it lies within 6e-5).
- Adam moves each element about lr a step whatever its gradient's size,
  so an element whose float32 gradient is mostly rounding moves either
  way: after three steps the float32 reference's parameters lie up to
  2e-3 from the float64 reference's. So the change over three steps is
  compared per leaf, as the norm of its gap over the norm of the float64
  change, on the elements whose first float64 gradient is a hundred times
  its float32 rounding or more (about 98 % of them), within 0.05 (the
  port: 0.008; the float32 reference itself: 0.009); the step-1 loss
  within 1e-5 (float32 sums over ~2,000 positions; it lies within 2e-6)
  and the losses of steps 2 and 3, after those moves, within 1e-4 (within
  1e-5).
- The EMA shadow moves by 1e-4 of the parameters' change, about 3e-7 over
  three steps, within a few float32 units of its values (up to ~4): it is
  held within 2e-6 (it lies within 6e-7), which checks its update rule,
  not its change.
- The MoL loss alone: the same operations in float64 (0/1 masks in the
  reference where the port selects with ``torch.where``; both pick the
  same values), within 1e-12 of each other; in float32 at 256 levels,
  within 1e-5 in absolute terms on NLLs of 1 to 10.
"""
import dataclasses
import importlib.util
import math
from pathlib import Path

import numpy as np
import pytest
import torch

from wavenet_autoencoders_tpu_torch.config import load_preset
from wavenet_autoencoders_tpu_torch.models import build_model
from wavenet_autoencoders_tpu_torch.ops import losses as port_losses
from wavenet_autoencoders_tpu_torch.ops.mixture import discretized_mix_logistic_loss
from wavenet_autoencoders_tpu_torch.train.step import init_state, make_train_step
from wavenet_autoencoders_tpu_torch.utils.params import flatten_params

BENCH = Path(__file__).resolve().parent.parent / "benchmarks"
TINY = ("layers=4,stacks=2,residual_channels=16,gate_channels=32,skip_out_channels=16,batch_size=2,"
        "max_time_steps=1024,compute_dtype=float32")
B, T, SEED = 2, 1024, 2**31 + 7
ADAM_B1 = 0.9


def _load(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


REF = _load(BENCH / "reference" / "vocoder.py", "bench_reference_vocoder_under_test")
WEIGHTS = _load(BENCH / "benchlib" / "weights.py", "bench_weights_under_test")


def _feed(seed: int) -> dict:
    """Samples in [-1, 1] with some at the edges (the one-sided edge bins),
    mel frames in [0, 1] with cin_pad 2 frames each side, one row shorter."""
    g = torch.Generator().manual_seed(seed)
    x = (0.4 * torch.randn(B, T, generator=g)).clamp(-1.0, 1.0)
    x[:, ::97] = 1.0
    x[:, 50::101] = -1.0
    return {"x": x, "c": torch.rand(B, T // 256 + 4, 80, generator=g),
            "lengths": torch.tensor([T, 900], dtype=torch.int32)}


def _model(fused: bool):
    """(cfg, the port's model holding the seeded weights, the weights)."""
    cfg = load_preset("vocoder_raw", TINY + f",fused_stack={str(fused).lower()}")
    model = build_model(cfg, device="cpu").train()
    params = flatten_params(model)
    w0 = WEIGHTS.draw({k: tuple(p.shape) for k, p in params.items()}, SEED, "cpu")
    with torch.no_grad():
        for k, p in params.items():
            p.copy_(w0[k])
    return cfg, model, w0


def _port_steps(fused: bool, batches: list[dict]):
    """The port's train steps over ``batches`` from the seeded weights: (w0,
    the program's losses, first gradient, parameters and EMA after the
    last)."""
    cfg, model, w0 = _model(fused)
    state, step = init_state(cfg, model), make_train_step(cfg, model)
    losses, first_grad = [], None
    for b in batches:
        state, m = step(state, {**b, "y": b["x"][..., None]})
        losses.append(float(m["loss"]))
        if first_grad is None:
            first_grad = {k: state.mu[k] / (1.0 - ADAM_B1) for k in state.mu}
    prog = {"losses": losses, "first_grad": first_grad,
            "params": {k: p.detach().clone() for k, p in flatten_params(model).items()},
            "ema": {k: v.clone() for k, v in state.ema.items()}}
    return w0, prog


@pytest.fixture(scope="module")
def reference():
    """(batches, the float32 and float64 references' three steps) at the
    configuration the port's tests run."""
    cfg, _, w0 = _model(False)
    cfg = dataclasses.asdict(cfg)
    batches = [_feed(i) for i in range(3)]
    with REF.precision():
        return batches, REF.train_steps(w0, batches, cfg, "f32"), REF.train_steps(w0, batches, cfg, "f64")


def step_gaps(prog: dict, r32: dict, r64: dict, w0: dict) -> dict:
    """The numbers the tolerances hold, each over its limit (1 is the
    limit): losses, the first gradient, the change over the steps per leaf
    on the elements whose gradient is well above its rounding, the EMA."""
    gmax = max(float(g.abs().max()) for g in r64["first_grad"].values())
    out = {"loss_step1": abs(prog["losses"][0] - r64["losses"][0]) / abs(r64["losses"][0]) / 1e-5,
           "loss_later": max(abs(a - b) / abs(b) for a, b in zip(prog["losses"][1:], r64["losses"][1:])) / 1e-4,
           "first_grad": max(float((prog["first_grad"][k].double() - g).abs().max())
                             for k, g in r64["first_grad"].items()) / gmax / 1e-3,
           "ema": max(float((prog["ema"][k].double() - e).abs().max()) for k, e in r64["ema"].items()) / 2e-6}
    change = 0.0
    for k, g64 in r64["first_grad"].items():
        live = g64.abs() > 100 * (r32["first_grad"][k].double() - g64).abs()
        if live.any():
            want = (r64["params"][k] - w0[k].double())[live]
            got = (prog["params"][k].double() - w0[k].double())[live]
            change = max(change, float((got - want).norm() / want.norm()))
    out["change"] = change / 0.05
    return out


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
def test_three_adam_steps_match_the_reference(reference, fused):
    batches, r32, r64 = reference
    w0, prog = _port_steps(fused, batches)
    gaps = step_gaps(prog, r32, r64, w0)
    assert max(gaps.values()) <= 1.0, gaps
    # the float32 reference itself keeps well inside the same limits
    assert max(step_gaps(r32, r32, r64, w0).values()) <= 0.5


def test_a_mixture_with_half_its_logits_zeroed_fails_the_step_comparison(reference, monkeypatch):
    batches, r32, r64 = reference

    def planted(y_hat, y, **kw):
        return discretized_mix_logistic_loss(torch.cat([y_hat[..., :5], torch.zeros_like(y_hat[..., 5:10]),
                                                        y_hat[..., 10:]], -1), y, **kw)

    monkeypatch.setattr(port_losses, "discretized_mix_logistic_loss", planted)
    w0, prog = _port_steps(True, batches)
    assert max(step_gaps(prog, r32, r64, w0).values()) > 1.0


def _mixture(dtype, seed=3):
    """MoL parameters (2, 512, 30) and targets (2, 512) in [-1, 1]: the
    means near the targets for a third of the components, log scales over
    [-20, 1] (below the clamp at -16 too), the targets at the edges here and
    there."""
    g = torch.Generator().manual_seed(seed)
    y = torch.rand(2, 512, generator=g, dtype=torch.float64) * 2 - 1
    y[:, ::61] = 1.0
    y[:, 7::53] = -1.0
    logits = torch.randn(2, 512, 10, generator=g, dtype=torch.float64)
    means = torch.rand(2, 512, 10, generator=g, dtype=torch.float64) * 2 - 1
    means[..., :3] = y[..., None] + 1e-3 * torch.randn(2, 512, 3, generator=g, dtype=torch.float64)
    log_scales = torch.rand(2, 512, 10, generator=g, dtype=torch.float64) * 21 - 20
    return torch.cat([logits, means, log_scales], -1).to(dtype), y.to(dtype)


def _both(y_hat, y, levels, port_log_scale_min=-16.0, plant=None):
    """(port NLL, reference NLL, port gradient, reference gradient)."""
    a = y_hat.clone().requires_grad_(True)
    b = y_hat.clone().requires_grad_(True)
    yp = a if plant is None else plant(a)
    port = discretized_mix_logistic_loss(yp, y[..., None], num_classes=levels, log_scale_min=port_log_scale_min,
                                         reduce=False)[..., 0]
    ref = REF.mol_nll(b, y, levels, -16.0)
    ga, = torch.autograd.grad(port.sum(), a)
    gb, = torch.autograd.grad(ref.sum(), b)
    return port.detach(), ref.detach(), ga, gb


def test_the_mixture_loss_at_65536_levels_in_float64():
    y_hat, y = _mixture(torch.float64)
    port, ref, gp, gr = _both(y_hat, y, 65536)
    assert bool((y_hat[..., 20:] < -16).any()) and bool((y.abs() == 1).any())
    np.testing.assert_allclose(port.numpy(), ref.numpy(), rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(gp.numpy(), gr.numpy(), rtol=1e-12, atol=1e-12)


def test_the_mixture_loss_at_256_levels_in_float32():
    y_hat, y = _mixture(torch.float32, seed=4)
    port, ref, gp, gr = _both(y_hat, y, 256)
    assert 1.0 < float(ref.median()) < 10.0
    np.testing.assert_allclose(port.numpy(), ref.numpy(), rtol=0, atol=1e-5)
    np.testing.assert_allclose(gp.numpy(), gr.numpy(), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("fault", ["half_the_logits_zeroed", "log_scale_unclamped"])
def test_a_planted_mixture_fault_fails_the_loss_comparison(fault):
    y_hat, y = _mixture(torch.float64)
    if fault == "half_the_logits_zeroed":
        port, ref, _, _ = _both(y_hat, y, 65536, plant=lambda t: torch.cat(
            [t[..., :5], torch.zeros_like(t[..., 5:10]), t[..., 10:]], -1))
    else:
        port, ref, _, _ = _both(y_hat, y, 65536, port_log_scale_min=-math.inf)
    assert not np.allclose(port.numpy(), ref.numpy(), rtol=1e-12, atol=1e-12)
