"""The train step, the dev-pass eval step and the sample-dump forward
(counterpart of ``wavenet_autoencoders_tpu/train/step.py``).

One train-step call does what the JAX package's jitted step does: LR-schedule lookup,
forward, masked one-step-ahead loss (mu-law CE, or the MoL / MoG NLL of
scalar input; the feature AEs' MSE on the features) plus the bottleneck's
aux loss (ramped in over ``vq_warmup_steps``), backward, global-norm
clipping, the Adam update as optax computes it, and the parameter-EMA
update. The model's parameters are
the live weights and are updated in place; the optimizer moments and the
EMA shadow are dicts keyed by the parameters' JAX tree paths, which is also
how checkpoints store them (``train/checkpoint.py``). Stochastic
bottlenecks (Gumbel) draw their noise from a device generator seeded from
``cfg.seed`` and the step.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn

from wavenet_autoencoders_tpu_torch.config import Config
from wavenet_autoencoders_tpu_torch.models.mfcc_ae import CatMfccAE, MfccAE
from wavenet_autoencoders_tpu_torch.models.wae import CatWAE
from wavenet_autoencoders_tpu_torch.ops.losses import (
    masked_cross_entropy,
    masked_mog_loss,
    masked_mol_loss,
    sequence_mask,
)
from wavenet_autoencoders_tpu_torch.train.schedule import get_schedule
from wavenet_autoencoders_tpu_torch.utils.params import flatten_params

ADAM_B1, ADAM_B2 = 0.9, 0.999


@dataclass
class TrainState:
    """Live weights (``model``), Adam state (``count`` updates, moments
    ``mu``/``nu``, the last injected ``lr``), the parameter-EMA shadow
    (None when the config has no EMA) and the step counter."""

    model: nn.Module
    mu: dict
    nu: dict
    count: int
    lr: float
    ema: dict | None
    step: int

    def params(self) -> dict:
        return flatten_params(self.model)


def init_state(cfg: Config, model: nn.Module) -> TrainState:
    params = flatten_params(model)
    with torch.no_grad():
        zeros = lambda: {k: torch.zeros_like(p) for k, p in params.items()}  # noqa: E731
        ema = {k: p.detach().clone() for k, p in params.items()} if cfg.exponential_moving_average else None
    return TrainState(model=model, mu=zeros(), nu=zeros(), count=0,
                      lr=float(cfg.optimizer_params["lr"]), ema=ema, step=0)


def compute_dtype(cfg: Config):
    return torch.bfloat16 if cfg.compute_dtype == "bfloat16" else None


def prep_x(cfg: Config, x: torch.Tensor) -> torch.Tensor:
    """Integer mu-law codes (B, T) go straight to the first 1x1's row
    gather; scalar waveforms become (B, T, 1)."""
    if x.ndim == 3:
        return x
    if cfg.is_mulaw_quantize:
        return x.long()
    return x[..., None].float()


def recon_loss(cfg: Config, y_hat, y, mask):
    """One-step-ahead objective: predict y[t+1] from y_hat[t], masked by the
    shifted lengths."""
    y_hat, y, mask = y_hat[:, :-1], y[:, 1:], mask[:, 1:]
    if cfg.is_mulaw_quantize:
        return masked_cross_entropy(y_hat, y, mask)
    if cfg.output_distribution == "Logistic":
        return masked_mol_loss(y_hat, y, mask, cfg.quantize_channels, cfg.log_scale_min)
    if cfg.output_distribution == "Normal":
        return masked_mog_loss(y_hat, y, mask, cfg.log_scale_min)
    raise ValueError(cfg.output_distribution)


def check_ported(cfg: Config) -> None:
    """Raise ``NotImplementedError``, naming its ROADMAP item, for a training
    option of ``cfg`` that the port does not carry yet, instead of training
    something else. (EMA codebooks fail in the model's constructor
    already.)"""
    vq_item = "EMA codebooks, reseed, time jitter and VQ-dropout"
    for on, what, item in (
        (cfg.time_jitter, "time jitter", vq_item),
        (cfg.vq_drop and cfg.drop_dim > 0, "VQ-dropout", vq_item),
        (cfg.vq_reseed, "dead-code reseed", vq_item),
        (cfg.dropout > 0.0, "dropout in the residual GLU block", "dropout"),
    ):
        if on:
            raise NotImplementedError(f"{what} is not ported yet: see ROADMAP.md, queue 1 ({item})")


def objective(cfg: Config, model: nn.Module, y_hat, batch: dict, T: int):
    """The reconstruction loss of a forward's output: the one-step-ahead
    waveform loss, or for the MFCC-only AEs the MSE on the features."""
    if isinstance(model, MfccAE):
        return (y_hat.float() - batch["c"]).square().mean()
    mask = sequence_mask(batch["lengths"], T)[..., None]
    return recon_loss(cfg, y_hat.float(), batch["y"], mask)


def make_train_step(cfg: Config, model: nn.Module):
    """``state, metrics = step_fn(state, batch)``; batch is a dict of tensors
    on the model's device: x (B, T) codes or samples, y (B, T, 1), c (B, T',
    dim_in), g (B,) when the config has global conditioning, and lengths
    (B,). The metrics are 0-dim tensors (reading them waits for the
    device)."""
    check_ported(cfg)
    op = cfg.optimizer_params
    if cfg.optimizer.lower() not in ("adam", "adamw"):
        raise ValueError(f"optimizer {cfg.optimizer!r} is not Adam")
    eps = float(op.get("eps", 1e-8))
    wd = float(op.get("weight_decay", 0.0))
    schedule = get_schedule(cfg.lr_schedule, float(op["lr"]), cfg.lr_schedule_kwargs)
    dtype = compute_dtype(cfg)
    warmup = int(cfg.vq_warmup_steps or 0)
    clip = float(cfg.clip_thresh or 0)
    names = list(flatten_params(model))
    stochastic = isinstance(model, (CatWAE, CatMfccAE))  # Gumbel noise
    gen = torch.Generator(device=next(model.parameters()).device) if stochastic else None

    def step_fn(state: TrainState, batch: dict):
        params = state.params()
        plist = [params[k] for k in names]
        for p in plist:
            p.grad = None
        x = prep_x(cfg, batch["x"])
        extra = {}
        if stochastic:  # one noise stream per (seed, step), so a resumed run repeats it
            extra["generator"] = gen.manual_seed(cfg.seed * 1_000_003 + state.step)
        y_hat, aux, perp = model.forward(x, batch.get("c"), batch.get("g"), train=True, dtype=dtype, **extra)
        recon = objective(cfg, model, y_hat, batch, x.shape[1])
        # commitment warm-up: the VQ aux loss is ramped in (and reported unscaled)
        ramp = min(max(state.step / warmup, 0.0), 1.0) if warmup > 0 else 1.0
        loss = recon + ramp * aux
        loss.backward()

        with torch.no_grad():
            grads = [torch.zeros_like(p) if p.grad is None else p.grad for p in plist]
            gnorm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
            if clip > 0:
                # the JAX formula, not clip_grad_norm_'s clip / (norm + 1e-6)
                scale = torch.clamp(clip / torch.clamp(gnorm, min=1e-6), max=1.0)
                grads = torch._foreach_mul(grads, scale)

            # Adam as optax computes it, with the LR of this step (before the increment)
            lr = schedule(state.step)
            state.count += 1
            mu = [state.mu[k] for k in names]
            nu = [state.nu[k] for k in names]
            torch._foreach_mul_(mu, ADAM_B1)
            torch._foreach_add_(mu, grads, alpha=1.0 - ADAM_B1)
            torch._foreach_mul_(nu, ADAM_B2)
            torch._foreach_addcmul_(nu, grads, grads, value=1.0 - ADAM_B2)
            mu_hat = torch._foreach_div(mu, 1.0 - ADAM_B1 ** state.count)
            den = torch._foreach_sqrt(torch._foreach_div(nu, 1.0 - ADAM_B2 ** state.count))
            torch._foreach_add_(den, eps)
            upd = torch._foreach_div(mu_hat, den)
            if wd > 0.0:  # adamw: decoupled decay, before the LR scale
                torch._foreach_add_(upd, plist, alpha=wd)
            torch._foreach_add_(plist, upd, alpha=-lr)
            state.lr = lr

            if state.ema is not None:
                # shadow -= (1 - decay) * (shadow - param)
                torch._foreach_lerp_([state.ema[k] for k in names], plist, 1.0 - cfg.ema_decay)
        state.step += 1
        metrics = {
            "loss": loss.detach(),
            "recon_loss": recon.detach(),
            "aux_loss": torch.as_tensor(aux).detach(),
            "perplexity": torch.as_tensor(perp).detach(),
            "grad_norm": gnorm,
            "lr": torch.tensor(lr),
            "reseeded": torch.tensor(0.0),
        }
        return state, metrics

    return step_fn


def ema_warm_steps(ema_decay: float) -> int:
    """Steps before the EMA shadow is a faithful parameter average: ~5 time
    constants (decay**step < 1%)."""
    import math

    if ema_decay >= 1.0:
        return 1 << 30
    return int(math.ceil(5.0 / (1.0 - ema_decay)))


def make_eval_step(cfg: Config, model: nn.Module):
    """``metrics = eval_fn(state, batch)``: forward-only metrics on a dev
    batch, ``train=False`` under ``no_grad`` (the dev phase of
    ``wavenet_autoencoders_tpu/train/step.py:make_eval_step``).

    ``loss``, ``recon_loss``, ``aux_loss`` and ``perplexity`` come from the
    live weights; with an EMA shadow, ``recon_loss_ema`` comes from the
    shadow, run through ``torch.func.functional_call`` (the live weights are
    not touched). The metrics are 0-dim tensors."""
    dtype = compute_dtype(cfg)

    @torch.no_grad()
    def eval_fn(state: TrainState, batch: dict) -> dict:
        x = prep_x(cfg, batch["x"])
        args = (x, batch.get("c"), batch.get("g"))
        kw = {"train": False, "dtype": dtype}
        y_hat, aux, perp = model(*args, **kw)
        recon = objective(cfg, model, y_hat, batch, x.shape[1])
        aux = torch.as_tensor(aux)
        out = {"loss": recon + aux, "recon_loss": recon, "aux_loss": aux, "perplexity": torch.as_tensor(perp)}
        if state.ema is not None:
            # the shadow's JAX tree paths back to module names (flatten_params' inverse)
            shadow = {k.replace("/", "."): v for k, v in state.ema.items()}
            y_hat_e, _, _ = torch.func.functional_call(model, shadow, args, kw)
            out["recon_loss_ema"] = objective(cfg, model, y_hat_e, batch, x.shape[1])
        return out

    return eval_fn


def make_sample_forward(cfg: Config, model: nn.Module):
    """``y_hat = fwd(x, c, g)``: the teacher-forced forward of the model's
    current weights (``train=False``, under ``no_grad``) for the periodic
    ``save_states`` sample dump; the training loop lends it the EMA shadow
    through ``_hook_params``."""
    dtype = compute_dtype(cfg)

    @torch.no_grad()
    def fwd(x, c, g):
        return model(prep_x(cfg, x), c, g, train=False, dtype=dtype)[0]

    return fwd
