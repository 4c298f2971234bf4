"""The train step, the dev-pass eval step and the sample-dump forward
(counterpart of ``wavenet_autoencoders_tpu/train/step.py``).

One train-step call does what the JAX package's jitted step does, in its
order: LR-schedule lookup, the commitment ramp and the time-jitter gate,
forward (EMA codebooks updated in place), masked one-step-ahead loss (mu-law
CE, or the MoL / MoG NLL of scalar input; the feature AEs' MSE on the
features) plus the bottleneck's aux loss (ramped in over
``vq_warmup_steps``), backward, global-norm clipping, the Adam update as
optax computes it, dead-code revival, and the parameter-EMA update. The
model's parameters are the live weights and are updated in place; the
optimizer moments and the EMA shadow are dicts keyed by the parameters' JAX
tree paths, which is also how checkpoints store them
(``train/checkpoint.py``).

Training noise comes from device generators seeded from ``cfg.seed`` and
the step: one stream for the bottleneck (Gumbel, VQ-dropout, time jitter;
the same on every rank), one for the reseed candidates, and one per data
rank for the decoder's dropout masks.

Data parallel (``parallel.distributed``): each data rank passes its slice
of the global batch, and the step runs under ``synced()``, so it takes the
step one process takes on the whole batch. Each rank's loss is its share
of the global loss (masked sums over the global batch's mask count, means
over the data ranks), the gradients are summed over the data group before
the norm and the clip, and the bottleneck reduces its statistics (EMA
counts and sums, code fractions, reseed candidates) over the data group
and slices its noise from the global draw.

Tensor parallel (``parallel.mesh``, after ``shard_state``): the model's
sharded leaves, their Adam moments and their EMA shadow are this rank's
shards; the ranks of a model group hold the same rows and the same
replicated loss. The grad norm sums the squares of the sharded gradients
over the model group and counts the replicated ones once; the clip, Adam
and the EMA act on the shards.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn

from wavenet_autoencoders_tpu_torch.config import Config
from wavenet_autoencoders_tpu_torch.models.mfcc_ae import CatMfccAE, MfccAE
from wavenet_autoencoders_tpu_torch.models.wae import VQWAE, CatWAE
from wavenet_autoencoders_tpu_torch.ops.losses import (
    masked_cross_entropy,
    masked_mog_loss,
    masked_mol_loss,
    sequence_mask,
)
from wavenet_autoencoders_tpu_torch.parallel import distributed as dist
from wavenet_autoencoders_tpu_torch.parallel.mesh import check_mesh, leaf_shard, model_axis, shard_module
from wavenet_autoencoders_tpu_torch.train.schedule import get_schedule
from wavenet_autoencoders_tpu_torch.utils.params import flatten_params, shard_params

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


def shard_state(cfg: Config, state: TrainState) -> TrainState:
    """Cut this rank's shards out of a full-layout TrainState in place (the
    model's parameters, the Adam moments and the EMA shadow), on the model
    axis of ``parallel.distributed.init_mesh``, which must be ``cfg``'s."""
    n = dist.model_size()
    if n != model_axis(cfg):
        raise ValueError(f"mesh_shape model={model_axis(cfg)} but the process mesh has model={n}: "
                         "call parallel.distributed.init_mesh first")
    if n > 1:
        where = (dist.data_index(), dist.model_index())
        state.mu, state.nu = shard_params(state.mu, cfg, where), shard_params(state.nu, cfg, where)
        if state.ema is not None:
            state.ema = shard_params(state.ema, cfg, where)
        shard_module(state.model, n, where[1])
    return state


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


def recon_loss(cfg: Config, y_hat, y, mask, denom=None):
    """One-step-ahead objective: predict y[t+1] from y_hat[t], masked by the
    shifted lengths (over ``denom`` mask elements when given)."""
    y_hat, y, mask = y_hat[:, :-1], y[:, 1:], mask[:, 1:]
    if cfg.is_mulaw_quantize:
        return masked_cross_entropy(y_hat, y, mask, denom)
    if cfg.output_distribution == "Logistic":
        return masked_mol_loss(y_hat, y, mask, cfg.quantize_channels, cfg.log_scale_min, denom)
    if cfg.output_distribution == "Normal":
        return masked_mog_loss(y_hat, y, mask, cfg.log_scale_min, denom)
    raise ValueError(cfg.output_distribution)


def objective(cfg: Config, model: nn.Module, y_hat, batch: dict, T: int):
    """This rank's share of the reconstruction loss of a forward's output:
    the one-step-ahead waveform loss (the masked sum over the global batch's
    mask count), or for the MFCC-only AEs the MSE on the features (over the
    ranks). Summed over the ranks it is the global batch's loss; on one
    process it is the loss."""
    ranks, _ = dist.global_rows()
    if isinstance(model, MfccAE):
        return (y_hat.float() - batch["c"]).square().mean() / ranks
    mask = sequence_mask(batch["lengths"], T)[..., None]
    denom = dist.all_sum(mask[:, 1:].sum()).clamp_min(1.0) if dist.is_synced() else None
    return recon_loss(cfg, y_hat.float(), batch["y"], mask, denom)


def _seeded(gen: torch.Generator, cfg: Config, step: int, stream: int = 0) -> torch.Generator:
    """``gen`` seeded for (seed, step, stream); stream 0 is the bottleneck's
    noise, 1 the reseed candidates, 2 + data index a data rank's dropout
    masks (the same on every rank of its model group). A resumed run
    repeats the streams."""
    return gen.manual_seed(cfg.seed * 1_000_003 + step + (stream << 40))


def make_train_step(cfg: Config, model: nn.Module):
    """``state, metrics = step_fn(state, batch)``; batch is a dict of tensors
    on the model's device: x (B, T) codes or samples, y (B, T, 1), c (B, T',
    dim_in), g (B,) when the config has global conditioning, and lengths
    (B,): the whole batch, or under a process group this rank's slice of it.
    The metrics are 0-dim tensors (reading them waits for the device), the
    same on every rank.

    ``forward_kw`` adds keyword arguments to the model's forward (the
    tests' injected noise: ``uniforms``, ``noise``, ``dropout_masks``);
    ``cand_idx`` gives the reseed candidates (K indices per slice)."""
    check_mesh(cfg, dist.world_size())
    tp = dist.model_size() > 1
    if dist.model_size() != model_axis(cfg) or tp != any(hasattr(m, "tp") for m in model.modules()):
        raise ValueError(f"mesh_shape model={model_axis(cfg)} needs init_mesh({model_axis(cfg)}) and a model "
                         "sharded by shard_state")
    op = cfg.optimizer_params
    if cfg.optimizer.lower() not in ("adam", "adamw"):
        raise ValueError(f"optimizer {cfg.optimizer!r} is not Adam")
    eps = float(op.get("eps", 1e-8))
    wd = float(op.get("weight_decay", 0.0))
    schedule = get_schedule(cfg.lr_schedule, float(op["lr"]), cfg.lr_schedule_kwargs)
    dtype = compute_dtype(cfg)
    warmup = int(cfg.vq_warmup_steps or 0)
    clip = float(cfg.clip_thresh or 0)
    leaves = flatten_params(model)
    names = list(leaves)
    vq = model if isinstance(model, VQWAE) else None
    reseed = vq is not None and vq.reseed
    jitter_start = int(cfg.time_jitter_start or 0) if vq is not None and vq.use_time_jitter else 0
    # draws of the bottleneck (Gumbel noise, VQ-dropout, time jitter)
    noisy = isinstance(model, (CatWAE, CatMfccAE)) or (
        vq is not None and (vq.use_time_jitter or (vq.vq_drop and vq.drop_dim > 0)))
    dropout = cfg.dropout > 0.0 and not isinstance(model, MfccAE)
    device = next(model.parameters()).device
    gen = torch.Generator(device=device)
    # which gradients are shards (their squares are summed over the model group)
    sharded = torch.tensor([leaf_shard(k, p.shape) is not None for k, p in leaves.items()], device=device)

    def step_fn(state: TrainState, batch: dict, *, forward_kw: dict | None = None, cand_idx=None):
        params = state.params()
        plist = [params[k] for k in names]
        for p in plist:
            p.grad = None
        x = prep_x(cfg, batch["x"])
        extra = {}
        if noisy:
            extra["generator"] = _seeded(gen, cfg, state.step)
        if jitter_start > 0:
            # the jitter gate: no jitter before time_jitter_start
            extra["jitter_scale"] = 1.0 if state.step >= jitter_start else 0.0
        if dropout:
            extra["dropout_generator"] = _seeded(torch.Generator(device=device), cfg, state.step,
                                                 2 + dist.data_index())
        extra.update(forward_kw or {})
        # commitment warm-up: the VQ aux loss is ramped in (and reported unscaled)
        ramp = min(max(state.step / warmup, 0.0), 1.0) if warmup > 0 else 1.0
        with dist.synced():
            ranks, _ = dist.global_rows()
            y_hat, aux, perp = model.forward(x, batch.get("c"), batch.get("g"), train=True, dtype=dtype, **extra)
            recon = objective(cfg, model, y_hat, batch, x.shape[1])
            aux = torch.as_tensor(aux) / ranks
            loss = recon + ramp * aux
            loss.backward()
            with torch.no_grad():
                grads = [torch.zeros_like(p) if p.grad is None else p.grad for p in plist]
                dist.all_sum_(grads)
                loss, recon, aux = (dist.all_sum(t.detach()) for t in (loss, recon, aux))

        with torch.no_grad():
            norms = torch.stack(torch._foreach_norm(grads))
            if tp:
                sq = norms.square()
                gnorm = (dist.model_sum(sq[sharded].sum()) + sq[~sharded].sum()).sqrt()
            else:
                gnorm = torch.linalg.vector_norm(norms)
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

            # dead-code revival after the update, from the forward's stash
            # (the same on every rank: global codes, one candidate stream)
            reseeded = (vq.revive(state.step, generator=_seeded(gen, cfg, state.step, 1), cand_idx=cand_idx)
                        if reseed else torch.zeros((), device=device))

            if state.ema is not None:
                # shadow -= (1 - decay) * (shadow - param)
                torch._foreach_lerp_([state.ema[k] for k in names], plist, 1.0 - cfg.ema_decay)
        state.step += 1
        metrics = {
            "loss": loss,
            "recon_loss": recon,
            "aux_loss": aux,
            "perplexity": torch.as_tensor(perp).detach(),
            "grad_norm": gnorm,
            "lr": torch.tensor(lr),
            "reseeded": reseeded,
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
    live weights, over the global batch under a process group; with an EMA shadow, ``recon_loss_ema`` comes from the
    shadow, run through ``torch.func.functional_call`` (the live weights are
    not touched). The metrics are 0-dim tensors."""
    dtype = compute_dtype(cfg)

    @torch.no_grad()
    def eval_fn(state: TrainState, batch: dict) -> dict:
        x = prep_x(cfg, batch["x"])
        args = (x, batch.get("c"), batch.get("g"))
        kw = {"train": False, "dtype": dtype}
        with dist.synced():
            ranks, _ = dist.global_rows()
            y_hat, aux, perp = model(*args, **kw)
            recon = dist.all_sum(objective(cfg, model, y_hat, batch, x.shape[1]))
            aux = dist.all_sum(torch.as_tensor(aux) / ranks)
            out = {"loss": recon + aux, "recon_loss": recon, "aux_loss": aux, "perplexity": torch.as_tensor(perp)}
            if state.ema is not None:
                # the shadow's JAX tree paths back to module names (flatten_params' inverse)
                shadow = {k.replace("/", "."): v for k, v in state.ema.items()}
                y_hat_e, _, _ = torch.func.functional_call(model, shadow, args, kw)
                out["recon_loss_ema"] = dist.all_sum(objective(cfg, model, y_hat_e, batch, x.shape[1]))
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
