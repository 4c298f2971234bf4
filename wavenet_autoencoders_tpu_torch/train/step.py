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

The step is a host part and a body. The host part computes what changes
from step to step from the state's step and count (the lr, Adam's bias
corrections, the ramp, the jitter gate, revival's switch, the reseed
candidates' words) as the JAX step does, and writes it into static device
tensors (``StepInputs``); the body reads device tensors alone, so on the
card it runs as a CUDA graph (``train/graph.py``), the counterpart of the
JAX step's ``jax.jit``, and the eager step on the card runs the same body.
Each call is a ``step`` span of the tracer (``utils.spans``), its wait for
the last step-input copy a ``step.inputs_wait``.

Every draw is the JAX step's (``utils.jax_random``): the step's key is
``fold_in(PRNGKey(cfg.seed + 1), step)``, folded on the device from the
device step, and the model's forward splits it as its JAX ``forward`` does (the bottleneck's
Gumbel noise, VQ-dropout and time jitter, then the decoder's dropout
masks); the reseed candidates are ``randint`` under
``fold_in(fold_in(step key, 0x5EED), slice)`` over the global batch's
latent frames (``ReseedDraws``).

Data parallel (``parallel.distributed``): each data rank passes its slice
of the global batch, and the step runs under ``synced()``, so it takes the
step one process takes on the whole batch. Each rank's loss is its share
of the global loss (masked sums over the global batch's mask count, means
over the data ranks), the gradients are summed over the data group before
the norm and the clip, and the bottleneck reduces its statistics (EMA
counts and sums, code fractions, reseed candidates) over the data group
and draws its noise as this rank's rows of the global batch's draw; the
ranks of a model group draw the same noise.

Tensor parallel (``parallel.mesh``, after ``shard_state``): the model's
sharded leaves, their Adam moments and their EMA shadow are this rank's
shards; the ranks of a model group hold the same rows and the same
replicated loss. The grad norm sums the squares of the sharded gradients
over the model group and counts the replicated ones once; the clip, Adam
and the EMA act on the shards.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
from torch import nn

from wavenet_autoencoders_tpu_torch.config import Config
from wavenet_autoencoders_tpu_torch.models.mfcc_ae import MfccAE
from wavenet_autoencoders_tpu_torch.models.wae import VQWAE
from wavenet_autoencoders_tpu_torch.ops.losses import (
    masked_cross_entropy,
    masked_mog_loss,
    masked_mol_loss,
    sequence_mask,
)
from wavenet_autoencoders_tpu_torch.parallel import distributed as dist
from wavenet_autoencoders_tpu_torch.parallel.mesh import check_mesh, leaf_shard, model_axis, shard_module
from wavenet_autoencoders_tpu_torch.train.graph import GraphedStep
from wavenet_autoencoders_tpu_torch.train.schedule import get_schedule
from wavenet_autoencoders_tpu_torch.utils import jax_random as jr
from wavenet_autoencoders_tpu_torch.utils import spans
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


RESEED_SPAN = 256


class ReseedDraws:
    """The JAX step's reseed candidates: slice i's at ``step`` are
    ``randint(fold_in(fold_in(fold_in(PRNGKey(cfg.seed + 1), step), 0x5EED),
    i), (K_i,), 0, n)`` into the global batch's n latent frames. randint's
    two draws of words do not depend on n, so they are drawn on ``device``
    for ``span`` steps at a time (one draw for 256 steps costs the launches
    of one) and mapped into [0, n) where n is known: ``draws(step)(i, n)``
    are the candidates, ``draws.words(step)`` the words."""

    def __init__(self, cfg: Config, sizes: list[int], device, span: int = RESEED_SPAN):
        self.base, self.sizes, self.span = jr.PRNGKey(cfg.seed + 1, device), list(sizes), span
        self.first, self.table = None, []

    def words(self, step: int) -> list[torch.Tensor]:
        """Per slice the (2, K_i) words of ``step``: randint's higher and
        lower draws."""
        first = step - step % self.span
        if first != self.first:
            steps = torch.arange(first, first + self.span, device=self.base.device)
            keys = jr.fold_in(jr.fold_in(self.base, steps), 0x5EED)
            self.table = []
            for j, K in enumerate(self.sizes):
                two = jr.split(jr.fold_in(keys, j))
                self.table.append(torch.stack([jr.random_bits(two[:, 0], (K,)), jr.random_bits(two[:, 1], (K,))], 1))
            self.first = first
        return [t[step - first] for t in self.table]

    @staticmethod
    def candidates(words: list[torch.Tensor]):
        """``candidates(i, n)``: slice i's words mapped into [0, n)."""
        return lambda i, n: jr.randint_of_bits(words[i][0], words[i][1], 0, n)

    def __call__(self, step: int):
        return self.candidates(self.words(step))


class StepInputs:
    """What changes from step to step, as static tensors on the model's
    device that the body reads: the step (int64, folded into the step's
    key), revival's switch (int64 0/1), the lr, Adam's two bias corrections,
    the commitment ramp and the jitter gate (f32), and per codebook slice
    the (2, K_i) words of the reseed candidates. ``write`` fills them from
    the host's values; on the card through a pinned buffer, copied to the
    device once a step."""

    def __init__(self, device, sizes=()):
        self.dev = torch.zeros(5, dtype=torch.int64, device=device)
        cuda = self.dev.device.type == "cuda"
        self.host = torch.zeros(5, dtype=torch.int64, pin_memory=True) if cuda else self.dev
        self.copied = torch.cuda.Event() if cuda else None
        self.step, self.active = self.dev[0], self.dev[1]
        self.lr, self.bc1, self.bc2, self.ramp, self.gate, _ = self.dev[2:].view(torch.float32)
        self.words = [torch.zeros(2, K, dtype=torch.int64, device=device) for K in sizes]

    def write(self, step: int, active: bool, lr: float, bc1: float, bc2: float, ramp: float, gate: float,
              words=None) -> None:
        if self.copied is not None:
            with spans.span("step.inputs_wait"):
                self.copied.synchronize()  # the last copy has read the pinned buffer
        host = self.host.numpy()
        host[0], host[1] = step, int(active)
        host[2:].view(np.float32)[:5] = (lr, bc1, bc2, ramp, gate)  # each rounded once to f32
        if self.copied is not None:
            self.dev.copy_(self.host, non_blocking=True)
            self.copied.record(torch.cuda.current_stream(self.dev.device))
        for w, t in zip(self.words, words or ()):
            w.copy_(t)


class TrainStep:
    """The train step (see :func:`make_train_step`): a host part that
    computes the step's values from ``state`` and writes them into
    :class:`StepInputs`, and a body that reads device tensors alone, run
    eagerly or replayed as a CUDA graph (``train.graph.GraphedStep``)."""

    def __init__(self, cfg: Config, model: nn.Module, graph: bool | None = None):
        check_mesh(cfg, dist.world_size())
        self.tp = dist.model_size() > 1
        if dist.model_size() != model_axis(cfg) or self.tp != any(hasattr(m, "tp") for m in model.modules()):
            raise ValueError(f"mesh_shape model={model_axis(cfg)} needs init_mesh({model_axis(cfg)}) and a model "
                             "sharded by shard_state")
        op = cfg.optimizer_params
        if cfg.optimizer.lower() not in ("adam", "adamw"):
            raise ValueError(f"optimizer {cfg.optimizer!r} is not Adam")
        self.cfg, self.model = cfg, model
        self.eps = float(op.get("eps", 1e-8))
        self.wd = float(op.get("weight_decay", 0.0))
        self.schedule = get_schedule(cfg.lr_schedule, float(op["lr"]), cfg.lr_schedule_kwargs)
        self.dtype = compute_dtype(cfg)
        self.warmup = int(cfg.vq_warmup_steps or 0)
        self.clip = float(cfg.clip_thresh or 0)
        leaves = flatten_params(model)
        self.names = list(leaves)
        self.vq = model if isinstance(model, VQWAE) else None
        self.reseed = self.vq is not None and self.vq.reseed
        self.jitter_start = int(cfg.time_jitter_start or 0) if self.vq is not None and self.vq.use_time_jitter else 0
        self.device = next(model.parameters()).device
        self.base = jr.PRNGKey(cfg.seed + 1, self.device)
        sizes = self.vq._codebook_sizes() if self.reseed else []
        self.draws = ReseedDraws(cfg, sizes, self.device) if self.reseed else None
        self.inputs = StepInputs(self.device, sizes)
        # which gradients are shards (their squares are summed over the model group)
        self.sharded = torch.tensor([leaf_shard(k, p.shape) is not None for k, p in leaves.items()],
                                    device=self.device)
        # a graph on one card for a process alone: gloo collectives cannot be
        # captured, and NCCL's need more than the one card
        grouped = torch.distributed.is_initialized()
        if self.device.type != "cuda":
            self.eager = "the model is on the CPU"
        elif grouped:
            self.eager = f"process group of {dist.world_size()}"
        else:
            self.eager = None if graph is not False else "graph=False"
        if graph and self.eager is not None:
            raise ValueError(f"a graphed train step needs the model on cuda and no process group ({self.eager})")
        self.runner = GraphedStep(self.device) if self.eager is None else None

    def form(self, step: int) -> str:
        """How the step runs, for a run whose state is at ``step``."""
        if self.runner is None:
            return f"eager ({self.eager})"
        return f"CUDA graph, captured at step {step + 2} (step {step + 1} eager)"

    def body(self, state: TrainState, batch: dict) -> dict:
        """One step's device work, read from ``batch``, the state's tensors
        and :class:`StepInputs` alone: no read to the host, and no Python
        number that changes from step to step. Returns the metrics but the
        lr, 0-dim tensors."""
        cfg, model, inp = self.cfg, self.model, self.inputs
        params = state.params()
        plist = [params[k] for k in self.names]
        for p in plist:
            p.grad = None
        x = prep_x(cfg, batch["x"])
        extra = {"key": jr.fold_in(self.base, inp.step)}
        if self.jitter_start > 0:
            # the jitter gate: probability 0 before time_jitter_start
            extra["jitter_scale"] = inp.gate
        with dist.synced():
            ranks, _ = dist.global_rows()
            y_hat, aux, perp = model.forward(x, batch.get("c"), batch.get("g"), train=True, dtype=self.dtype, **extra)
            recon = objective(cfg, model, y_hat, batch, x.shape[1])
            aux = torch.as_tensor(aux) / ranks
            # commitment warm-up: the VQ aux loss is ramped in (and reported unscaled)
            loss = recon + inp.ramp * aux
            loss.backward()
            with torch.no_grad():
                grads = [torch.zeros_like(p) if p.grad is None else p.grad for p in plist]
                dist.all_sum_(grads)
                loss, recon, aux = (dist.all_sum(t.detach()) for t in (loss, recon, aux))

        with torch.no_grad():
            norms = torch.stack(torch._foreach_norm(grads))
            if self.tp:
                sq = norms.square()
                gnorm = (dist.model_sum(sq[self.sharded].sum()) + sq[~self.sharded].sum()).sqrt()
            else:
                gnorm = torch.linalg.vector_norm(norms)
            if self.clip > 0:
                # the JAX formula, not clip_grad_norm_'s clip / (norm + 1e-6)
                scale = torch.clamp(self.clip / torch.clamp(gnorm, min=1e-6), max=1.0)
                grads = torch._foreach_mul(grads, scale)

            # Adam as optax computes it, with the LR of this step (before the
            # increment) and the bias corrections of the incremented count
            mu = [state.mu[k] for k in self.names]
            nu = [state.nu[k] for k in self.names]
            torch._foreach_mul_(mu, ADAM_B1)
            torch._foreach_add_(mu, grads, alpha=1.0 - ADAM_B1)
            torch._foreach_mul_(nu, ADAM_B2)
            torch._foreach_addcmul_(nu, grads, grads, value=1.0 - ADAM_B2)
            mu_hat = torch._foreach_div(mu, inp.bc1)
            den = torch._foreach_sqrt(torch._foreach_div(nu, inp.bc2))
            torch._foreach_add_(den, self.eps)
            upd = torch._foreach_div(mu_hat, den)
            if self.wd > 0.0:  # adamw: decoupled decay, before the LR scale
                torch._foreach_add_(upd, plist, alpha=self.wd)
            # u = -lr·upd, then p + u (p − lr·upd, the same bits)
            torch._foreach_mul_(upd, inp.lr)
            torch._foreach_sub_(plist, upd)

            # dead-code revival after the update, from the forward's stash
            # (the same on every rank: global codes, the JAX step's key)
            if self.reseed:
                reseeded = self.vq.revive(inp.active != 0, ReseedDraws.candidates(inp.words))
            else:
                reseeded = torch.zeros((), device=self.device)

            if state.ema is not None:
                # shadow -= (1 - decay) * (shadow - param)
                torch._foreach_lerp_([state.ema[k] for k in self.names], plist, 1.0 - cfg.ema_decay)
        return {
            "loss": loss,
            "recon_loss": recon,
            "aux_loss": aux,
            "perplexity": torch.as_tensor(perp).detach(),
            "grad_norm": gnorm,
            "reseeded": reseeded,
        }

    def __call__(self, state: TrainState, batch: dict):
        step = state.step
        with spans.span("step", step=step):
            lr = self.schedule(step)
            count = state.count + 1
            self.inputs.write(
                step=step, active=self.reseed and step >= self.vq.reseed_start, lr=lr,
                bc1=1.0 - ADAM_B1 ** count, bc2=1.0 - ADAM_B2 ** count,
                ramp=min(max(step / self.warmup, 0.0), 1.0) if self.warmup > 0 else 1.0,
                gate=1.0 if step >= self.jitter_start else 0.0,
                words=self.draws.words(step) if self.draws is not None else None)
            if self.runner is None:
                metrics = self.body(state, batch)
            else:
                metrics = self.runner(self.body, state, batch)
            spans.count_pinned_allocs()
        state.count, state.lr = count, lr
        state.step += 1
        metrics["lr"] = torch.tensor(lr)
        return state, metrics


def make_train_step(cfg: Config, model: nn.Module, graph: bool | None = None) -> TrainStep:
    """``state, metrics = step_fn(state, batch)``; batch is a dict of tensors
    on the model's device: x (B, T) codes or samples, y (B, T, 1), c (B, T',
    dim_in), g (B,) when the config has global conditioning, and lengths
    (B,): the whole batch, or under a process group this rank's slice of it.
    The metrics are 0-dim tensors (reading them waits for the device), the
    same on every rank; under a graph they are copies of its outputs.

    ``graph``: None runs the step as a CUDA graph when the model is on cuda
    and no process group is initialized (gloo collectives cannot be
    captured; NCCL's need more than one card), eagerly otherwise; True
    raises where the graph cannot be had; False runs it eagerly. The graph
    is the counterpart of the JAX step's ``jax.jit`` with donated state: it
    runs the first step eagerly, captures the second and replays it from
    then on, in place on the state it was captured with
    (``train.graph.GraphedStep``).

    Every draw of the step comes from its key (see the module's
    docstring): the model's forward takes it, and revival maps the reseed
    words written into :class:`StepInputs`."""
    return TrainStep(cfg, model, graph)


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
