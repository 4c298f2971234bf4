"""The plain reference of r9y9's raw-audio WaveNet vocoder
(github.com/r9y9/wavenet_vocoder: ``wavenet_vocoder/wavenet.py``,
``upsample.py``, ``mixture.py``; its ``train.py`` step) with its
discretized mixture-of-logistics (MoL) loss, in plain PyTorch, written from
those equations: no kernel, no cache, no batching tricks, and nothing of
the program.

- ``forward``: ``ConvInUpsampleNetwork`` (a context conv of kernel
  2·cin_pad + 1 with no padding and no bias, then per scale a nearest
  stretch and a weight-normed smoothing kernel, the inner network built
  with cin_pad 0), the 1×1 weight-normed conv of the scalar input, the
  gated residual layers (dilated causal conv, the conditioning's 1×1 conv
  without bias, tanh·sigmoid, skip and out 1×1 convs, (out + residual)·√½),
  the skip sum over √L, and the post-net ReLU, 1×1, ReLU, 1×1.
- ``mol_nll``: ``discretized_mix_logistic_loss`` as r9y9 writes it: log
  scales clamped at ``log_scale_min``, each bin's CDF difference at
  ``num_classes`` levels, floored at 1e-12, the density at the bin's
  centre where the difference is 1e-5 or less, and the two edge bins
  (y < −0.999, y > 0.999) as one-sided tails, selected by 0/1 masks;
  then log-sum-exp over the components with the log-softmax of their
  logits.
- ``train_steps``: the masked one-step-ahead loss (y_hat[:, :-1] against
  x[:, 1:], a mean over the positions below each row's length), Adam with
  bias-corrected moments and ε outside the root, the step-decay learning
  rate and the parameter EMA, over given batches, the batch cut into
  blocks of rows whose gradients add up to the whole batch's.

The shared pieces come from the SVQ-WAE reference beside this file
(``reference/wae.py``, loaded by path): ``precision`` (TF32 off),
``rnd`` / ``mm`` / ``conv`` (each product in float32, in float64 for
'f64', or rounded as the program stores its compute type for 'bf16' and
the float8 control 'fp8'), ``wn`` (the weight norm) and ``lr_at``; and its
upsampler, whose trim of cin_pad·prod(scales) samples belongs to the plain
``UpsampleNetwork`` and is nought here, since the context conv has taken
the cin_pad frames each side.

Departures from r9y9's code: channels last ((B, T, C) in place of (B, C,
T)); dropout left out, since the configuration's ``dropout`` is 0; no
gradient clipping, since its ``clip_thresh`` is −1; Adam and the EMA written
out (the same updates as ``torch.optim.Adam`` without weight decay and
r9y9's ``ExponentialMovingAverage``); the loss of a step summed over blocks
of rows; and the 'bf16' / 'fp8' modes, which are this benchmark's and not
r9y9's. The weights are the benchmark's seeded draw by parameter path.
"""
from __future__ import annotations

import importlib.util
import math
from pathlib import Path

import torch
import torch.nn.functional as F


def _sibling(name: str):
    path = Path(__file__).with_name(f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"bench_reference_vocoder_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


_wae = _sibling("wae")
precision, rnd, mm, wn, lr_at = _wae.precision, _wae.rnd, _wae.mm, _wae.wn, _wae.lr_at


def upsample(w, c, cfg, mode):
    """(B, frames + 2·cin_pad, cin) -> (B, frames·prod(scales), cin)."""
    return _wae.upsample(w, c, {**cfg, "cin_pad": 0}, mode)


def wavenet(w, x, c_up, cfg, mode):
    """The MoL parameters (B, T, 3·M) of scalar inputs x (B, T). In a lower
    mode the stack keeps what the program's fused stack keeps in its compute
    type: the first conv's output, the residual stream, each layer's gate
    input and output, the skip sum."""
    L, per = cfg["layers"], cfg["layers"] // cfg["stacks"]
    h = rnd(mm(x[..., None], wn(w, "wavenet/first")[0], mode) + w["wavenet/first/b"], mode)
    c_up = rnd(c_up, mode)
    skips = 0.0
    for l in range(L):
        p = f"wavenet/layers/{l}"
        d = 2 ** (l % per)
        wk = wn(w, f"{p}/conv")
        T = h.shape[1]
        hp = F.pad(h, (0, 0, (wk.shape[0] - 1) * d, 0))
        a = sum(mm(hp[:, j * d : j * d + T], wk[j], mode, store=False) for j in range(wk.shape[0]))
        a = a + mm(c_up, wn(w, f"{p}/cproj")[0], mode, store=False)
        a = rnd(a + w[f"{p}/conv/b"], mode)
        half = a.shape[-1] // 2
        gate = rnd(torch.tanh(a[..., :half]) * torch.sigmoid(a[..., half:]), mode)
        skips = rnd(skips + mm(gate, wn(w, f"{p}/skip")[0], mode, store=False) + w[f"{p}/skip/b"], mode)
        h = rnd((mm(gate, wn(w, f"{p}/out")[0], mode, store=False) + w[f"{p}/out/b"] + h) * math.sqrt(0.5), mode)
    out = F.relu(skips * math.sqrt(1.0 / L))
    out = F.relu(mm(out, wn(w, "wavenet/post1")[0], mode) + w["wavenet/post1/b"])
    return mm(out, wn(w, "wavenet/post2")[0], mode) + w["wavenet/post2/b"]


def forward(w, x, c, cfg, mode="f32"):
    """x (B, T) samples in [-1, 1], c (B, T/hop + 2·cin_pad, cin) -> (B, T, 3·M)."""
    return wavenet(w, x, upsample(w, c, cfg, mode), cfg, mode)


def log_sum_exp(x: torch.Tensor) -> torch.Tensor:
    m = x.amax(-1)
    return m + torch.log(torch.exp(x - m[..., None]).sum(-1))


def mol_nll(y_hat: torch.Tensor, y: torch.Tensor, num_classes: int, log_scale_min: float) -> torch.Tensor:
    """The NLL (B, T) of targets y (B, T) in [-1, 1] under the discretized
    MoL of y_hat (B, T, 3·M) = [logits | means | log scales]."""
    M = y_hat.shape[-1] // 3
    logit_probs, means = y_hat[..., :M], y_hat[..., M : 2 * M]
    log_scales = torch.clamp(y_hat[..., 2 * M : 3 * M], min=log_scale_min)
    y = y[..., None].expand_as(means)
    centered = y - means
    inv_stdv = torch.exp(-log_scales)
    plus_in = inv_stdv * (centered + 1.0 / (num_classes - 1))
    min_in = inv_stdv * (centered - 1.0 / (num_classes - 1))
    log_cdf_plus = plus_in - F.softplus(plus_in)
    log_one_minus_cdf_min = -F.softplus(min_in)
    cdf_delta = torch.sigmoid(plus_in) - torch.sigmoid(min_in)
    mid_in = inv_stdv * centered
    log_pdf_mid = mid_in - log_scales - 2.0 * F.softplus(mid_in)
    inner_inner_cond = (cdf_delta > 1e-5).to(y_hat.dtype)
    inner_inner_out = (inner_inner_cond * torch.log(torch.clamp(cdf_delta, min=1e-12))
                       + (1.0 - inner_inner_cond) * (log_pdf_mid - math.log((num_classes - 1) / 2)))
    inner_cond = (y > 0.999).to(y_hat.dtype)
    inner_out = inner_cond * log_one_minus_cdf_min + (1.0 - inner_cond) * inner_inner_out
    cond = (y < -0.999).to(y_hat.dtype)
    log_probs = cond * log_cdf_plus + (1.0 - cond) * inner_out
    return -log_sum_exp(log_probs + F.log_softmax(logit_probs, -1))


def block_loss(w, batch, rows, cfg, mode, T):
    """This block's share of the step's loss: the masked NLL summed over its
    rows, over the whole batch's count of positions."""
    x, c, lengths = (batch[k][rows] for k in ("x", "c", "lengths"))
    y_hat = forward(w, x, c, cfg, mode)
    nll = mol_nll(y_hat[:, :-1], x[:, 1:], cfg["quantize_channels"], cfg["log_scale_min"])
    mask = (torch.arange(T, device=x.device)[None, :] < lengths[:, None]).to(nll.dtype)[:, 1:]
    return (nll * mask).sum() / batch["mask_count"]


def train_steps(w0: dict, batches: list[dict], cfg: dict, mode: str = "f32", block: int = 4,
                rows_used=None, frozen: bool = False) -> dict:
    """Adam steps from weights ``w0`` over ``batches`` (x (B, T) float
    samples, c (B, frames, cin), lengths (B,)), one step a batch, the loss
    the mean over ``rows_used`` (default every row). Returns each step's
    loss, the first step's gradients as Adam's state holds them, the weights
    after the last step and the EMA shadow there (float32 tensors on the
    weights' device; float64 in mode 'f64'). ``frozen`` is a step that
    leaves its state unchanged (a fault the calibration reads)."""
    dtype = torch.float64 if mode == "f64" else torch.float32
    names = sorted(w0)
    p = {k: w0[k].detach().clone().to(dtype) for k in names}
    m = {k: torch.zeros_like(v) for k, v in p.items()}
    v2 = {k: torch.zeros_like(v) for k, v in p.items()}
    ema = {k: v.clone() for k, v in p.items()} if cfg.get("exponential_moving_average") else None
    b1, b2, eps = 0.9, 0.999, float(cfg["optimizer_params"].get("eps", 1e-8))
    losses, first_grad = [], None
    for step, batch in enumerate(batches):
        B, T = batch["x"].shape
        dev = batch["x"].device
        rows = torch.arange(B, device=dev) if rows_used is None else rows_used
        sub = {"x": batch["x"][rows].to(dtype), "c": batch["c"][rows].to(dtype), "lengths": batch["lengths"][rows]}
        count = ((torch.arange(T, device=dev)[None, :] < sub["lengths"][:, None])[:, 1:]).sum()
        sub["mask_count"] = count.to(dtype).clamp_min(1.0)
        leaves = {k: p[k].clone().requires_grad_(True) for k in names}
        grads = {k: torch.zeros_like(p[k]) for k in names}
        total = 0.0
        n = len(rows)
        for i in range(0, n, block):
            r = torch.arange(i, min(i + block, n), device=dev)
            loss = block_loss(leaves, sub, r, cfg, mode, T)
            gs = torch.autograd.grad(loss, [leaves[k] for k in names], allow_unused=True)
            for k, g in zip(names, gs):
                if g is not None:
                    grads[k] += g
            total += float(loss.detach())
        losses.append(total)
        if first_grad is None:
            first_grad = {k: (torch.zeros_like(g) if frozen else g.clone()) for k, g in grads.items()}
        if frozen:
            continue
        t = step + 1
        lr = lr_at(cfg, step)
        with torch.no_grad():
            for k in names:
                g = grads[k]
                m[k] = b1 * m[k] + (1 - b1) * g
                v2[k] = b2 * v2[k] + (1 - b2) * g * g
                p[k] = p[k] - lr * (m[k] / (1 - b1**t)) / ((v2[k] / (1 - b2**t)).sqrt() + eps)
                if ema is not None:
                    ema[k] = ema[k] + (1.0 - cfg["ema_decay"]) * (p[k] - ema[k])
    return {"losses": losses, "first_grad": first_grad, "params": p, "ema": ema}
