"""The plain reference of the benchmark's two models, SVQ-WAE and IN-WAE
(arXiv:2008.06892), in plain PyTorch, written from the models' equations:
no kernel, no cache, no batching tricks, and nothing of the program.

- ``forward``: the content encoder (conv blocks with identity residuals
  and stride-2 downsampling, a linear projection), instance norm, the
  sliced VQ with its straight-through estimator (SVQ-WAE), the
  conditioning upsampler (a context conv, then per scale a nearest stretch
  and a weight-normed smoothing kernel), the WaveNet (a gathered first
  layer, gated residual layers with dilated causal convs, conditioning and
  speaker projections, skip sum, post-net) and the masked one-step-ahead
  cross entropy.
- ``train_steps``: Adam steps as optax computes them (bias-corrected
  moments, ε outside the root), with the parameter EMA, over given
  batches; the batch is cut into blocks of rows whose gradients add up to
  the whole batch's (every loss term is a sum over rows divided by the
  whole batch's count), so the reference fits beside nothing else.

Weights are a dict by the models' parameter paths; convolutions are
weight-normed (w = g·v/‖v‖ over (K, Cin) per output channel) where the
models' are. Every product goes through ``mm``, which computes it in
float32 (TF32 off: the caller sets ``precision``'s flags), in float64
('f64': the yardstick of the float32 gradient's own rounding) or in a lower
``mode`` as the program computes in its compute type, one type down: the
control's 'fp8' rounds the operands and what the program stores in its
compute type to float8 e4m3, and the backward's incoming gradients to
e5m2, each with a per-tensor scale; 'bf16' does the same in bfloat16 (a
diagnostic of the program's own rounding).
"""
from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F

FP8_MAX = {torch.float8_e4m3fn: 448.0, torch.float8_e5m2: 57344.0}
#: per mode: (operands and stored results, incoming gradients); None keeps
#: the mode's working type, float32 or (``f64``) float64
MODES = {"f32": (None, None), "f64": (None, None), "bf16": (torch.bfloat16, torch.bfloat16),
         "fp8": (torch.float8_e4m3fn, torch.float8_e5m2)}


@contextlib.contextmanager
def precision():
    """float32 products: TF32 off for matmuls and cuDNN, restored after."""
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
           torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old[0], old[1]
        torch.set_float32_matmul_precision(old[2])


def rnd(x: torch.Tensor, mode: str, grad: bool = False) -> torch.Tensor:
    """x rounded to ``mode``'s storage (``grad``: its gradients' type), a
    float8 type with a per-tensor scale to the largest value; the
    gradient passes the rounding straight through. The identity in f32."""
    dtype = MODES[mode][1 if grad else 0]
    if dtype is None:
        return x
    with torch.no_grad():
        if dtype in FP8_MAX:
            s = FP8_MAX[dtype] / x.abs().amax().float().clamp_min(1e-30)
            q = ((x * s).to(dtype).float() / s).to(x.dtype)
        else:
            q = x.to(dtype).to(x.dtype)
    return x + (q - x).detach() if x.requires_grad else q


class _LowMm(torch.autograd.Function):
    """A product of rounded operands; the backward's products take the
    incoming gradient rounded to the mode's gradient type."""

    @staticmethod
    def forward(ctx, a, b, mode):
        qa, qb = rnd(a, mode), rnd(b, mode)
        ctx.save_for_backward(qa, qb)
        ctx.mode = mode
        return qa @ qb

    @staticmethod
    def backward(ctx, g):
        qa, qb = ctx.saved_tensors
        qg = rnd(g, ctx.mode, grad=True)
        ga = qg @ qb.transpose(-1, -2)
        gb = qa.reshape(-1, qa.shape[-1]).transpose(0, 1) @ qg.reshape(-1, qg.shape[-1])
        return ga, gb.reshape(qb.shape), None


def mm(a: torch.Tensor, b: torch.Tensor, mode: str, store: bool = True) -> torch.Tensor:
    """a (..., K) @ b (K, N) in ``mode``. 'f32', 'f64': the operands' own
    type. A lower mode rounds the operands, accumulates in float32 and
    (``store``) rounds the result, as the program stores a product in its
    compute type."""
    if MODES[mode][0] is None:
        return a @ b
    y = _LowMm.apply(a, b, mode)
    return rnd(y, mode) if store else y


def wn(w: dict, path: str) -> torch.Tensor:
    """The folded weight (K, Cin, Cout) of a weight-normed conv."""
    v, g = w[f"{path}/v"], w[f"{path}/g"]
    return g * v / v.square().sum((0, 1), keepdim=True).sqrt().clamp_min(1e-12)


def conv(x, wk, b, *, stride=1, dilation=1, pad=(0, 0), mode="f32"):
    """Conv over time of x (B, T, Cin) with wk (K, Cin, Cout): one product
    a tap over the padded input's strided slices, plus the bias."""
    K = wk.shape[0]
    xp = F.pad(x, (0, 0, pad[0], pad[1]))
    t_out = (xp.shape[1] - dilation * (K - 1) - 1) // stride + 1
    y = 0.0
    for j in range(K):
        s = j * dilation
        y = y + mm(xp[:, s : s + stride * (t_out - 1) + 1 : stride], wk[j], mode, store=False)
    y = rnd(y, mode)  # one product over the taps, stored once
    return y if b is None else y + b


def encoder(w, c, cfg, mode):
    """(B, frames, dim_in) -> (B, latent frames, cin_channels)."""
    n_ds = {1: 0, 2: 1, 4: 2}[100 // cfg["frame_rate"]]
    specs = [(3, 1), (3, 1)] + [(5, 2)] * n_ds + [(5, 1)] * (2 - n_ds) + [(3, 1), (3, 1)] + [(1, 1)] * 4
    h, hid = c, cfg["encoder_hid"]
    for i, (k, s) in enumerate(specs):
        out = F.relu(conv(h, w[f"encoder/blocks/{i}/w"], w[f"encoder/blocks/{i}/b"], stride=s,
                          pad=(k // 2, k // 2), mode=mode))
        h = out + h if (s == 1 and h.shape[-1] == hid) else out
    return mm(h, w["encoder/lin/w"], mode) + w["encoder/lin/b"]


def instance_norm(z, eps=1e-5):
    """Per utterance and channel over time, with the biased variance."""
    mean = z.mean(1, keepdim=True)
    var = (z - mean).square().mean(1, keepdim=True)
    return (z - mean) / torch.sqrt(var + eps)


def sliced_vq(w, z, cfg, mode):
    """Nearest code per slice (‖z‖² + ‖e‖² − 2 z·e), straight through.
    Returns (q, the loss terms' sums): commit·Σ(sg(q) − z)² + β·Σ(q − sg(z))²
    over this block, to be divided by the whole batch's element count."""
    D = z.shape[-1]
    n = cfg["num_slices"]
    sub = D // n
    flat = z.reshape(-1, D)
    qs = []
    for i in range(n):
        e = w[f"vq/codebooks/{i}"]
        part = flat[:, i * sub : (i + 1) * sub]
        # float32 in every mode: the program's nearest code is float32
        d = part.square().sum(1, keepdim=True) + e.square().sum(1)[None] - 2.0 * (part @ e.t())
        qs.append(e[d.argmin(1)])
    q = torch.cat(qs, 1).reshape(z.shape)
    beta, commit = cfg.get("beta", 0.25), cfg.get("vq_commit_scale", 1.0)
    terms = commit * (q.detach() - z).square().sum() + beta * (q - z.detach()).square().sum()
    return z + (q - z).detach(), terms


def bottleneck(w, z, cfg, mode):
    """(latent, aux sum) of the family: SVQ-WAE's instance norm and sliced
    VQ, IN-WAE's instance norm."""
    z = instance_norm(z)
    if cfg["name"] == "vqvae":
        return sliced_vq(w, z, cfg, mode)
    return z, z.new_zeros(())


def upsample(w, lat, cfg, mode):
    """(B, T', C) -> (B, T'·prod(scales), C)."""
    pad = cfg["cin_pad"]
    h = conv(lat, w["wavenet/upsample/conv_in/w"], None, mode=mode)
    scales = cfg["upsample_params"]["upsample_scales"]
    for i, s in enumerate(scales):
        v, g = w[f"wavenet/upsample/upsample/convs/{i}/v"], w[f"wavenet/upsample/upsample/convs/{i}/g"]
        k = (g * v / v.square().sum().sqrt().clamp_min(1e-12)).reshape(-1)
        h = h.repeat_interleave(s, dim=1)
        h, k = rnd(h, mode), rnd(k, mode)
        hp = F.pad(h, (0, 0, s, s))
        T = h.shape[1]
        h = rnd(sum(k[j] * hp[:, j : j + T] for j in range(2 * s + 1)), mode)
    indent = pad * math.prod(scales)
    return h[:, indent : h.shape[1] - indent] if indent else h


def wavenet(w, x_codes, c_up, spk, cfg, mode):
    """Teacher-forced logits (B, T, O) of integer inputs (B, T). In a lower
    mode the stack keeps what the program's fused stack keeps in its
    compute type: the residual stream, each layer's gate input (the taps'
    and the conditioning's product, one sum) and output, the skip sum."""
    L, per = cfg["layers"], cfg["layers"] // cfg["stacks"]
    w1 = rnd(wn(w, "wavenet/first")[0], mode)
    h = rnd(w1[x_codes.long()] + w["wavenet/first/b"], mode)
    c_up = rnd(c_up, mode)
    g_feat = w["wavenet/embed/table"][spk.long()][:, None, :] if cfg["gin_channels"] > 0 else None
    skips = 0.0
    for l in range(L):
        p = f"wavenet/layers/{l}"
        d = 2 ** (l % per)
        wk = wn(w, f"{p}/conv")
        hp = F.pad(h, (0, 0, 2 * d, 0))
        T = h.shape[1]
        a = sum(mm(hp[:, j * d : j * d + T], wk[j], mode, store=False) for j in range(3))
        a = a + mm(c_up, wn(w, f"{p}/cproj")[0], mode, store=False)
        if g_feat is not None:
            a = a + g_feat @ wn(w, f"{p}/gproj")[0]
        a = rnd(a + w[f"{p}/conv/b"], mode)
        half = a.shape[-1] // 2
        gate = rnd(torch.tanh(a[..., :half]) * torch.sigmoid(a[..., half:]), mode)
        skips = rnd(skips + mm(gate, wn(w, f"{p}/skip")[0], mode, store=False) + w[f"{p}/skip/b"], mode)
        h = rnd((mm(gate, wn(w, f"{p}/out")[0], mode, store=False) + w[f"{p}/out/b"] + h) * math.sqrt(0.5), mode)
    out = F.relu(skips * math.sqrt(1.0 / L))
    out = F.relu(mm(out, wn(w, "wavenet/post1")[0], mode) + w["wavenet/post1/b"])
    return mm(out, wn(w, "wavenet/post2")[0], mode) + w["wavenet/post2/b"]


def block_loss(w, batch, rows, cfg, mode, n_rows, T):
    """This block's share of the step's loss (recon + aux), as sums over its
    rows divided by the whole batch's counts; the mask is every position
    below each row's length."""
    x, c, spk, lengths = (batch[k][rows] for k in ("x", "c", "g", "lengths"))
    z = encoder(w, c, cfg, mode)
    lat, aux_sum = bottleneck(w, z, cfg, mode)
    logits = wavenet(w, x, upsample(w, lat, cfg, mode), spk, cfg, mode)
    mask = (torch.arange(T, device=x.device)[None, :] < lengths[:, None]).to(logits.dtype)[:, 1:]
    nll = -torch.log_softmax(logits[:, :-1], -1).gather(-1, x[:, 1:, None].long())[..., 0]
    denom = batch["mask_count"]
    recon = (nll * mask).sum() / denom
    aux = aux_sum / (n_rows * z.shape[1] * z.shape[2])
    return recon, aux


def lr_at(cfg, step: int) -> float:
    """The step-decay schedule's lr (the configs' ``step_learning_rate_decay``)."""
    init = float(cfg["optimizer_params"]["lr"])
    kw = cfg["lr_schedule_kwargs"]
    if cfg["lr_schedule"] != "step_learning_rate_decay":
        raise ValueError(f"no reference for lr_schedule {cfg['lr_schedule']!r}")
    return init * kw["anneal_rate"] ** (int(step) // kw["anneal_interval"])


def train_steps(w0: dict, batches: list[dict], cfg: dict, mode: str = "f32", block: int = 8,
                rows_used=None, frozen: bool = False) -> dict:
    """Adam steps from weights ``w0`` over ``batches`` (x (B, T) codes, c (B,
    frames, dim_in), g (B,), lengths (B,)), one step a batch, the loss the
    mean over ``rows_used`` (default every row). Returns each step's loss,
    the first step's gradients as Adam's state holds them, the weights after
    the last step and the EMA shadow there (float32 tensors on the weights'
    device; float64 in mode 'f64'). ``frozen`` is a step that leaves its
    state unchanged (a fault the calibration reads)."""
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
        rows = torch.arange(B, device=batch["x"].device) if rows_used is None else rows_used
        sub = {k: batch[k][rows] for k in ("x", "c", "g", "lengths")}
        sub["c"] = sub["c"].to(dtype)
        mask_count = ((torch.arange(T, device=sub["x"].device)[None, :] < sub["lengths"][:, None])[:, 1:]).sum()
        sub["mask_count"] = mask_count.float().clamp_min(1.0)
        leaves = {k: p[k].clone().requires_grad_(True) for k in names}
        grads = {k: torch.zeros_like(p[k]) for k in names}
        total = 0.0
        n = len(rows)
        for i in range(0, n, block):
            r = torch.arange(i, min(i + block, n), device=sub["x"].device)
            recon, aux = block_loss(leaves, sub, r, cfg, mode, n, T)
            loss = recon + aux
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
        count = step + 1
        lr = lr_at(cfg, step)
        with torch.no_grad():
            for k in names:
                g = grads[k]
                m[k] = b1 * m[k] + (1 - b1) * g
                v2[k] = b2 * v2[k] + (1 - b2) * g * g
                upd = (m[k] / (1 - b1**count)) / ((v2[k] / (1 - b2**count)).sqrt() + eps)
                p[k] = p[k] - lr * upd
                if ema is not None:
                    ema[k] = ema[k] + (1.0 - cfg["ema_decay"]) * (p[k] - ema[k])
    return {"losses": losses, "first_grad": first_grad, "params": p, "ema": ema}

