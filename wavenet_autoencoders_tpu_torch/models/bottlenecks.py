"""The bottlenecks of the model zoo (counterpart of
``wavenet_autoencoders_tpu/models/bottlenecks.py``):

- plain VQ with the reference's swapped-β loss (β weights the
  codebook-to-encoder term);
- sliced VQ with the standard loss form and perplexity summed over slices;
- EMA codebooks (Laplace-smoothed cluster statistics, quantizing with the
  updated codebook in the same step, commit-only loss), and dead-code
  revival (usage EMA, reseed from encoder outputs);
- the Gumbel-softmax categorical bottleneck (CatWAE, CatMfccAE);
- instance norm and AdaIN, time jitter and VQ-dropout.

z is (B, T', D) throughout. ``.detach()`` stands for ``stop_gradient``.
Each stochastic function draws its noise from a JAX ``key`` with the JAX
function's call (``utils.jax_random``); the primitives that the
regularizer tests hold against JAX's also take it as an argument (``u``,
``start``, ``cand_idx``: the train step draws the reseed candidates from
the JAX step's keys). Inside
``parallel.distributed.synced()`` the noise is this rank's rows of the
global batch's draw, and the code counts (perplexity, usage) and the EMA
statistics are those of the global batch.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from wavenet_autoencoders_tpu_torch.ops.conv import Linear, linear_apply
from wavenet_autoencoders_tpu_torch.parallel import distributed as dist
from wavenet_autoencoders_tpu_torch.utils import jax_random as jr


def _nearest_code(flat: torch.Tensor, codebook: torch.Tensor) -> torch.Tensor:
    """Nearest neighbour via the ‖z‖² + ‖e‖² − 2 z·e expansion, in f32."""
    flat = flat.float()
    codebook = codebook.float()
    dist = (
        flat.square().sum(1, keepdim=True)
        + codebook.square().sum(1)[None, :]
        - 2.0 * flat @ codebook.T
    )
    return dist.argmin(1)


def code_fractions(one_hot: torch.Tensor) -> torch.Tensor:
    """The mean one-hot (N, K) -> (K,) over the batch's latent frames: over
    the global batch inside ``synced()`` (the ranks' frame counts are equal)."""
    ranks, _ = dist.global_rows()
    return dist.all_sum(one_hot.float().mean(0).detach()) / ranks


def _perplexity(one_hot: torch.Tensor) -> torch.Tensor:
    avg = code_fractions(one_hot)
    return torch.exp(-(avg * torch.log(avg + 1e-10)).sum())


def _uniform_codebook(key, K, D):
    return jr.uniform(key, (K, D), -1.0 / K, 1.0 / K)


class VQ(nn.Module):
    """Plain VQ: ``codebook`` (K, D), U(±1/K) from ``key``."""

    def __init__(self, K: int, D: int, *, key: torch.Tensor):
        super().__init__()
        self.codebook = nn.Parameter(_uniform_codebook(key, K, D))


class SlicedVQ(nn.Module):
    """Sliced VQ: ``codebooks.{i}`` (K_i, D/num_slices), one key split
    from ``key`` a slice."""

    def __init__(self, K: int, D: int, num_slices: int = 2, K1: int | None = None, *, key: torch.Tensor):
        super().__init__()
        assert D % num_slices == 0
        sub = D // num_slices
        keys = jr.split(key, num_slices)
        self.codebooks = nn.ParameterList(
            _uniform_codebook(k, s, sub) for k, s in zip(keys, _slice_sizes(K, K1, num_slices))
        )


def vq_apply(p: VQ, z: torch.Tensor, beta: float = 0.25):
    """Returns (quantized, vq_loss, perplexity, indices).

    Loss = β·mean((sg(q) - z)²) + mean((q - sg(z))²)."""
    B, T, D = z.shape
    codebook = p.codebook
    idx = _nearest_code(z.reshape(-1, D), codebook)
    q = codebook[idx].reshape(B, T, D)
    vq_loss = beta * (q.detach() - z).square().mean() + (q - z.detach()).square().mean()
    q_st = z + (q - z).detach()  # straight-through
    perp = _perplexity(F.one_hot(idx, codebook.shape[0]))
    return q_st, vq_loss, perp, idx.reshape(B, T)


def _slice_sizes(K: int, K1: int | None, num_slices: int) -> list[int]:
    """Codebook size per slice: slice 2 may use K1; further slices reuse K."""
    sizes = [K] * num_slices
    if num_slices >= 2 and K1 is not None:
        sizes[1] = K1
    return sizes


def sliced_vq_apply(p: SlicedVQ, z: torch.Tensor, beta: float = 0.25, commit_scale: float = 1.0):
    """Loss commit_scale·mean((sg(q)-z)²) + β·mean((q-sg(z))²); perplexity
    is the sum over slices. Returns (quantized, vq_loss, perplexity,
    indices (B, T, n_slices))."""
    B, T, D = z.shape
    books = p.codebooks
    sub = D // len(books)
    flat = z.reshape(-1, D)
    qs, idxs, perp = [], [], 0.0
    for i, cb in enumerate(books):
        idx = _nearest_code(flat[:, i * sub : (i + 1) * sub], cb)
        qs.append(cb[idx])
        perp = perp + _perplexity(F.one_hot(idx, cb.shape[0]))
        idxs.append(idx.reshape(B, T))
    q = torch.cat(qs, dim=1).reshape(B, T, D)
    vq_loss = (
        commit_scale * (q.detach() - z).square().mean()
        + beta * (q - z.detach()).square().mean()
    )
    q_st = z + (q - z).detach()
    return q_st, vq_loss, perp, torch.stack(idxs, dim=-1)


class BufferList(nn.Module):
    """Tensors that are model state but not parameters, registered as
    buffers ``0``, ``1``, ... (so a buffer's name is its JAX tree path)."""

    def __init__(self, tensors):
        super().__init__()
        for i, t in enumerate(tensors):
            self.register_buffer(str(i), t)

    def __getitem__(self, i: int) -> torch.Tensor:
        return getattr(self, str(i))

    def __len__(self) -> int:
        return len(self._buffers)

    def __iter__(self):
        return iter(self._buffers.values())


class VQEMA(nn.Module):
    """EMA-codebook state, no parameters: per slice the buffers
    ``codebooks.{i}`` (K_i, sub), ``cluster_size.{i}`` (K_i,) and
    ``ema_w.{i}`` (K_i, sub); one slice of D when ``num_slices`` is 1."""

    def __init__(self, K: int, D: int, num_slices: int = 1, K1: int | None = None, *, key: torch.Tensor):
        super().__init__()
        if num_slices == 1:
            sizes, sub = [K], D
        else:
            assert D % num_slices == 0
            sizes, sub = _slice_sizes(K, K1, num_slices), D // num_slices
        keys, dev = jr.split(key, len(sizes)), key.device
        self.codebooks = BufferList(_uniform_codebook(k, s, sub) for k, s in zip(keys, sizes))
        self.cluster_size = BufferList(torch.zeros(s, device=dev) for s in sizes)
        self.ema_w = BufferList(torch.zeros(s, sub, device=dev) for s in sizes)


def vq_ema_apply(state: VQEMA, z: torch.Tensor, beta: float = 0.25, decay: float = 0.99, train: bool = True):
    """Returns (quantized, vq_loss, perplexity, indices (B, T, slices)).

    In training the statistics are updated in place first, with Laplace
    smoothing (ε=1e-5), and the batch is quantized with the updated
    codebook. The loss is β·mean((sg(q) - z)²) only: EMA codebooks get no
    gradient. The counts and ``dw`` sums are global inside ``synced()``."""
    B, T, D = z.shape
    books = state.codebooks
    n = len(books)
    sub = D // n
    flat = z.reshape(-1, D)
    qs, idxs, perp = [], [], 0.0
    for i in range(n):
        cb = books[i]
        part = flat[:, i * sub : (i + 1) * sub].detach().float()
        K = cb.shape[0]
        idx = _nearest_code(part, cb)
        oh = F.one_hot(idx, K).float()
        if train:
            with torch.no_grad():
                counts, dw = oh.sum(0), oh.T @ part
                dist.all_sum_([counts, dw])
                cs = state.cluster_size[i] * decay + (1.0 - decay) * counts
                ntot = cs.sum()
                cs = (cs + 1e-5) / (ntot + K * 1e-5) * ntot
                ew = state.ema_w[i] * decay + (1.0 - decay) * dw
                state.cluster_size[i].copy_(cs)
                state.ema_w[i].copy_(ew)
                cb.copy_(ew / cs[:, None])
        qs.append(cb[idx])
        perp = perp + _perplexity(oh)
        idxs.append(idx.reshape(B, T))
    q = torch.cat(qs, dim=1).reshape(B, T, D)
    vq_loss = beta * (q.detach() - z).square().mean()
    q_st = z + (q - z).detach()
    return q_st, vq_loss, perp, torch.stack(idxs, dim=-1)


def update_usage(usage: torch.Tensor, counts: torch.Tensor, decay: float) -> torch.Tensor:
    """EMA of the per-code assignment fraction; ``counts`` is the batch's
    mean one-hot (sums to 1)."""
    return usage * decay + (1.0 - decay) * counts


def reseed_slice(codebook: torch.Tensor, usage: torch.Tensor, z_slice: torch.Tensor, thresh: float, active: bool,
                 *, cand_idx: torch.Tensor):
    """Revive dead codes: rows whose usage EMA is below ``thresh/K`` (when
    ``active``, a bool or a 0-dim bool tensor) become encoder outputs
    ``z_slice[cand_idx]`` (K indices: the JAX step draws ``randint(key,
    (K,), 0, N)``), and their usage is reset to 1/K. Returns (new_codebook,
    new_usage, dead mask)."""
    K = codebook.shape[0]
    dead = (usage < thresh / K) & active
    cand = z_slice[cand_idx.to(z_slice.device).long()].to(codebook.dtype)
    new_cb = torch.where(dead[:, None], cand, codebook)
    new_usage = torch.where(dead, torch.full_like(usage, 1.0 / K), usage)
    return new_cb, new_usage, dead


class Gumbel(nn.Module):
    """Per slice a logits head ``heads.{i}`` (D/slices -> k) and a code table
    ``codes.{i}`` (k, D/slices), N(0, 0.01²); slice i draws from keys 2i
    and 2i + 1 of the 2·slices split from ``key`` (JAX ``gumbel_init``)."""

    def __init__(self, D: int, k: int, slices: int = 4, *, key: torch.Tensor):
        super().__init__()
        assert D % slices == 0
        sub = D // slices
        keys = jr.split(key, 2 * slices)
        self.heads = nn.ModuleList(Linear(sub, k, key=keys[2 * i]) for i in range(slices))
        self.codes = nn.ParameterList(0.01 * jr.normal(keys[2 * i + 1], (k, sub)) for i in range(slices))


def gumbel_apply(p: Gumbel, z: torch.Tensor, *, tau: float = 0.1, hard: bool = False, train: bool = True,
                 key: torch.Tensor | None = None):
    """Gumbel-softmax pick of one code per slice; straight-through when
    ``hard``; the argmax one-hot outside training. The training noise of
    slice i is ``uniform(sk, (B, T, k), 1e-10, 1)`` after ``key, sk =
    split(key)`` (JAX ``gumbel_apply``).
    Returns (quantized, aux_loss=0, perplexity summed over slices, indices
    (B, T, slices))."""
    B, T, D = z.shape
    n = len(p.codes)
    sub = D // n
    outs, idxs, perp = [], [], 0.0
    for i in range(n):
        logits = linear_apply(p.heads[i], z[:, :, i * sub : (i + 1) * sub])
        if train:
            if key is None:
                raise ValueError("Gumbel noise in training needs a key")
            key, sk = jr.split(key)
            rows_all, rows = dist.global_batch_rows(B)
            u = jr.uniform(sk, (rows_all, *logits.shape[1:]), 1e-10, 1.0, rows=rows)
            w = torch.softmax((logits - torch.log(-torch.log(u))) / tau, dim=-1)
        else:
            w = F.one_hot(logits.argmax(-1), logits.shape[-1]).to(logits.dtype)
        idx = w.argmax(-1)
        one_hot = F.one_hot(idx, w.shape[-1]).to(w.dtype)
        if hard and train:
            w = w + (one_hot - w).detach()
        outs.append(w @ p.codes[i])
        perp = perp + _perplexity(one_hot.reshape(-1, w.shape[-1]))
        idxs.append(idx)
    return torch.cat(outs, -1), z.new_zeros(()), perp, torch.stack(idxs, -1)


def _var(z: torch.Tensor) -> torch.Tensor:
    """The biased variance over time as ``jnp.var`` computes it, the mean of
    the squared deviations, so that autograd differentiates through the
    inner mean as JAX does: that term is zero in exact arithmetic and
    cancels the rounding of the deviations' sum, which torch's own ``var``
    backward leaves in (measured: 40x the JAX gradient's error on a bias
    in front of the instance norm, whose gradient is zero)."""
    return (z - z.mean(1, keepdim=True)).square().mean(1, keepdim=True)


def instance_norm(z: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Per-utterance, per-channel normalization over time with the biased
    variance (``jnp.var``; torch InstanceNorm1d, affine=False)."""
    mean = z.mean(1, keepdim=True)
    return (z - mean) / torch.sqrt(_var(z) + eps)


def adain(content: torch.Tensor, style: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Re-style IN(content) with the style utterance's channel statistics."""
    s_mean = style.mean(1, keepdim=True)
    s_std = torch.sqrt(_var(style) + eps)
    return instance_norm(content, eps) * s_std + s_mean


def _jitter_bounds(prob, per_side: bool):
    """The f32 thresholds (p, 1 − p) of ``u < p`` and ``u > 1 − p``, as JAX
    computes them: for a Python float ``prob`` in float64, each rounded to
    f32 where it meets the f32 uniforms; for an ``np.float32`` or a 0-dim
    f32 tensor (JAX's traced f32 ``prob·gate`` under ``time_jitter_start``)
    in f32, the tensor's on its device."""
    if torch.is_tensor(prob):
        p = prob if per_side else prob / 2.0
        return p, 1.0 - p
    if isinstance(prob, np.float32):
        p = prob if per_side else prob / np.float32(2.0)
        return float(p), float(np.float32(1.0) - p)
    p = prob if per_side else prob / 2.0
    return float(np.float32(p)), float(np.float32(1.0 - p))


def time_jitter(z: torch.Tensor, prob=0.12, per_side: bool = True, *, u: torch.Tensor | None = None,
                key: torch.Tensor | None = None) -> torch.Tensor:
    """Chorowski time jitter, from the uniforms ``u`` (B, T'), drawn as
    ``uniform(key, (B, T'))`` unless given. per_side=True: each frame is
    replaced by its left / right neighbour with probability ``prob`` each;
    False: with total probability ``prob``, direction uniform. ``prob`` is a
    Python float, an ``np.float32`` or a 0-dim f32 tensor (see
    :func:`_jitter_bounds`)."""
    B, T, D = z.shape
    if u is None:
        if key is None:
            raise ValueError("time jitter needs a key or its uniforms")
        rows_all, rows = dist.global_batch_rows(B)
        u = jr.uniform(key, (rows_all, T), rows=rows)
    u = u.to(z.device)
    lo, hi = _jitter_bounds(prob, per_side)
    zero = torch.zeros_like(u, dtype=torch.long)
    shift = torch.where(u < lo, zero - 1, torch.where(u > hi, zero + 1, zero))
    idx = (torch.arange(T, device=z.device)[None, :] + shift).clamp(0, T - 1)
    return torch.gather(z, 1, idx[:, :, None].expand(B, T, D))


def vq_dropout(z: torch.Tensor, drop_dim: int, *, start: torch.Tensor | None = None,
               key: torch.Tensor | None = None) -> torch.Tensor:
    """VQ-dropout: zero ``drop_dim`` contiguous latent channels from
    ``start`` (B, 1) per utterance (``randint(key, (B, 1), 0, D − drop_dim +
    1)`` unless given) and rescale the rest by D / (D − drop_dim)."""
    B, T, D = z.shape
    if drop_dim <= 0:
        return z
    if start is None:
        if key is None:
            raise ValueError("VQ-dropout needs a key or its start channels")
        rows_all, rows = dist.global_batch_rows(B)
        start = jr.randint(key, (rows_all, 1), 0, D - drop_dim + 1, rows=rows)
    start = start.to(z.device)
    ch = torch.arange(D, device=z.device)[None, :]
    keep = ~((ch >= start) & (ch < start + drop_dim))
    return z * keep[:, None, :] * (D / float(D - drop_dim))
