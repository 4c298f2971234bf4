"""The bottlenecks of the model zoo (counterpart of
``wavenet_autoencoders_tpu/models/bottlenecks.py:35-141,263-336``):

- plain VQ with the reference's swapped-β loss (β weights the
  codebook-to-encoder term);
- sliced VQ with the standard loss form and perplexity summed over slices;
- the Gumbel-softmax categorical bottleneck (CatWAE, CatMfccAE);
- instance norm and AdaIN.

z is (B, T', D) throughout. ``.detach()`` stands for ``stop_gradient``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from wavenet_autoencoders_tpu_torch.ops.conv import Linear, linear_apply


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


def _perplexity(one_hot: torch.Tensor) -> torch.Tensor:
    avg = one_hot.float().mean(0)
    return torch.exp(-(avg * torch.log(avg + 1e-10)).sum())


def _uniform_codebook(K, D, generator=None):
    return (torch.rand(K, D, generator=generator) * 2.0 - 1.0) / K


class VQ(nn.Module):
    """Plain VQ: ``codebook`` (K, D)."""

    def __init__(self, K: int, D: int, generator=None):
        super().__init__()
        self.codebook = nn.Parameter(_uniform_codebook(K, D, generator))


class SlicedVQ(nn.Module):
    """Sliced VQ: ``codebooks.{i}`` (K_i, D/num_slices)."""

    def __init__(self, K: int, D: int, num_slices: int = 2, K1: int | None = None, generator=None):
        super().__init__()
        assert D % num_slices == 0
        sub = D // num_slices
        self.codebooks = nn.ParameterList(
            _uniform_codebook(s, sub, generator) for s in _slice_sizes(K, K1, num_slices)
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


class Gumbel(nn.Module):
    """Per slice a logits head ``heads.{i}`` (D/slices -> k) and a code table
    ``codes.{i}`` (k, D/slices), N(0, 0.01²)."""

    def __init__(self, D: int, k: int, slices: int = 4, generator=None):
        super().__init__()
        assert D % slices == 0
        sub = D // slices
        self.heads = nn.ModuleList(Linear(sub, k, generator=generator) for _ in range(slices))
        self.codes = nn.ParameterList(0.01 * torch.randn(k, sub, generator=generator) for _ in range(slices))


def gumbel_apply(p: Gumbel, z: torch.Tensor, *, tau: float = 0.1, hard: bool = False, train: bool = True,
                 generator: torch.Generator | None = None, uniforms=None):
    """Gumbel-softmax pick of one code per slice; straight-through when
    ``hard``; the argmax one-hot outside training. The training noise comes
    from ``uniforms`` (one (B, T, k) tensor in [1e-10, 1) per slice) when
    given, else from ``generator``. Returns (quantized, aux_loss=0,
    perplexity summed over slices, indices (B, T, slices))."""
    B, T, D = z.shape
    n = len(p.codes)
    sub = D // n
    outs, idxs, perp = [], [], 0.0
    for i in range(n):
        logits = linear_apply(p.heads[i], z[:, :, i * sub : (i + 1) * sub])
        if train:
            if uniforms is not None:
                u = uniforms[i]
            else:
                u = torch.rand(logits.shape, generator=generator, device=logits.device) * (1.0 - 1e-10) + 1e-10
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


def instance_norm(z: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Per-utterance, per-channel normalization over time with the biased
    variance (``jnp.var``; torch InstanceNorm1d, affine=False)."""
    mean = z.mean(1, keepdim=True)
    var = z.var(1, keepdim=True, correction=0)
    return (z - mean) / torch.sqrt(var + eps)


def adain(content: torch.Tensor, style: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Re-style IN(content) with the style utterance's channel statistics."""
    s_mean = style.mean(1, keepdim=True)
    s_std = torch.sqrt(style.var(1, keepdim=True, correction=0) + eps)
    return instance_norm(content, eps) * s_std + s_mean
