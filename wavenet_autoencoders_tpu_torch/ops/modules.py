"""Embedding + gated residual block (the WaveNet cell).

Counterpart of ``wavenet_autoencoders_tpu/ops/modules.py``:

- ``residual_glu_apply``: teacher-forced batch mode over (B, T, C);
- ``residual_glu_step``: one AR step with a (k-1)·d-slot ring buffer per
  layer that is read before it is written.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from wavenet_autoencoders_tpu_torch.ops.conv import (
    WNConv1d,
    causal_conv1d_apply,
    conv1d_apply,
    conv1d_weight,
)
from wavenet_autoencoders_tpu_torch.parallel.distributed import copy_to_model


class Embedding(nn.Module):
    """N(0, std) embedding table ``table`` (num, dim)."""

    def __init__(self, num: int, dim: int, std: float = 0.01, generator=None):
        super().__init__()
        self.table = nn.Parameter(std * torch.randn(num, dim, generator=generator))


class ResidualGLU(nn.Module):
    """Parameters of one ResidualConv1dGLU: ``conv``, ``out``, ``skip`` and
    the optional ``cproj`` / ``gproj`` conditioning projections."""

    def __init__(
        self,
        residual_channels: int,
        gate_channels: int,
        kernel_size: int,
        skip_out_channels: int | None = None,
        cin_channels: int = -1,
        gin_channels: int = -1,
        bias: bool = True,
        generator=None,
    ):
        super().__init__()
        if skip_out_channels is None:
            skip_out_channels = residual_channels
        gate_out = gate_channels // 2
        gen = generator
        self.conv = WNConv1d(residual_channels, gate_channels, kernel_size, bias, gen)
        self.out = WNConv1d(gate_out, residual_channels, 1, bias, gen)
        self.skip = WNConv1d(gate_out, skip_out_channels, 1, bias, gen)
        self.cproj = WNConv1d(cin_channels, gate_channels, 1, False, gen) if cin_channels > 0 else None
        self.gproj = WNConv1d(gin_channels, gate_channels, 1, False, gen) if gin_channels > 0 else None


def _gate(x, c_add, g_add):
    # first half -> tanh, second half -> sigmoid; c/g addends per half
    if c_add is not None:
        x = x + c_add
    if g_add is not None:
        x = x + g_add
    half = x.shape[-1] // 2
    return torch.tanh(x[..., :half]) * torch.sigmoid(x[..., half:])


def residual_glu_apply(
    p: ResidualGLU,
    x: torch.Tensor,
    c: torch.Tensor | None = None,
    g: torch.Tensor | None = None,
    *,
    dilation: int = 1,
    dropout: float = 0.0,
    generator: torch.Generator | None = None,
    mask: torch.Tensor | None = None,
    dtype=None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (B, T, residual); c: (B, T, cin) or None; g: (B, gin) or
    (B, T, gin). Returns (residual_out, skip) with the sqrt(0.5) residual
    scaling. ``dtype`` is the compute dtype of the convs; ``dropout`` is the
    training-time rate (the caller passes 0 outside training): the conv's
    input is x times a Bernoulli(1 - dropout) keep mask over 1 - dropout,
    the residual stays x. The mask is ``mask`` when given, else drawn from
    ``generator`` (uniform < 1 - dropout, the JAX draw).

    Tensor parallel (``parallel.mesh``: ``conv``, ``cproj``, ``gproj``
    column-parallel per gate half, ``out``/``skip`` row-parallel): x is
    replicated and passes into the conv through ``copy_to_model`` (the mask
    acts on the replicated x, so every model rank draws the same one); c and
    g must come through ``copy_to_model`` from the caller (once for the
    whole stack); the local gate halves give this rank's columns of the
    gated activation, and the out/skip products are summed over the model
    group before their replicated biases."""
    residual = x
    if dropout > 0.0:
        keep = 1.0 - dropout
        if mask is None:
            if generator is None:
                raise ValueError("dropout needs a mask or a torch.Generator to draw it from")
            mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
        x = x * mask.to(x.dtype) / keep
    if getattr(p.conv, "tp", None):
        x = copy_to_model(x)
    h = causal_conv1d_apply(p.conv, x, dilation=dilation, dtype=dtype)
    c_add = conv1d_apply(p.cproj, c, dtype=dtype) if c is not None else None
    g_add = None
    if g is not None:
        if g.ndim == 2:
            g = g[:, None, :]
        g_add = conv1d_apply(p.gproj, g, dtype=dtype)
    gated = _gate(h, c_add, g_add)
    s = conv1d_apply(p.skip, gated, dtype=dtype)
    out = (conv1d_apply(p.out, gated, dtype=dtype) + residual) * math.sqrt(0.5)
    return out, s


def glu_buffer_len(kernel_size: int, dilation: int) -> int:
    """Ring-buffer slots a layer needs: (k-1)*d past inputs."""
    return (kernel_size - 1) * dilation


def residual_glu_step(
    p: ResidualGLU,
    x_t: torch.Tensor,
    buf: torch.Tensor,
    t: int,
    ct: torch.Tensor | None = None,
    gt: torch.Tensor | None = None,
    *,
    dilation: int = 1,
    kernel_size: int = 3,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One AR step. x_t: (B, C); buf: (B, (k-1)·d, C) ring; t: step index.
    Returns (out, skip, buf).

    Tap x_{t-j·d} lives at slot (t - j·d) mod len; x_t is written to slot
    t mod len after the reads. Unlike the JAX version, which returns a new
    buffer, the write is in place and the same tensor is returned.
    """
    n = glu_buffer_len(kernel_size, dilation)
    w = conv1d_weight(p.conv)  # (k, Cin, Cgate)
    h = x_t @ w[kernel_size - 1]
    for j in range(1, kernel_size):
        h = h + buf[:, (t - j * dilation) % n] @ w[kernel_size - 1 - j]
    if p.conv.b is not None:
        h = h + p.conv.b
    c_add = ct @ conv1d_weight(p.cproj)[0] if ct is not None else None
    g_add = gt @ conv1d_weight(p.gproj)[0] if gt is not None else None
    gated = _gate(h, c_add, g_add)

    s = gated @ conv1d_weight(p.skip)[0]
    if p.skip.b is not None:
        s = s + p.skip.b
    out = gated @ conv1d_weight(p.out)[0]
    if p.out.b is not None:
        out = out + p.out.b
    out = (out + x_t) * math.sqrt(0.5)
    buf[:, t % n] = x_t.to(buf.dtype)
    return out, s, buf
