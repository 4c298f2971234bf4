"""Conditioning upsampler: nearest-neighbour stretch + weight-normed
smoothing convolutions (counterpart of
``wavenet_autoencoders_tpu/ops/upsample.py``).

One (stretch, conv) pair per scale; each smoothing conv is a 2-D conv over
the (C, T) "image" with one in/out channel and kernel (freq_ks, 2·scale+1).
Its ``g`` is a scalar and its norm is taken over the whole kernel.
``ConvInUpsample`` prepends a plain context conv of kernel 2·cin_pad+1
(VALID padding, no bias).
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from wavenet_autoencoders_tpu_torch.kernels.upsample import upsample
from wavenet_autoencoders_tpu_torch.ops.conv import Conv1d, conv1d_apply
from wavenet_autoencoders_tpu_torch.utils import jax_random as jr


class SmoothingConv(nn.Module):
    """Weight-normed 2-D conv ``g`` () and ``v`` (1, 1, freq_ks, 2s+1),
    weights filled with 1/prod(kernel)."""

    def __init__(self, scale: int, freq_ks: int, device=None):
        super().__init__()
        k = (freq_ks, 2 * scale + 1)
        v = torch.full((1, 1) + k, 1.0 / float(np.prod(k)), device=device)
        self.g = nn.Parameter(v.square().sum().sqrt())
        self.v = nn.Parameter(v)


class UpsampleNetwork(nn.Module):
    """The smoothing convs draw nothing: ``key`` only sets their device."""

    def __init__(self, upsample_scales, freq_axis_kernel_size: int = 1, *, key: torch.Tensor):
        super().__init__()
        self.convs = nn.ModuleList(
            SmoothingConv(s, freq_axis_kernel_size, key.device) for s in upsample_scales
        )


class ConvInUpsample(nn.Module):
    """The context conv from the first of two keys split from ``key`` (JAX
    ``conv_in_upsample_init``)."""

    def __init__(self, cin_channels, cin_pad, upsample_scales, freq_axis_kernel_size=1, *, key: torch.Tensor):
        super().__init__()
        k1, k2 = jr.split(key)
        self.conv_in = Conv1d(cin_channels, cin_channels, 2 * cin_pad + 1, bias=False, key=k1)
        self.upsample = UpsampleNetwork(upsample_scales, freq_axis_kernel_size, key=k2)


def upsample_network_apply(
    p: UpsampleNetwork,
    c: torch.Tensor,
    upsample_scales,
    freq_axis_kernel_size: int = 1,
    cin_pad: int = 0,
    dtype=None,
) -> torch.Tensor:
    """c: (B, T0, C) -> (B, T0 * prod(scales) - 2*cin_pad*prod, C). Under a
    compute ``dtype`` the input and every smoothing weight are cast to it and
    each conv's output stays in it. The chain runs in ``kernels/upsample.py``
    (the CUDA kernels on the card, the plain version on the CPU) on the
    folded weights; the weight norm stays here, in autograd."""
    x = c if dtype is None else c.to(dtype)
    ws = []
    for conv in p.convs:
        w = conv.g * conv.v / conv.v.square().sum().sqrt().clamp_min(1e-12)
        ws.append(w if dtype is None else w.to(dtype))
    indent = cin_pad * int(np.prod(upsample_scales))
    return upsample(x, ws, upsample_scales, freq_axis_kernel_size, indent)


def conv_in_upsample_apply(
    p: ConvInUpsample,
    c: torch.Tensor,
    upsample_scales,
    freq_axis_kernel_size: int = 1,
    dtype=None,
) -> torch.Tensor:
    """c: (B, T0, C) -> (B, (T0 - 2*cin_pad) * prod(scales), C)."""
    h = conv1d_apply(p.conv_in, c, padding="VALID", dtype=dtype)
    return upsample_network_apply(p.upsample, h, upsample_scales, freq_axis_kernel_size, dtype=dtype)
