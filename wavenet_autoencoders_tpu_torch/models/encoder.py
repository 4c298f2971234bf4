"""Convolutional content and speaker encoders (counterpart of
``wavenet_autoencoders_tpu/models/encoder.py``).

The content encoder is a 10-block Conv-ReLU stack with identity residuals
(stride 1 and matching widths) and k5/s2 temporal downsampling blocks, then
a linear projection; the number of stride-2 blocks is log2(downsample).
The speaker encoder (NewINWAE's continuous speaker code) is three conv
blocks, a mean pool over time and a linear projection.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from wavenet_autoencoders_tpu_torch.ops.conv import Conv1d, Linear, conv1d_apply, linear_apply


def _block_apply(p, x, k, stride, residual, dtype=None):
    # torch-style padding k//2 both sides, strided conv, ReLU, residual
    # AFTER the ReLU
    pad = k // 2
    out = F.relu(conv1d_apply(p, x, stride=stride, padding=[(pad, pad)], dtype=dtype))
    if residual:
        out = out + x
    return out


class Encoder(nn.Module):
    """Parameters ``blocks.{i}.w|b`` and ``lin.w|b``."""

    def __init__(self, c_in: int = 39, hid: int = 768, c_out: int = 64,
                 downsample: int = 4, generator=None):
        super().__init__()
        self.c_in, self.hid, self.c_out, self.downsample = c_in, hid, c_out, downsample
        blocks, cin = [], c_in
        for k, _s in self._blocks():
            blocks.append(Conv1d(cin, hid, k, bias=True, generator=generator))
            cin = hid
        self.blocks = nn.ModuleList(blocks)
        self.lin = Linear(hid, c_out, generator=generator)

    def _blocks(self):
        """(kernel, stride) per block."""
        n_ds = {1: 0, 2: 1, 4: 2}[self.downsample]
        specs = [(3, 1), (3, 1)]
        specs += [(5, 2)] * n_ds + [(5, 1)] * (2 - n_ds)
        specs += [(3, 1), (3, 1)] + [(1, 1)] * 4
        return specs

    def apply(self, x: torch.Tensor, dtype=None, per_block=None) -> torch.Tensor:
        """x: (B, T, c_in) -> (B, T/downsample, c_out); ``dtype`` is the
        compute dtype of the convs and the projection. ``per_block``, when
        given, runs on every block's output (INAE1's instance norm)."""
        h, cin = x, self.c_in
        for p, (k, s) in zip(self.blocks, self._blocks()):
            h = _block_apply(p, h, k, s, residual=(s == 1 and cin == self.hid), dtype=dtype)
            if per_block is not None:
                h = per_block(h)
            cin = self.hid
        return linear_apply(self.lin, h, dtype=dtype)

    forward = apply


class SpeakerEncoder(nn.Module):
    """Utterance-level speaker code: parameters ``blocks.{0,1,2}.w|b`` (k=3)
    and ``lin.w|b``."""

    def __init__(self, c_in: int = 39, hid: int = 128, c_out: int = 64, generator=None):
        super().__init__()
        self.blocks = nn.ModuleList(
            Conv1d(cin, hid, 3, bias=True, generator=generator) for cin in (c_in, hid, hid)
        )
        self.lin = Linear(hid, c_out, generator=generator)

    def apply(self, x: torch.Tensor, dtype=None) -> torch.Tensor:
        """x: (B, T, c_in) -> (B, c_out)."""
        h = x
        for i, p in enumerate(self.blocks):
            h = _block_apply(p, h, 3, 1, residual=i > 0, dtype=dtype)
        return linear_apply(self.lin, h.mean(1), dtype=dtype)

    forward = apply
