"""Convolutional content and speaker encoders (counterpart of
``wavenet_autoencoders_tpu/models/encoder.py``).

The content encoder is a 10-block Conv-ReLU stack with identity residuals
(stride 1 and matching widths) and k5/s2 temporal downsampling blocks, then
a linear projection; the number of stride-2 blocks is log2(downsample).
The speaker encoder (NewINWAE's continuous speaker code) is three conv
blocks, a mean pool over time and a linear projection.

Tensor parallel (``parallel.mesh``): the blocks the rules shard are
column-parallel (their replicated input passes through ``copy_to_model``)
and their channel shards are gathered before the next block, where the
identity residual is added to the full tensor; the last block's output
stays sharded (its residual is this rank's channels of the input) into the
row-parallel ``lin``, whose partial products are summed over the model
group before its replicated bias.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from wavenet_autoencoders_tpu_torch.ops.conv import Conv1d, Linear, conv1d_apply, linear_apply
from wavenet_autoencoders_tpu_torch.parallel.distributed import copy_to_model, gather_from_model, model_index
from wavenet_autoencoders_tpu_torch.utils import jax_random as jr


def _block_apply(p, x, k, stride, residual, dtype=None, gather=True):
    # torch-style padding k//2 both sides, strided conv, ReLU, residual
    # AFTER the ReLU; a column-parallel block returns the full channels
    # when ``gather``, else this rank's (and adds its channels of x)
    pad = k // 2
    col = getattr(p, "tp", None) == "col"
    xin = copy_to_model(x) if col else x
    out = F.relu(conv1d_apply(p, xin, stride=stride, padding=[(pad, pad)], dtype=dtype))
    if col:
        if gather:
            out = gather_from_model(out)
        elif residual:
            # a slice of the replicated x: its gradient, too, sums over the ranks
            w, m = out.shape[-1], model_index()
            x = xin[..., m * w : (m + 1) * w]
    if residual:
        out = out + x
    return out


class Encoder(nn.Module):
    """Parameters ``blocks.{i}.w|b`` and ``lin.w|b``, drawn from the keys
    split from ``key``: one a block, then ``lin`` (JAX ``Encoder.init``)."""

    def __init__(self, c_in: int = 39, hid: int = 768, c_out: int = 64,
                 downsample: int = 4, *, key: torch.Tensor):
        super().__init__()
        self.c_in, self.hid, self.c_out, self.downsample = c_in, hid, c_out, downsample
        specs = self._blocks()
        keys = jr.split(key, len(specs) + 1)
        blocks, cin = [], c_in
        for i, (k, _s) in enumerate(specs):
            blocks.append(Conv1d(cin, hid, k, bias=True, key=keys[i]))
            cin = hid
        self.blocks = nn.ModuleList(blocks)
        self.lin = Linear(hid, c_out, key=keys[-1])

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
        h, cin, last = x, self.c_in, len(self.blocks) - 1
        for i, (p, (k, s)) in enumerate(zip(self.blocks, self._blocks())):
            h = _block_apply(p, h, k, s, residual=(s == 1 and cin == self.hid), dtype=dtype, gather=i < last)
            if per_block is not None:
                h = per_block(h)
            cin = self.hid
        return linear_apply(self.lin, h, dtype=dtype)

    forward = apply


class SpeakerEncoder(nn.Module):
    """Utterance-level speaker code: parameters ``blocks.{0,1,2}.w|b`` (k=3)
    and ``lin.w|b``, from four keys split from ``key``."""

    def __init__(self, c_in: int = 39, hid: int = 128, c_out: int = 64, *, key: torch.Tensor):
        super().__init__()
        keys = jr.split(key, 4)
        self.blocks = nn.ModuleList(
            Conv1d(cin, hid, 3, bias=True, key=keys[i]) for i, cin in enumerate((c_in, hid, hid))
        )
        self.lin = Linear(hid, c_out, key=keys[3])

    def apply(self, x: torch.Tensor, dtype=None) -> torch.Tensor:
        """x: (B, T, c_in) -> (B, c_out)."""
        h = x
        for i, p in enumerate(self.blocks):
            h = _block_apply(p, h, 3, 1, residual=i > 0, dtype=dtype, gather=i < len(self.blocks) - 1)
        return linear_apply(self.lin, h.mean(1), dtype=dtype)

    forward = apply
