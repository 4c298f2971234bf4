"""Feature-space (MFCC-only) autoencoders (counterpart of
``wavenet_autoencoders_tpu/models/mfcc_ae.py``):

- ``MfccAE``    — the content encoder and a mirror decoder over MFCC frames,
  trained on the MSE of the reconstructed features; ``downsample`` 1, 2 or
  4 gives 100, 50 or 25 Hz representations;
- ``CatMfccAE`` — the same with a Gumbel-softmax categorical bottleneck.

They have no waveform decoder: they serve ABX export only. Parameters
``encoder``, ``decoder`` (``lin``, ``blocks.{0,1}``, ``out``) and, for
CatMfccAE, ``gumbel``.
"""
from __future__ import annotations

import torch
from torch import nn

from wavenet_autoencoders_tpu_torch.models import bottlenecks as bn
from wavenet_autoencoders_tpu_torch.models.encoder import Encoder, _block_apply
from wavenet_autoencoders_tpu_torch.ops.conv import Conv1d, Linear, linear_apply
from wavenet_autoencoders_tpu_torch.utils import jax_random as jr


class _FeatDecoder(nn.Module):
    def __init__(self, hid: int, enc_hid: int, c_in: int, keys):
        super().__init__()
        self.lin = Linear(hid, enc_hid, key=keys[0])
        self.blocks = nn.ModuleList(Conv1d(enc_hid, enc_hid, 3, bias=True, key=keys[i]) for i in (1, 2))
        self.out = Linear(enc_hid, c_in, key=keys[3])


class MfccAE(nn.Module):
    """Five keys split from ``key``: the encoder's, then the decoder's
    ``lin``, ``blocks.0``, ``blocks.1`` and ``out`` (JAX ``MfccAE.init``)."""

    def __init__(self, c_in: int = 39, hid: int = 64, enc_hid: int = 256, downsample: int = 1, *,
                 key: torch.Tensor):
        super().__init__()
        self.c_in, self.hid, self.enc_hid, self.downsample = c_in, hid, enc_hid, downsample
        keys = jr.split(key, 5)
        self.encoder = Encoder(c_in=c_in, hid=enc_hid, c_out=hid, downsample=downsample, key=keys[0])
        self.decoder = _FeatDecoder(hid, enc_hid, c_in, keys[1:])

    def encode(self, c, tar_c=None, dtype=None):
        return self.encoder.apply(c, dtype=dtype)

    def _decode_feat(self, z, dtype=None):
        h = linear_apply(self.decoder.lin, z, dtype=dtype)
        if self.downsample > 1:
            h = h.repeat_interleave(self.downsample, dim=1)
        for p in self.decoder.blocks:
            h = _block_apply(p, h, 3, 1, residual=True, dtype=dtype)
        return linear_apply(self.decoder.out, h, dtype=dtype)

    def forward(self, x, c, g, *, train: bool = True, dtype=None, key=None):
        """The reconstruction target is ``c`` itself; ``x`` and ``g`` are
        ignored. Returns (c_hat, aux_loss=0, perplexity=0)."""
        c_hat = self._decode_feat(self.encode(c, dtype=dtype), dtype=dtype)
        zero = c_hat.new_zeros((), dtype=torch.float32)
        return c_hat, zero, zero


class CatMfccAE(MfccAE):
    """MfccAE's draws from ``key``, the bottleneck's from ``fold_in(key, 99)``."""

    def __init__(self, c_in: int = 39, hid: int = 64, enc_hid: int = 256, downsample: int = 1, *,
                 k: int = 128, tau: float = 0.1, hard: bool = False, slices: int = 4, key: torch.Tensor):
        super().__init__(c_in, hid, enc_hid, downsample, key=key)
        self.k, self.tau, self.hard, self.slices = k, tau, hard, slices
        self.gumbel = bn.Gumbel(hid, k, slices, key=jr.fold_in(key, 99))

    def encode(self, c, tar_c=None, dtype=None):
        z = self.encoder.apply(c, dtype=dtype)
        return bn.gumbel_apply(self.gumbel, z, tau=self.tau, hard=self.hard, train=False)[0]

    def forward(self, x, c, g, *, train: bool = True, dtype=None, key=None):
        """The Gumbel noise from ``sk`` of ``key, sk = split(key)`` (JAX
        ``CatMfccAE.forward``)."""
        z = self.encoder.apply(c, dtype=dtype)
        sk = None if key is None else jr.split(key)[1]
        q, aux, perp, _ = bn.gumbel_apply(self.gumbel, z, tau=self.tau, hard=self.hard, train=train, key=sk)
        return self._decode_feat(q, dtype=dtype), aux, perp
