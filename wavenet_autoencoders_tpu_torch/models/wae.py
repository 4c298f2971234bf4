"""The WaveNet-autoencoder model zoo (counterpart of
``wavenet_autoencoders_tpu/models/wae.py``):

- ``WVAE``     — continuous bottleneck (AE);
- ``VQWAE``    — plain or sliced VQ, instance norm, AdaIN, post-conv;
- ``INWAE``    — instance-norm AE (INAE; INAE1 with ``per_block_in``),
                 speaker-id embedding, AdaIN voice conversion from a
                 target-speaker utterance (``tar_c``);
- ``NewINWAE`` — like INWAE, but the decoder's global conditioning is a
                 continuous speaker code from a ``SpeakerEncoder``;
- ``CatWAE``   — Gumbel-softmax categorical bottleneck;
- ``Vocoder``  — the plain WaveNet vocoder, conditioned on the features.

The port's models hold their weights, so ``encode(c, tar_c=None)``,
``decode(c, ...)`` and the training ``forward(x, c, g, *, train, dtype)``
(-> ``(y_hat, aux_loss, perplexity)``) take no params/state arguments;
stochastic families take ``generator=`` (and ``uniforms=``, the injected
noise) in ``forward``. EMA codebooks are not ported yet and raise here; the
other training-only bottleneck options (dead-code revival, time jitter,
VQ-dropout) are refused by ``train.step.check_ported``. All activations
are (B, T, C).
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from wavenet_autoencoders_tpu_torch.models import bottlenecks as bn
from wavenet_autoencoders_tpu_torch.models.encoder import Encoder, SpeakerEncoder
from wavenet_autoencoders_tpu_torch.models.wavenet import WaveNet
from wavenet_autoencoders_tpu_torch.ops.conv import Conv1d, conv1d_apply


class WAEBase(nn.Module):
    def __init__(self, wavenet: WaveNet, c_in: int = 39, hid: int = 64,
                 frame_rate: int = 25, encoder_hid: int = 768, generator=None):
        super().__init__()
        self.c_in, self.hid, self.frame_rate, self.encoder_hid = c_in, hid, frame_rate, encoder_hid
        self.encoder = Encoder(c_in=c_in, hid=encoder_hid, c_out=hid,
                               downsample=self.downsample, generator=generator)
        self.wavenet = wavenet

    @property
    def downsample(self) -> int:
        return 100 // self.frame_rate

    def _up_factor(self) -> int:
        return int(np.prod(self.wavenet.upsample_scales))

    @torch.no_grad()
    def decode(self, c, g=None, T=None, tar_c=None, **kw):
        """AR generation conditioned on features c (B, T', c_in) through the
        plain ``WaveNet.decode``. Default T accounts for the
        2·cin_pad·prod(scales) context trim of the conditioning upsampler."""
        lat = self.encode(c, tar_c=tar_c)
        if T is None:
            if not self.wavenet.upsample_conditional_features:
                raise ValueError(
                    "pass T explicitly when upsample_conditional_features is "
                    "off (T = latent frames * sample_rate // frame_rate; see "
                    "eval.synthesize.batch_wavegen)"
                )
            T = (lat.shape[1] - 2 * self.wavenet.cin_pad) * self._up_factor()
        return self.wavenet.decode(T, c=lat, g=g, **kw)


def _no_aux(like: torch.Tensor):
    """The aux loss and perplexity of a family without a quantizer."""
    zero = like.new_zeros((), dtype=torch.float32)
    return zero, zero


class WVAE(WAEBase):
    """Continuous bottleneck: the encoder output conditions the decoder."""

    def encode(self, c, tar_c=None, dtype=None):
        return self.encoder.apply(c, dtype=dtype)

    def forward(self, x, c, g, *, train: bool = True, dtype=None):
        y_hat = self.wavenet.apply(x, self.encode(c, dtype=dtype), g, train=train, dtype=dtype)
        return (y_hat, *_no_aux(y_hat))


class INWAE(WAEBase):
    """Instance norm on the latent; with ``per_block_in`` (INAE1) also after
    every encoder block. With ``adain`` and a target utterance, ``encode``
    re-styles the code with the target's channel statistics."""

    def __init__(self, wavenet: WaveNet, c_in=39, hid=64, frame_rate=25, encoder_hid=768, *,
                 adain=True, per_block_in=False, generator=None):
        super().__init__(wavenet, c_in, hid, frame_rate, encoder_hid, generator=generator)
        self.adain, self.per_block_in = adain, per_block_in

    def _encode_raw(self, c, dtype=None):
        return self.encoder.apply(c, dtype=dtype, per_block=bn.instance_norm if self.per_block_in else None)

    def encode(self, c, tar_c=None, dtype=None):
        z = self._encode_raw(c, dtype=dtype)
        if tar_c is not None and self.adain:
            return bn.adain(z, self._encode_raw(tar_c, dtype=dtype))
        return bn.instance_norm(z)

    def forward(self, x, c, g, *, train: bool = True, dtype=None):
        y_hat = self.wavenet.apply(x, self.encode(c, dtype=dtype), g, train=train, dtype=dtype)
        return (y_hat, *_no_aux(y_hat))


class NewINWAE(WAEBase):
    """IN latent; the decoder's global conditioning (gin = 64, no id
    embedding) is ``speaker_code(c)``, so ``forward`` ignores ``g``.
    Parameters ``encoder``, ``spk``, ``wavenet``."""

    def __init__(self, wavenet: WaveNet, c_in=39, hid=64, frame_rate=25, encoder_hid=768, *,
                 speaker_hid=128, generator=None):
        super().__init__(wavenet, c_in, hid, frame_rate, encoder_hid, generator=generator)
        self.spk = SpeakerEncoder(c_in=c_in, hid=speaker_hid, c_out=wavenet.gin_channels, generator=generator)

    def speaker_code(self, c, dtype=None):
        return self.spk.apply(c, dtype=dtype)

    def encode(self, c, tar_c=None, dtype=None):
        z = self.encoder.apply(c, dtype=dtype)
        if tar_c is not None:
            return bn.adain(z, self.encoder.apply(tar_c, dtype=dtype))
        return bn.instance_norm(z)

    def forward(self, x, c, g, *, train: bool = True, dtype=None):
        lat = self.encode(c, dtype=dtype)
        y_hat = self.wavenet.apply(x, lat, self.speaker_code(c, dtype=dtype), train=train, dtype=dtype)
        return (y_hat, *_no_aux(y_hat))


class CatWAE(WAEBase):
    """Gumbel-softmax categorical bottleneck over ``slices`` slices of k codes
    (``gumbel.heads.{i}``, ``gumbel.codes.{i}``)."""

    def __init__(self, wavenet: WaveNet, c_in=39, hid=64, frame_rate=25, encoder_hid=768, *,
                 k=128, tau=0.1, hard=False, slices=4, generator=None):
        super().__init__(wavenet, c_in, hid, frame_rate, encoder_hid, generator=generator)
        self.k, self.tau, self.hard, self.slices = k, tau, hard, slices
        self.gumbel = bn.Gumbel(hid, k, slices, generator=generator)

    def encode(self, c, tar_c=None, dtype=None):
        z = self.encoder.apply(c, dtype=dtype)
        return bn.gumbel_apply(self.gumbel, z, tau=self.tau, hard=self.hard, train=False)[0]

    def forward(self, x, c, g, *, train: bool = True, dtype=None, generator=None, uniforms=None):
        z = self.encoder.apply(c, dtype=dtype)
        q, aux, perp, _ = bn.gumbel_apply(self.gumbel, z, tau=self.tau, hard=self.hard, train=train,
                                          generator=generator, uniforms=uniforms)
        y_hat = self.wavenet.apply(x, q, g, train=train, dtype=dtype)
        return y_hat, aux, perp


class Vocoder(nn.Module):
    """The plain WaveNet vocoder: no encoder, the features are the
    conditioning."""

    def __init__(self, wavenet: WaveNet):
        super().__init__()
        self.wavenet = wavenet

    def encode(self, c, tar_c=None, dtype=None):
        return c

    def forward(self, x, c, g, *, train: bool = True, dtype=None):
        y_hat = self.wavenet.apply(x, c, g, train=train, dtype=dtype)
        return (y_hat, *_no_aux(y_hat))

    @torch.no_grad()
    def decode(self, c, g=None, T=None, tar_c=None, **kw):
        if T is None:
            T = (c.shape[1] - 2 * self.wavenet.cin_pad) * int(np.prod(self.wavenet.upsample_scales))
        return self.wavenet.decode(T, c=c, g=g, **kw)


class VQWAE(WAEBase):
    """Plain or sliced VQ bottleneck with optional instance norm, AdaIN
    re-styling and post-conv. Parameters: ``encoder``, ``wavenet``, ``vq``
    (``codebook`` or ``codebooks.{i}``) and optional ``post``."""

    def __init__(self, wavenet: WaveNet, c_in=39, hid=64, frame_rate=25, encoder_hid=768, *,
                 K=256, K1=None, num_slices=2, beta=0.25, commit_scale=1.0, ema=False,
                 sliced=False, ins_norm=False, post_conv=False, adain=False, generator=None):
        super().__init__(wavenet, c_in, hid, frame_rate, encoder_hid, generator=generator)
        if ema:
            raise NotImplementedError(
                "EMA codebooks are not ported yet: see ROADMAP.md, queue 1 (EMA "
                "codebooks, reseed, time jitter and VQ-dropout)"
            )
        self.K, self.K1, self.num_slices = K, K1, num_slices
        self.beta, self.commit_scale = beta, commit_scale
        self.sliced, self.ins_norm, self.post_conv, self.adain = sliced, ins_norm, post_conv, adain
        if sliced:
            self.vq = bn.SlicedVQ(K, hid, num_slices, K1, generator=generator)
        else:
            self.vq = bn.VQ(K, hid, generator=generator)
        # the training forward projects the quantized code up to the
        # decoder's cin_channels with it; encode() returns the code unprojected
        self.post = Conv1d(hid, wavenet.cin_channels, 3, generator=generator) if post_conv else None

    def _quantize(self, z):
        if self.sliced:
            return bn.sliced_vq_apply(self.vq, z, beta=self.beta, commit_scale=self.commit_scale)
        return bn.vq_apply(self.vq, z, beta=self.beta)

    def forward(self, x, c, g, *, train: bool = True, dtype=None):
        """Training forward: encoder -> instance norm -> VQ (straight-through)
        -> post-conv -> teacher-forced decoder. Returns (y_hat, vq_loss,
        perplexity)."""
        z = self.encoder.apply(c, dtype=dtype)
        if self.ins_norm:
            z = bn.instance_norm(z)
        q, vq_loss, perp, _idx = self._quantize(z)
        if self.post_conv:
            q = conv1d_apply(self.post, q, padding=[(1, 1)], dtype=dtype)
        y_hat = self.wavenet.apply(x, q, g, train=train, dtype=dtype)
        return y_hat, vq_loss, perp

    def encode(self, c, tar_c=None, pre_vq: bool = False):
        """Quantized latent (B, T', hid) — the ABX representation. With
        adain and a target utterance, re-styles the pre-VQ code first.
        ``pre_vq=True`` returns the continuous pre-quantization code."""
        z = self.encoder.apply(c)
        if tar_c is not None and self.adain:
            z = bn.adain(z, self.encoder.apply(tar_c))
        elif self.ins_norm:
            z = bn.instance_norm(z)
        if pre_vq:
            return z
        return self._quantize(z)[0]
