"""The WaveNet-autoencoder model zoo (counterpart of
``wavenet_autoencoders_tpu/models/wae.py``):

- ``WVAE``     — continuous bottleneck (AE);
- ``VQWAE``    — plain, sliced or EMA VQ, instance norm, AdaIN, post-conv,
                 VQ-dropout, time jitter, dead-code revival;
- ``INWAE``    — instance-norm AE (INAE; INAE1 with ``per_block_in``),
                 speaker-id embedding, AdaIN voice conversion from a
                 target-speaker utterance (``tar_c``);
- ``NewINWAE`` — like INWAE, but the decoder's global conditioning is a
                 continuous speaker code from a ``SpeakerEncoder``;
- ``CatWAE``   — Gumbel-softmax categorical bottleneck;
- ``Vocoder``  — the plain WaveNet vocoder, conditioned on the features.

The port's models hold their weights, so ``encode(c, tar_c=None)``,
``decode(c, ...)`` and the training ``forward(x, c, g, *, train, dtype)``
(-> ``(y_hat, aux_loss, perplexity)``) take no params/state arguments; the
non-gradient state of the JAX package's ``model_state`` (EMA codebooks,
code usage) is held in buffers named by its tree paths and updated in
place. Every family draws its weights as its JAX ``init(key)`` does: the
constructor takes ``key`` and ``wavenet``, a function that builds the
decoder from the key the JAX ``init`` gives ``WaveNet.init``. The training
noise comes from the step's ``key`` passed to ``forward``, which each
family splits as its JAX ``forward`` does (the bottleneck's draws: Gumbel,
VQ-dropout, time jitter; the rest to the decoder, which splits it once a
layer for its dropout masks).
All activations are (B, T, C).
"""
from __future__ import annotations

from collections.abc import Callable

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from wavenet_autoencoders_tpu_torch.models import bottlenecks as bn
from wavenet_autoencoders_tpu_torch.models.encoder import Encoder, SpeakerEncoder
from wavenet_autoencoders_tpu_torch.models.wavenet import WaveNet
from wavenet_autoencoders_tpu_torch.ops.conv import Conv1d, conv1d_apply
from wavenet_autoencoders_tpu_torch.parallel import distributed as dist
from wavenet_autoencoders_tpu_torch.utils import jax_random as jr


MakeWaveNet = Callable[[torch.Tensor], WaveNet]


class WAEBase(nn.Module):
    def __init__(self, wavenet: MakeWaveNet, c_in: int = 39, hid: int = 64,
                 frame_rate: int = 25, encoder_hid: int = 768, *, key: torch.Tensor):
        """Two keys split from ``key``: the encoder's, then the decoder's."""
        k1, k2 = jr.split(key)
        self._init(wavenet(k2), c_in, hid, frame_rate, encoder_hid, k1)

    def _init(self, wavenet: WaveNet, c_in: int, hid: int, frame_rate: int, encoder_hid: int,
              encoder_key: torch.Tensor):
        nn.Module.__init__(self)
        self.c_in, self.hid, self.frame_rate, self.encoder_hid = c_in, hid, frame_rate, encoder_hid
        self.encoder = Encoder(c_in=c_in, hid=encoder_hid, c_out=hid,
                               downsample=self.downsample, key=encoder_key)
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

    def forward(self, x, c, g, *, train: bool = True, dtype=None, key=None):
        y_hat = self.wavenet.apply(x, self.encode(c, dtype=dtype), g, train=train, dtype=dtype, key=key)
        return (y_hat, *_no_aux(y_hat))


class INWAE(WAEBase):
    """Instance norm on the latent; with ``per_block_in`` (INAE1) also after
    every encoder block. With ``adain`` and a target utterance, ``encode``
    re-styles the code with the target's channel statistics."""

    def __init__(self, wavenet: MakeWaveNet, c_in=39, hid=64, frame_rate=25, encoder_hid=768, *,
                 adain=True, per_block_in=False, key: torch.Tensor):
        super().__init__(wavenet, c_in, hid, frame_rate, encoder_hid, key=key)
        self.adain, self.per_block_in = adain, per_block_in

    def _encode_raw(self, c, dtype=None):
        return self.encoder.apply(c, dtype=dtype, per_block=bn.instance_norm if self.per_block_in else None)

    def encode(self, c, tar_c=None, dtype=None):
        z = self._encode_raw(c, dtype=dtype)
        if tar_c is not None and self.adain:
            return bn.adain(z, self._encode_raw(tar_c, dtype=dtype))
        return bn.instance_norm(z)

    def forward(self, x, c, g, *, train: bool = True, dtype=None, key=None):
        y_hat = self.wavenet.apply(x, self.encode(c, dtype=dtype), g, train=train, dtype=dtype, key=key)
        return (y_hat, *_no_aux(y_hat))


class NewINWAE(WAEBase):
    """IN latent; the decoder's global conditioning (gin = 64, no id
    embedding) is ``speaker_code(c)``, so ``forward`` ignores ``g``.
    Parameters ``encoder``, ``spk``, ``wavenet``, from three keys split
    from ``key`` in that order."""

    def __init__(self, wavenet: MakeWaveNet, c_in=39, hid=64, frame_rate=25, encoder_hid=768, *,
                 speaker_hid=128, key: torch.Tensor):
        k1, k2, k3 = jr.split(key, 3)
        self._init(wavenet(k3), c_in, hid, frame_rate, encoder_hid, k1)
        self.spk = SpeakerEncoder(c_in=c_in, hid=speaker_hid, c_out=self.wavenet.gin_channels, key=k2)

    def speaker_code(self, c, dtype=None):
        return self.spk.apply(c, dtype=dtype)

    def encode(self, c, tar_c=None, dtype=None):
        z = self.encoder.apply(c, dtype=dtype)
        if tar_c is not None:
            return bn.adain(z, self.encoder.apply(tar_c, dtype=dtype))
        return bn.instance_norm(z)

    def forward(self, x, c, g, *, train: bool = True, dtype=None, key=None):
        lat = self.encode(c, dtype=dtype)
        y_hat = self.wavenet.apply(x, lat, self.speaker_code(c, dtype=dtype), train=train, dtype=dtype, key=key)
        return (y_hat, *_no_aux(y_hat))


class CatWAE(WAEBase):
    """Gumbel-softmax categorical bottleneck over ``slices`` slices of k codes
    (``gumbel.heads.{i}``, ``gumbel.codes.{i}``). Keys: the encoder's, the
    bottleneck's, the decoder's, split from ``key``."""

    def __init__(self, wavenet: MakeWaveNet, c_in=39, hid=64, frame_rate=25, encoder_hid=768, *,
                 k=128, tau=0.1, hard=False, slices=4, key: torch.Tensor):
        k1, k2, k3 = jr.split(key, 3)
        self._init(wavenet(k3), c_in, hid, frame_rate, encoder_hid, k1)
        self.k, self.tau, self.hard, self.slices = k, tau, hard, slices
        self.gumbel = bn.Gumbel(hid, k, slices, key=k2)

    def encode(self, c, tar_c=None, dtype=None):
        z = self.encoder.apply(c, dtype=dtype)
        return bn.gumbel_apply(self.gumbel, z, tau=self.tau, hard=self.hard, train=False)[0]

    def forward(self, x, c, g, *, train: bool = True, dtype=None, key=None):
        """The Gumbel noise from ``sk`` of ``key, sk = split(key)``, the
        decoder's from the rest (JAX ``CatWAE.forward``)."""
        z = self.encoder.apply(c, dtype=dtype)
        sk = None
        if key is not None:
            key, sk = jr.split(key)
        q, aux, perp, _ = bn.gumbel_apply(self.gumbel, z, tau=self.tau, hard=self.hard, train=train, key=sk)
        y_hat = self.wavenet.apply(x, q, g, train=train, dtype=dtype, key=key)
        return y_hat, aux, perp


class Vocoder(nn.Module):
    """The plain WaveNet vocoder: no encoder, the features are the
    conditioning. The decoder draws from ``key`` itself."""

    def __init__(self, wavenet: MakeWaveNet, *, key: torch.Tensor):
        super().__init__()
        self.wavenet = wavenet(key)

    def encode(self, c, tar_c=None, dtype=None):
        return c

    def forward(self, x, c, g, *, train: bool = True, dtype=None, key=None):
        y_hat = self.wavenet.apply(x, c, g, train=train, dtype=dtype, key=key)
        return (y_hat, *_no_aux(y_hat))

    @torch.no_grad()
    def decode(self, c, g=None, T=None, tar_c=None, **kw):
        if T is None:
            T = (c.shape[1] - 2 * self.wavenet.cin_pad) * int(np.prod(self.wavenet.upsample_scales))
        return self.wavenet.decode(T, c=c, g=g, **kw)


class VQWAE(WAEBase):
    """Plain, sliced or EMA VQ bottleneck with optional instance norm, AdaIN
    re-styling, post-conv, VQ-dropout, time jitter and dead-code revival.
    Parameters: ``encoder``, ``wavenet``, ``vq`` (``codebook`` or
    ``codebooks.{i}``; none with ``ema``) and optional ``post``. Buffers
    (the JAX ``model_state``): with ``ema``, ``vq.codebooks.{i}``,
    ``vq.cluster_size.{i}`` and ``vq.ema_w.{i}``; with ``reseed``,
    ``usage.{i}``. Keys: the encoder's, the decoder's, the codebooks', the
    post-conv's, split from ``key``."""

    def __init__(self, wavenet: MakeWaveNet, c_in=39, hid=64, frame_rate=25, encoder_hid=768, *,
                 K=256, K1=None, num_slices=2, beta=0.25, commit_scale=1.0, ema=False, ema_decay=0.99,
                 sliced=False, ins_norm=False, post_conv=False, adain=False,
                 use_time_jitter=False, time_jitter_prob=0.12, time_jitter_per_side=True,
                 vq_drop=False, drop_dim=0,
                 reseed=False, reseed_thresh=0.1, reseed_decay=0.99, reseed_start=500, key: torch.Tensor):
        k1, k2, k3, k4 = jr.split(key, 4)
        self._init(wavenet(k2), c_in, hid, frame_rate, encoder_hid, k1)
        self.K, self.K1, self.num_slices = K, K1, num_slices
        self.beta, self.commit_scale, self.ema, self.ema_decay = beta, commit_scale, ema, ema_decay
        self.sliced, self.ins_norm, self.post_conv, self.adain = sliced, ins_norm, post_conv, adain
        self.use_time_jitter, self.time_jitter_prob = use_time_jitter, time_jitter_prob
        self.time_jitter_per_side, self.vq_drop, self.drop_dim = time_jitter_per_side, vq_drop, drop_dim
        self.reseed, self.reseed_thresh = reseed, reseed_thresh
        self.reseed_decay, self.reseed_start = reseed_decay, reseed_start
        if ema:
            self.vq = bn.VQEMA(K, hid, num_slices if sliced else 1, K1, key=k3)
        elif sliced:
            self.vq = bn.SlicedVQ(K, hid, num_slices, K1, key=k3)
        else:
            self.vq = bn.VQ(K, hid, key=k3)
        if reseed:
            self.usage = bn.BufferList(torch.full((s,), 1.0 / s, device=key.device) for s in self._codebook_sizes())
        # the training forward projects the quantized code up to the
        # decoder's cin_channels with it; encode() returns the code unprojected
        self.post = Conv1d(hid, self.wavenet.cin_channels, 3, key=k4) if post_conv else None
        self._vq_diag = None

    def _codebook_sizes(self) -> list[int]:
        return bn._slice_sizes(self.K, self.K1, self.num_slices if self.sliced else 1)

    def _books(self) -> list[torch.Tensor]:
        if self.ema or self.sliced:
            return list(self.vq.codebooks)
        return [self.vq.codebook]

    def _pre_vq(self, z, train, key):
        """Instance norm, then VQ-dropout from ``sk`` of ``key, sk =
        split(key)``; returns (z, the key left for the decoder), JAX
        ``_pre_vq``."""
        if self.ins_norm:
            z = bn.instance_norm(z)
        if train and self.vq_drop and self.drop_dim > 0 and key is not None:
            key, sk = jr.split(key)
            z = bn.vq_dropout(z, self.drop_dim, key=sk)
        return z, key

    def _quantize(self, z, train: bool = False):
        if self.ema:
            return bn.vq_ema_apply(self.vq, z, beta=self.beta, decay=self.ema_decay, train=train)
        if self.sliced:
            return bn.sliced_vq_apply(self.vq, z, beta=self.beta, commit_scale=self.commit_scale)
        return bn.vq_apply(self.vq, z, beta=self.beta)

    def _post_vq(self, q, train, dtype, key, jitter_scale):
        """Time jitter from ``sk`` of a split of a local copy of ``key``, so
        the caller's key is unchanged (JAX ``_post_vq``): the decoder's
        first dropout split then draws from the jitter's key again, a reuse
        of the JAX package that is mirrored. ``jitter_scale`` is the 0/1
        gate of ``cfg.time_jitter_start`` as a 0-dim f32 tensor, or None
        without one: as JAX computes ``prob·gate`` in f32 and draws either
        way, the jitter runs with probability 0 while the gate is shut (the
        identity, bit for bit), and the step reads no gate on the host."""
        if train and self.use_time_jitter and key is not None:
            prob = self.time_jitter_prob
            if jitter_scale is not None:
                prob = jitter_scale * float(np.float32(prob))
            q = bn.time_jitter(q, prob, per_side=self.time_jitter_per_side, key=jr.split(key)[1])
        if self.post_conv:
            q = conv1d_apply(self.post, q, padding=[(1, 1)], dtype=dtype)
        return q

    def forward(self, x, c, g, *, train: bool = True, dtype=None, key=None, jitter_scale=None):
        """Training forward: encoder -> instance norm -> VQ-dropout -> VQ
        (straight-through; EMA statistics updated in place) -> time jitter ->
        post-conv -> teacher-forced decoder, the noise drawn from ``key`` as
        JAX's ``VQWAE.forward`` draws it. Returns (y_hat, vq_loss,
        perplexity). With ``reseed``, a training forward stashes what
        ``revive`` needs: the pre-VQ codes of the (global) batch and each
        slice's code fractions."""
        z = self.encoder.apply(c, dtype=dtype)
        z, key = self._pre_vq(z, train, key)
        q, vq_loss, perp, idx = self._quantize(z, train)
        if train and self.reseed:
            idxs = idx if idx.ndim == 3 else idx[..., None]
            counts = [bn.code_fractions(F.one_hot(idxs[..., i].reshape(-1), s))
                      for i, s in enumerate(self._codebook_sizes())]
            flat = dist.all_gather_rows(z.reshape(-1, z.shape[-1]).detach().float())
            self._vq_diag = {"z": flat, "counts": counts}
        q = self._post_vq(q, train, dtype, key, jitter_scale)
        y_hat = self.wavenet.apply(x, q, g, train=train, dtype=dtype, key=key)
        return y_hat, vq_loss, perp

    @torch.no_grad()
    def revive(self, active, candidates) -> torch.Tensor:
        """Dead-code revival, run by the train step after the optimizer
        update, from the stash of the step's forward: refresh each slice's
        usage EMA from the batch's code fractions, then re-seed the rows
        whose usage fell below ``reseed_thresh/K`` (when ``active``, a bool
        or a 0-dim bool tensor: the step is past ``reseed_start``) with
        pre-VQ codes of the batch, the rows
        ``candidates(i, n)`` (K indices of slice i into the batch's n latent
        frames). With EMA codebooks the revived rows' statistics are patched
        too (cluster size <- the mean, ema_w <- code * mean) so the next EMA
        update keeps them. Returns the number of revived codes."""
        diag, self._vq_diag = self._vq_diag, None
        z, sub = diag["z"], self.hid // len(self._codebook_sizes())
        n_dead = z.new_zeros(())
        for i, cb in enumerate(self._books()):
            u = bn.update_usage(self.usage[i], diag["counts"][i], self.reseed_decay)
            new_cb, u, dead = bn.reseed_slice(
                cb, u, z[:, i * sub : (i + 1) * sub], self.reseed_thresh, active, cand_idx=candidates(i, z.shape[0]))
            if self.ema:
                cs, ew = self.vq.cluster_size[i], self.vq.ema_w[i]
                mean_cs = cs.mean()
                ew.copy_(torch.where(dead[:, None], new_cb * mean_cs, ew))
                cs.copy_(torch.where(dead, mean_cs, cs))
            cb.copy_(new_cb)
            self.usage[i].copy_(u)
            n_dead = n_dead + dead.float().sum()
        return n_dead

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

