"""Model-zoo builders: Config -> model on a device (counterpart of
``wavenet_autoencoders_tpu/models/zoo.py``). ``build_model`` dispatches on
``cfg.name`` with the JAX package's constructor arguments: wvae/ae | vqvae |
inae | inae1 | new_inae | catae | wavenet_vocoder, and the MFCC-only
feature AEs (model/ae_feat, model2/ae2, model4/ae4, catae_feat/cat_ae).
"""
from __future__ import annotations

import torch

from wavenet_autoencoders_tpu_torch.config import Config
from wavenet_autoencoders_tpu_torch.models.mfcc_ae import CatMfccAE, MfccAE
from wavenet_autoencoders_tpu_torch.models.wae import WVAE, CatWAE, INWAE, NewINWAE, Vocoder, VQWAE
from wavenet_autoencoders_tpu_torch.models.wavenet import WaveNet
from wavenet_autoencoders_tpu_torch.utils.device import resolve_device


def build_wavenet(cfg: Config, gin_channels=None, use_speaker_embedding=True,
                  generator: torch.Generator | None = None) -> WaveNet:
    """The shared decoder ctor every builder uses."""
    if cfg.is_mulaw_quantize and cfg.out_channels != cfg.quantize_channels:
        raise ValueError(
            "out_channels must equal quantize_channels for mulaw-quantize input"
        )
    return WaveNet(
        out_channels=cfg.out_channels,
        layers=cfg.layers,
        stacks=cfg.stacks,
        residual_channels=cfg.residual_channels,
        gate_channels=cfg.gate_channels,
        skip_out_channels=cfg.skip_out_channels,
        kernel_size=cfg.kernel_size,
        dropout=cfg.dropout,
        cin_channels=cfg.cin_channels,
        gin_channels=cfg.gin_channels if gin_channels is None else gin_channels,
        n_speakers=cfg.n_speakers,
        upsample_conditional_features=cfg.upsample_conditional_features,
        upsample_net=cfg.upsample_net,
        upsample_scales=tuple(cfg.upsample_scales),
        freq_axis_kernel_size=int(cfg.upsample_params.get("freq_axis_kernel_size", 1)),
        cin_pad=cfg.cin_pad,
        scalar_input=cfg.is_scalar_input,
        use_speaker_embedding=use_speaker_embedding,
        output_distribution=cfg.output_distribution,
        fused_stack=cfg.fused_stack,
        generator=generator,
    )


_FEATURE_AE_DOWNSAMPLE = {"model": 1, "ae_feat": 1, "model2": 2, "ae2": 2, "model4": 4, "ae4": 4}


def build_model(cfg: Config, device: str | torch.device = "cuda", seed: int | None = None):
    """Build ``cfg.name``'s model with weights drawn from ``seed`` (default
    ``cfg.seed``) and move it to ``device``. Raises ValueError for an
    unknown name, and when ``device`` is CUDA and no CUDA device exists."""
    dev = resolve_device(device)
    return _build(cfg, torch.Generator().manual_seed(cfg.seed if seed is None else seed)).to(dev).eval()


def _build(cfg: Config, gen: torch.Generator):
    name = cfg.name.lower()
    ae = dict(c_in=cfg.dim_in, hid=cfg.cin_channels, frame_rate=cfg.frame_rate, encoder_hid=cfg.encoder_hid,
              generator=gen)
    if name == "wavenet_vocoder":
        return Vocoder(build_wavenet(cfg, generator=gen))
    if name in ("wvae", "ae"):
        return WVAE(build_wavenet(cfg, generator=gen), **ae)
    if name == "vqvae":
        # post_conv selects hid=64
        K1 = cfg.K1 if (cfg.use_K1 and cfg.K1 not in (None, cfg.K)) else None
        return VQWAE(
            build_wavenet(cfg, generator=gen),
            **{**ae, "hid": 64 if cfg.post_conv else cfg.cin_channels},
            K=cfg.K,
            K1=K1,
            num_slices=cfg.num_slices,
            beta=cfg.beta,
            commit_scale=cfg.vq_commit_scale,
            ema=cfg.ema,
            sliced=cfg.sliced,
            ins_norm=cfg.ins_norm,
            post_conv=cfg.post_conv,
            adain=cfg.adain,
            use_time_jitter=cfg.time_jitter,
            time_jitter_prob=cfg.time_jitter_prob,
            time_jitter_per_side=cfg.time_jitter_per_side,
            vq_drop=cfg.vq_drop,
            drop_dim=cfg.drop_dim,
            reseed=cfg.vq_reseed,
            reseed_thresh=cfg.vq_reseed_thresh,
            reseed_decay=cfg.vq_reseed_decay,
            reseed_start=cfg.vq_reseed_start,
        )
    if name in ("inae", "inae1"):
        return INWAE(build_wavenet(cfg, generator=gen), **ae, adain=cfg.adain, per_block_in=(name == "inae1"))
    if name == "new_inae":
        # gin=64 continuous speaker code, no id embedding
        return NewINWAE(build_wavenet(cfg, gin_channels=64, use_speaker_embedding=False, generator=gen), **ae)
    if name == "catae":
        return CatWAE(build_wavenet(cfg, generator=gen), **ae, k=cfg.K, tau=cfg.tau, hard=cfg.hard,
                      slices=cfg.num_slices)
    # the MFCC-only feature-space AEs, ctor (c_in=cfg.cin_channels, hid=64)
    if name in _FEATURE_AE_DOWNSAMPLE:
        return MfccAE(c_in=cfg.cin_channels, hid=64, downsample=_FEATURE_AE_DOWNSAMPLE[name], generator=gen)
    if name in ("catae_feat", "cat_ae"):
        return CatMfccAE(c_in=cfg.cin_channels, hid=64, downsample=100 // cfg.frame_rate, k=cfg.K, tau=cfg.tau,
                         hard=cfg.hard, slices=cfg.num_slices, generator=gen)
    raise ValueError(f"unknown model name: {cfg.name}")
