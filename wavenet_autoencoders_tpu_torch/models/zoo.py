"""Model-zoo builders: Config -> model on a device (counterpart of
``wavenet_autoencoders_tpu/models/zoo.py:21-100``).

Only the VQ family (``name == "vqvae"``, which the svqwae preset uses) is
ported; every other name raises.
"""
from __future__ import annotations

import torch

from wavenet_autoencoders_tpu_torch.config import Config
from wavenet_autoencoders_tpu_torch.models.wae import VQWAE
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


def build_model(cfg: Config, device: str | torch.device = "cuda", seed: int | None = None):
    """Build ``cfg.name``'s model with weights drawn from ``seed`` (default
    ``cfg.seed``) and move it to ``device``. Raises when ``device`` is CUDA
    and no CUDA device exists."""
    dev = resolve_device(device)
    name = cfg.name.lower()
    if name != "vqvae":
        raise NotImplementedError(
            f"model {cfg.name!r} is not ported yet: see ROADMAP.md, queue 1 "
            "(rest of the zoo)"
        )
    gen = torch.Generator().manual_seed(cfg.seed if seed is None else seed)
    # post_conv selects hid=64
    hid = 64 if cfg.post_conv else cfg.cin_channels
    K1 = cfg.K1 if (cfg.use_K1 and cfg.K1 not in (None, cfg.K)) else None
    model = VQWAE(
        build_wavenet(cfg, generator=gen),
        c_in=cfg.dim_in,
        hid=hid,
        frame_rate=cfg.frame_rate,
        encoder_hid=cfg.encoder_hid,
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
        generator=gen,
    )
    return model.to(dev).eval()
