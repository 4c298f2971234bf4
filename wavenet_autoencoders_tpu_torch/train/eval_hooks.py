"""Training-time qualitative evaluation hooks (counterpart of
``wavenet_autoencoders_tpu/train/eval_hooks.py``).

- ``save_states``: the teacher-forced sample dump (``vqwae_train.py:643-691``),
  written to ``intermediate/audio/step<N>_{predicted,target}.wav``;
- ``eval_model``: a full AR decode of one batch item (``vqwae_train.py:572-640``)
  through ``batch_wavegen`` (the decode kernel on the card), written to
  ``<eval_dir>/step<N>_{predicted,target}.wav`` and, when matplotlib is
  importable, ``step<N>_waveplots.png``.

The batch item is picked as in the JAX package, by numpy seeded with
``cfg.seed + step``; scalar (MoL/MoG) outputs are sampled with the port's
samplers from a ``torch.Generator`` seeded with the step.
"""
from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from wavenet_autoencoders_tpu_torch import dsp
from wavenet_autoencoders_tpu_torch.config import Config


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _to_wav(cfg: Config, codes_or_scalar: np.ndarray) -> np.ndarray:
    """A fresh float32 waveform (never a view of the batch, which the
    caller zeroes past the utterance's length)."""
    mu = cfg.quantize_channels - 1
    if cfg.is_mulaw_quantize:
        y = dsp.inv_mulaw_quantize(codes_or_scalar.astype(np.float32), mu)
    elif cfg.is_mulaw:
        y = dsp.inv_mulaw(codes_or_scalar, mu)
    else:
        y = codes_or_scalar
    return np.array(y, np.float32)


def _save_plot(path, y_hat, y_target, sr):
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except Exception:
        return
    t = np.arange(len(y_target)) / sr
    fig, axes = plt.subplots(2, 1, figsize=(16, 6), sharex=True)
    axes[0].plot(t[: len(y_target)], y_target)
    axes[0].set_title("target")
    axes[1].plot(np.arange(len(y_hat)) / sr, y_hat)
    axes[1].set_title("predicted")
    fig.tight_layout()
    fig.savefig(path, format="png")
    plt.close(fig)


def _pick(cfg: Config, step: int, batch_size: int) -> int:
    """The batch item a hook writes: seeded by (cfg.seed, step), so reruns
    dump the same utterance."""
    return int(np.random.default_rng(cfg.seed + step).integers(0, batch_size))


def save_states(cfg: Config, step: int, y_hat, batch: dict, checkpoint_dir) -> None:
    """Teacher-forced sample dump: argmax (mu-law) or sample (MoL/MoG) the
    forward's output ``y_hat`` (B, T, C) for one batch item and write the
    predicted and target wavs."""
    out_dir = Path(checkpoint_dir) / "intermediate" / "audio"
    out_dir.mkdir(parents=True, exist_ok=True)
    idx = _pick(cfg, step, y_hat.shape[0])
    length = int(batch["lengths"][idx])
    y = torch.as_tensor(y_hat[idx]).float()
    if cfg.is_mulaw_quantize:
        pred = _host(y.argmax(-1))
    else:
        from wavenet_autoencoders_tpu_torch.ops.mixture import (
            sample_from_discretized_mix_logistic,
            sample_from_mix_gaussian,
        )

        smp = (
            sample_from_discretized_mix_logistic
            if cfg.output_distribution == "Logistic"
            else sample_from_mix_gaussian
        )
        gen = torch.Generator(device=y.device).manual_seed(step)
        pred = _host(smp(y[None], generator=gen, log_scale_min=cfg.log_scale_min))[0]
    target = _host(batch["y"][idx, :, 0])
    pred_w = _to_wav(cfg, pred)
    tgt_w = _to_wav(cfg, target)
    pred_w[length:] = 0
    tgt_w[length:] = 0
    dsp.save_wav(pred_w, out_dir / f"step{step:09d}_predicted.wav", cfg.sample_rate)
    dsp.save_wav(tgt_w, out_dir / f"step{step:09d}_target.wav", cfg.sample_rate)


def eval_model(cfg: Config, model, step: int, batch: dict, eval_dir, generator=None) -> None:
    """Full AR decode of one batch item conditioned on its features, on the
    model's device, with the model's current weights; wav + waveplot out.
    ``generator`` (on that device) drives the sampling; the default is
    seeded with ``cfg.seed + step``."""
    from wavenet_autoencoders_tpu_torch.eval.synthesize import batch_wavegen

    out_dir = Path(eval_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    dev = next(model.parameters()).device
    idx = _pick(cfg, step, batch["c"].shape[0])
    c = _host(batch["c"][idx : idx + 1])
    g = _host(batch["g"][idx : idx + 1]) if "g" in batch else None
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(cfg.seed + step)
    wav = batch_wavegen(cfg, model, c, g, generator=generator, device=dev)[0]
    target = _to_wav(cfg, _host(batch["y"][idx, :, 0]))
    dsp.save_wav(wav, out_dir / f"step{step:09d}_predicted.wav", cfg.sample_rate)
    dsp.save_wav(target, out_dir / f"step{step:09d}_target.wav", cfg.sample_rate)
    _save_plot(out_dir / f"step{step:09d}_waveplots.png", wav, target, cfg.sample_rate)
