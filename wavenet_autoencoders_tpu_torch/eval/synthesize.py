"""Waveform synthesis / voice conversion (counterpart of
``wavenet_autoencoders_tpu/eval/synthesize.py``).

- ``batch_wavegen``: B utterances decoded in parallel — the CUDA decode
  kernel on the card, the plain ``WaveNet.decode`` elsewhere;
- ``wavegen``: one utterance;
- ``run_synthesis_list``: the voice-conversion driver over ``synthesis.txt``
  pairs (source_utt, target_speaker), including the IN-model ``tar_c``
  AdaIN path and the ZeroSpeech layout ``dst/2019/<lan>/test/<V00x>_<fid>.wav``.
"""
from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import torch

from wavenet_autoencoders_tpu_torch import dsp
from wavenet_autoencoders_tpu_torch.config import Config
from wavenet_autoencoders_tpu_torch.utils import jax_random as jr
from wavenet_autoencoders_tpu_torch.utils.device import check_on


def _postprocess(cfg: Config, y_codes: np.ndarray) -> np.ndarray:
    """Codes/scalars -> float waveform."""
    mu = cfg.quantize_channels - 1
    if cfg.is_mulaw_quantize:
        wav = dsp.inv_mulaw_quantize(y_codes.astype(np.float32), mu)
    elif cfg.is_mulaw:
        wav = dsp.inv_mulaw(y_codes, mu)
    else:
        wav = y_codes
    if cfg.postprocess == "inv_preemphasis":
        wav = dsp.inv_preemphasis(wav, cfg.preemphasis_coef)
    if cfg.global_gain_scale > 0:
        wav = wav / cfg.global_gain_scale
    return np.asarray(wav, np.float32)


def _pad_frames(cfg: Config, c: np.ndarray) -> np.ndarray:
    """Pad frame count to a multiple of 100//frame_rate."""
    div = 100 // cfg.frame_rate
    if c.shape[0] % div != 0:
        pad = div - (c.shape[0] % div)
        c = np.pad(c, [(0, pad), (0, 0)], mode="constant")
    return c


def _pad_frames_batch(cfg, c):
    if c.ndim == 2:
        c = c[None]
    div = 100 // cfg.frame_rate
    if c.shape[1] % div != 0:
        pad = div - (c.shape[1] % div)
        c = np.pad(c, [(0, 0), (0, pad), (0, 0)], mode="constant")
    return c


def _use_kernel_decode(cfg: Config, device: torch.device) -> bool:
    """The fused decode kernel covers both input families for
    kernel_size 3 on a CUDA device; ``extras.use_pallas_decode == "never"``
    opts out."""
    if cfg.kernel_size != 3:
        return False
    if str(cfg.extras.get("use_pallas_decode", "auto")) == "never":
        return False
    return device.type == "cuda"


@torch.no_grad()
def batch_wavegen(
    cfg: Config,
    model,
    c: np.ndarray,
    g: np.ndarray | None = None,
    tar_c: np.ndarray | None = None,
    key: torch.Tensor | None = None,
    device: str | torch.device = "cuda",
) -> np.ndarray:
    """c: (B, T', dim_in) feature frames -> (B, T) float waveforms. IN-family
    models re-style the latent with ``tar_c``'s statistics (AdaIN);
    NewINWAE conditions on the speaker code of ``tar_c`` (else of ``c``) in
    place of ``g``.

    The model must live on ``device``. The sampling draws from the JAX key
    ``key`` (default ``PRNGKey(0)``, as the JAX package's): the plain
    decode splits it once a step; the decode kernel takes the seed
    ``randint(key, (), 0, 2³¹ − 1)`` (JAX's ``decode_pallas``) and draws
    from it with its own generator."""
    dev = check_on(model, device)
    if not hasattr(model, "wavenet"):
        raise ValueError(f"{type(model).__name__} has no waveform decoder; it serves ABX export only")
    key = jr.PRNGKey(0, dev) if key is None else key.to(dev)
    c = torch.as_tensor(_pad_frames_batch(cfg, c), dtype=torch.float32, device=dev)
    tar_t = None if tar_c is None else torch.as_tensor(tar_c, dtype=torch.float32, device=dev)
    lat = model.encode(c, tar_c=tar_t)
    if cfg.upsample_conditional_features:
        # audio samples = (latent frames - 2*cin_pad context) * prod(scales)
        T = (lat.shape[1] - 2 * cfg.cin_pad) * int(np.prod(cfg.upsample_scales))
    else:
        # no upsample net: conditioning is repeated by up_factor per frame
        upf = cfg.up_factor if hasattr(model, "frame_rate") else cfg.get_hop_size()
        T = lat.shape[1] * upf
    if hasattr(model, "speaker_code"):
        # NewINWAE: the continuous speaker code of the target utterance (or
        # of the source itself, for reconstruction) replaces the id embedding
        g = model.speaker_code(c if tar_t is None else tar_t).expand(c.shape[0], -1)
    elif g is not None and model.wavenet.gin_channels > 0:
        g = torch.as_tensor(np.asarray(g), device=dev)
    else:  # no global conditioning (vocoder_raw): the ids are not used
        g = None
    if _use_kernel_decode(cfg, dev):
        seed = kernel_seed(key)
        codes, _logits = model.wavenet.decode_kernel(T, c=lat, g=g, seed=seed)
        codes = codes.cpu().numpy()
    else:
        y = model.wavenet.decode(
            T, c=lat, g=g, key=key, softmax=True, quantize=True,
            log_scale_min=cfg.log_scale_min,
        ).cpu().numpy()
        codes = y.argmax(axis=-1) if cfg.is_mulaw_quantize else y[..., 0]
    return np.stack([_postprocess(cfg, codes[i]) for i in range(codes.shape[0])])


def kernel_seed(key: torch.Tensor) -> int:
    """The decode kernel's seed from a JAX key: ``randint(key, (), 0,
    2³¹ − 1)``, read to the host once a call (JAX's ``decode_pallas``)."""
    return int(jr.randint(key, (), 0, 2**31 - 1))


def wavegen(cfg: Config, model, c: np.ndarray, g: int | None = None,
            tar_c: np.ndarray | None = None, key=None, device="cuda") -> np.ndarray:
    """Single-utterance generation; c: (T', dim_in). Returns (T,) float."""
    g_arr = None if g is None else np.array([g], np.int32)
    tc = None if tar_c is None else _pad_frames_batch(cfg, tar_c)
    return batch_wavegen(cfg, model, c[None], g_arr, tar_c=tc, key=key, device=device)[0]


def build_tar_utt_map(train_dump_root: str, speakers, feat: str = "mfcc.norm") -> dict:
    """One fixed target utterance per speaker for AdaIN tar_c: the
    lexicographically first ``<spk>_*`` utterance dir with the feature."""
    root = Path(train_dump_root)
    out = {}
    for spk in speakers:
        cands = sorted(d for d in root.glob(f"{spk}_*") if (d / f"{feat}.npy").exists())
        if cands:
            out[spk] = str(cands[0] / f"{feat}.npy")
    return out


def run_synthesis_list(
    cfg: Config,
    model,
    dump_root: str,
    syn_list_path: str,
    speaker2ind_path: str,
    dst_dir: str,
    lan: str = "english",
    start_ind: int = 0,
    tar_utt_map: dict | None = None,
    key: torch.Tensor | None = None,
    batch: int = 4,
    train_dump_root: str | None = None,
    pad_multiple: int = 0,
    device: str | torch.device = "cuda",
):
    """Voice-conversion loop over "<utt_dir> <target_speaker>" lines.

    IN-family models also load a fixed target-speaker utterance (tar_c) for
    AdaIN; without a map it is built from the sibling ``train_no_dev`` dump
    (or ``train_dump_root``). ``pad_multiple`` (frames, 0 = exact lengths)
    buckets conditioning lengths by edge replication; each waveform is
    cropped back to its true length before it is written. Each decode
    draws from the next key of ``key, sub = split(key)``, the key being
    ``PRNGKey(cfg.seed)`` by default (as the JAX package's).
    """
    dev = check_on(model, device)
    lines = [l.strip() for l in open(syn_list_path) if l.strip()]
    sp2ind = json.load(open(speaker2ind_path))
    key = jr.PRNGKey(cfg.seed, dev) if key is None else key.to(dev)
    needs_tar = cfg.name.lower() in ("inae", "inae1", "new_inae")
    if needs_tar and not tar_utt_map:
        root = Path(train_dump_root) if train_dump_root else Path(dump_root).parent / "train_no_dev"
        tar_utt_map = build_tar_utt_map(root, sorted({l.split()[1] for l in lines}))
        if tar_utt_map:
            print(f"auto tar_c map from {root}: {tar_utt_map}", flush=True)

    out_dir = Path(dst_dir) / "2019" / lan / "test"
    out_dir.mkdir(parents=True, exist_ok=True)

    # group by exact padded frame count so batching never alters
    # per-utterance statistics (instance norm) or shapes
    items = []
    for i in range(start_ind, len(lines)):
        p, tar = lines[i].split()
        if lan == "surprise":
            p = "test/" + p
        fid = p.split("_")[1] if "_" in p else p
        feat_path = Path(dump_root) / p / "mfcc.norm.npy"
        if not feat_path.exists():
            raise FileNotFoundError(feat_path)
        c = _pad_frames(cfg, np.load(feat_path))
        true_frames = c.shape[0]
        if pad_multiple > 0 and c.shape[0] % pad_multiple != 0:
            c = np.pad(c, [(0, pad_multiple - c.shape[0] % pad_multiple), (0, 0)], mode="edge")
        if tar not in sp2ind:
            raise KeyError(f"speaker {tar} not in {speaker2ind_path}")
        tar_c = None
        if needs_tar:
            if not tar_utt_map or tar not in tar_utt_map:
                raise KeyError(f"IN-model synthesis needs a tar_c utterance for {tar}")
            tar_c = np.load(tar_utt_map[tar])
        items.append((i, c, sp2ind[tar], tar, fid, tar_c, true_frames))

    groups: dict = {}
    for it in items:
        # IN-family: batch only items sharing the same tar_c source
        groups.setdefault((it[1].shape[0], None if it[5] is None else it[3]), []).append(it)

    # samples of audio per conditioning frame (crop-back factor)
    div = 100 // cfg.frame_rate
    if cfg.upsample_conditional_features:
        spf = int(np.prod(cfg.upsample_scales)) // div
    else:
        spf = cfg.up_factor // div if hasattr(model, "frame_rate") else cfg.get_hop_size()

    written = []
    step = max(batch, 1)
    for group in groups.values():
        for j in range(0, len(group), step):
            chunk = group[j : j + step]
            tar_c = chunk[0][5]
            key, sub = jr.split(key)
            wavs = batch_wavegen(
                cfg, model,
                np.stack([it[1] for it in chunk]),
                np.array([it[2] for it in chunk], np.int32),
                tar_c=None if tar_c is None else _pad_frames(cfg, tar_c)[None],
                key=sub,
                device=dev,
            )
            for (i, _c, _sp, tar, fid, _tc, tf), wav in zip(chunk, wavs):
                dst = out_dir / f"{tar}_{fid}.wav"
                dsp.save_wav(wav[: tf * spf], dst, cfg.sample_rate)
                written.append(str(dst))
                print(f"ind {i} -> {dst}", flush=True)
    return written
