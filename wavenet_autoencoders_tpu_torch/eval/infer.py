"""ABX representation export (counterpart of
``wavenet_autoencoders_tpu/eval/infer.py:26-170``).

Per test utterance: load ``<feat>.npy``, run ``model.encode`` and save the
latent as ``dst/2019/<lan>/test/<utt>.txt`` (one frame per row, '%.6f').
Utterances are bucketed by padded length and encoded in batches; frames
beyond each utterance's true length are dropped before writing.
"""
from __future__ import annotations

import json
import os
from collections import Counter, defaultdict
from pathlib import Path

import numpy as np
import torch

from wavenet_autoencoders_tpu_torch.config import Config
from wavenet_autoencoders_tpu_torch.utils.device import check_on


def _out_path(base_dir: str, dst_dir: str, lan: str | None = None) -> str:
    """Submission path ``dst/2019/<lan>/test/<utt>.txt``; <lan> comes from
    the dump path's ``<lan>/test/<utt>`` tail, else from ``lan``."""
    parts = [p for p in str(base_dir).split("/") if p]
    fnm = parts[-1]
    if lan is None:
        if len(parts) >= 3 and parts[-2] == "test":
            lan = parts[-3]
        else:
            raise ValueError(f"cannot infer <lan> from dump path {base_dir!r}; pass lan=")
    return f"{dst_dir}/2019/{lan}/test/{fnm}.txt"


def bitrate(latents: list[np.ndarray], total_seconds: float) -> dict:
    """ZeroSpeech 2019 bitrate: each latent frame is one symbol;
    B = (n/D) * H(S) with H the empirical symbol entropy in bits and D the
    corpus duration in seconds. Frames are keyed as written ('%.6f')."""
    counts: Counter = Counter()
    n = 0
    for lat in latents:
        for row in np.asarray(lat):
            counts[tuple(np.round(row.astype(np.float64), 6))] += 1
            n += 1
    if n == 0 or total_seconds <= 0:
        return {"bitrate": 0.0, "n_frames": 0, "n_distinct": 0, "entropy_bits": 0.0}
    p = np.array(list(counts.values()), np.float64) / n
    H = float(-(p * np.log2(p)).sum())
    return {"bitrate": n * H / total_seconds, "n_frames": n, "n_distinct": len(counts), "entropy_bits": H}


def _has_discrete_codes(model) -> bool:
    """True when ``model.encode`` emits quantized (finite-alphabet) frames."""
    from wavenet_autoencoders_tpu_torch.models.mfcc_ae import CatMfccAE
    from wavenet_autoencoders_tpu_torch.models.wae import CatWAE, VQWAE

    return isinstance(model, (VQWAE, CatWAE, CatMfccAE))


@torch.no_grad()
def export_representations(
    cfg: Config,
    model,
    scp_path: str,
    dst_dir: str,
    feat: str = "mfcc.norm",
    batch_size: int = 8,
    pad_multiple: int | None = None,
    lan: str | None = None,
    compute_bitrate: bool = True,
    pre_vq: bool = False,
    device: str | torch.device = "cuda",
):
    """Encode every utterance in the scp json and write ABX txt files, plus
    ``bitrate.json`` for discrete codes. The model must live on ``device``."""
    dev = check_on(model, device)
    file_list = json.load(open(scp_path))
    ds = 100 // cfg.frame_rate if pad_multiple is None else pad_multiple

    if pre_vq:
        import inspect

        if "pre_vq" not in inspect.signature(model.encode).parameters:
            raise ValueError(
                f"{type(model).__name__} has no pre-quantization latent "
                "(--pre-vq applies to VQ models only)"
            )
        compute_bitrate = False  # continuous export: symbol entropy undefined
    if compute_bitrate and not _has_discrete_codes(model):
        print(
            f"bitrate.json skipped: model {type(model).__name__} has a "
            "continuous latent; the ZeroSpeech symbol-entropy bitrate is "
            "defined for discrete (VQ/Gumbel) codes only"
        )
        compute_bitrate = False

    items = []
    for _src, base_dir in file_list:
        fp = Path(str(base_dir)) / f"{feat}.npy"
        if not fp.exists():
            raise FileNotFoundError(fp)
        x = np.load(fp)
        T = x.shape[0]
        Tp = ((T + ds - 1) // ds) * ds
        bucket = ((Tp + 199) // 200) * 200  # 200-frame (2 s) buckets
        items.append((str(base_dir), x, T, bucket))
    buckets = defaultdict(list)
    for it in items:
        buckets[it[3]].append(it)

    enc_kw = {"pre_vq": True} if pre_vq else {}
    n, total_frames = 0, 0
    exported: list[np.ndarray] = []
    for bucket, group in sorted(buckets.items()):
        for i in range(0, len(group), batch_size):
            chunk = group[i : i + batch_size]
            c = np.zeros((len(chunk), bucket, chunk[0][1].shape[1]), np.float32)
            for j, (_d, x, T, _b) in enumerate(chunk):
                c[j, :T] = x
            lat = model.encode(torch.from_numpy(c).to(dev), **enc_kw).cpu().numpy()
            for j, (base_dir, _x, T, _b) in enumerate(chunk):
                n_lat = min(lat.shape[1], -(-T // ds))  # ceil(T/ds)
                out = lat[j, :n_lat]
                path = _out_path(base_dir, dst_dir, lan=lan)
                os.makedirs(os.path.dirname(path), exist_ok=True)
                np.savetxt(path, out, fmt="%.6f")
                if compute_bitrate:
                    exported.append(out)
                total_frames += n_lat
                n += 1
    if compute_bitrate and n:
        br = bitrate(exported, total_frames / float(cfg.frame_rate))
        with open(os.path.join(dst_dir, "bitrate.json"), "w") as f:
            json.dump(br, f, indent=2)
        print(f"bitrate: {br['bitrate']:.1f} bits/s over {br['n_frames']} frames "
              f"({br['n_distinct']} distinct symbols)")
    print(f"exported {n} representations -> {dst_dir}")
    return n
