"""End-of-training quality evaluation (the port's copy of
``scripts/quality_eval.py``).

Given a trained experiment dir (frozen ``config.json`` + checkpoints) and
the quality corpus' dumps, it writes ``<exp_dir>/quality_metrics.json``:

1. reconstruction quality: an AR decode (``batch_wavegen`` on the model's
   device, so the fused decode kernel on the card) of dev and test
   utterances conditioned on their own MFCCs, scored against the
   ground-truth waveform with mel-spectrogram L1 and mel-cepstral
   distortion (MCD, dB);
2. the scale's calibration: the same metrics between mismatched
   ground-truth pairs (unrelated audio);
3. the training curves' data (train and dev loss, perplexity, aux loss by
   step) from ``logs/metrics.jsonl`` as ``<exp_dir>/curves.json`` (the
   plot itself needs matplotlib, which the port does not use).

    python -m wavenet_autoencoders_tpu_torch.quality recon <exp_dir> <qroot> [n_utts] [max_frames] \\
        [--checkpoint checkpoint_latest.npz] [--use-ema/--no-use-ema] [--device cuda]
"""
from __future__ import annotations

import argparse
import json
import os
from pathlib import Path

import numpy as np

from wavenet_autoencoders_tpu_torch import dsp
from wavenet_autoencoders_tpu_torch.config import Config
from wavenet_autoencoders_tpu_torch.data.manifest import Manifest
from wavenet_autoencoders_tpu_torch.eval.synthesize import batch_wavegen
from wavenet_autoencoders_tpu_torch.utils.device import check_on

SPLITS = "dump/2019/english"


def mcd_db(mfcc_a: np.ndarray, mfcc_b: np.ndarray) -> float:
    """Mel-cepstral distortion in dB over c1..c12 (frame-aligned).

    ``dsp.mfcc`` cepstra come from the dB-scaled POWER mel spectrum; the
    classic MCD formula expects natural-log MAGNITUDE cepstra, so they are
    rescaled by ln(10)/10 (dB -> ln) and 1/2 (power -> magnitude) first.
    Values stay above classic SPTK-envelope MCD because 80-bin DCT cepstra
    keep spectral detail a smoothed envelope drops and the comparison is
    frame-locked (no DTW) on sampled audio; the mismatched-pair calibration
    anchors the scale."""
    n = min(len(mfcc_a), len(mfcc_b))
    scale = np.log(10.0) / 10.0 / 2.0
    d = scale * (mfcc_a[:n, 1:13] - mfcc_b[:n, 1:13])
    return float((10.0 / np.log(10)) * np.mean(np.sqrt(2.0 * np.sum(d * d, axis=1))))


def mel_l1(cfg, wav_a: np.ndarray, wav_b: np.ndarray) -> float:
    n = min(len(wav_a), len(wav_b))
    ma = dsp.logmelspectrogram(wav_a[:n], cfg)
    mb = dsp.logmelspectrogram(wav_b[:n], cfg)
    return float(np.mean(np.abs(ma - mb)))


def _at(root, path: str) -> str:
    """A manifest path, resolved against the corpus root when relative."""
    return path if root is None else os.path.join(root, path)


def reconstruction_metrics(cfg, model, dump_root, n_utts=12, out_dir=None, max_frames: int | None = None,
                           root=None, device="cuda"):
    """One AR decode (B=1) per utterance of the first ``n_utts`` of a dump,
    conditioned on its own normalized MFCCs (and speaker id when known),
    scored against the ground truth: rows of utt, mcd_db, mel_l1, dur_sec.
    ``root`` resolves the manifest's relative prefixes."""
    check_on(model, device)
    man = Manifest.read(dump_root)
    hop = cfg.get_hop_size()
    ds = 100 // cfg.frame_rate
    rows = []
    for u in man.utterances[:n_utts]:
        wave_codes = np.load(_at(root, u.path("wave")))
        feats = np.load(_at(root, u.path("mfcc", norm=True))).astype(np.float32)
        if max_frames is not None:
            mf = (max_frames // ds) * ds
            feats = feats[:mf]
            wave_codes = wave_codes[: mf * hop]
        gt = dsp.inv_mulaw_quantize(wave_codes.astype(np.float32), cfg.quantize_channels - 1)
        g = None if u.speaker_id < 0 else np.array([u.speaker_id], np.int32)
        wav = batch_wavegen(cfg, model, feats[None], g, device=device)[0]
        # the upsampler trims cin_pad latent frames each side: decoded
        # audio aligns with gt starting at cin_pad latent frames
        off = cfg.cin_pad * ds * hop if cfg.upsample_conditional_features else 0
        gt_a = gt[off : off + len(wav)]
        m_mcd = mcd_db(dsp.mfcc(gt_a, cfg).T, dsp.mfcc(wav[: len(gt_a)], cfg).T)
        m_l1 = mel_l1(cfg, gt_a, wav[: len(gt_a)])
        rows.append({"utt": u.prefix, "mcd_db": m_mcd, "mel_l1": m_l1, "dur_sec": len(wav) / cfg.sample_rate})
        if out_dir is not None:
            Path(out_dir).mkdir(parents=True, exist_ok=True)
            name = Path(u.prefix.rstrip("/")).name
            dsp.save_wav(wav, Path(out_dir) / f"{name}_decoded.wav", cfg.sample_rate)
            dsp.save_wav(gt_a, Path(out_dir) / f"{name}_ref.wav", cfg.sample_rate)
        print(f"{u.prefix}: MCD {m_mcd:.2f} dB, mel-L1 {m_l1:.3f}", flush=True)
    return rows


def mismatched_calibration(cfg, dump_root, n_utts=6, root=None) -> dict:
    """MCD and mel-L1 between each of the first ``n_utts`` ground-truth
    waves of a dump and the next one (cyclically): the unrelated-audio
    ceiling of the scale."""
    gts = []
    for u in Manifest.read(dump_root).utterances[:n_utts]:
        w = np.load(_at(root, u.path("wave"))).astype(np.float32)
        gts.append(dsp.inv_mulaw_quantize(w, cfg.quantize_channels - 1))
    pairs = [(gts[i], gts[(i + 1) % len(gts)]) for i in range(len(gts))]
    return {
        "mcd_db_mismatched_gt_pairs": float(np.mean([mcd_db(dsp.mfcc(a, cfg).T, dsp.mfcc(b, cfg).T)
                                                     for a, b in pairs])),
        "mel_l1_mismatched_gt_pairs": float(np.mean([mel_l1(cfg, a, b) for a, b in pairs])),
    }


def read_metrics(exp_dir) -> tuple[list[dict], list[dict]]:
    """(train, dev) records of ``<exp_dir>/logs/metrics.jsonl`` that carry a loss."""
    recs = [json.loads(line) for line in (Path(exp_dir) / "logs/metrics.jsonl").read_text().splitlines()]
    tr = [r for r in recs if r.get("phase") == "train_no_dev" and "loss" in r]
    dv = [r for r in recs if r.get("phase") == "dev" and "loss" in r]
    return tr, dv


def log_window(exp_dir, first: int, last: int) -> tuple[list[dict], float]:
    """The train log lines of steps ``first..last`` (both included; the
    closing line, which repeats the last step, counts once) and their mean
    loss: the window a quality run is held to."""
    by_step = {r["step"]: r for r in read_metrics(exp_dir)[0]}
    lines = [by_step[s] for s in sorted(by_step) if first <= s <= last]
    return lines, float(np.mean([r["loss"] for r in lines])) if lines else float("nan")


def curve_data(exp_dir, out_json) -> tuple[list[dict], list[dict]]:
    """The training curves' data (what ``scripts/quality_eval.py`` plots):
    train step / loss / perplexity / aux loss and dev step / loss."""
    tr, dv = read_metrics(exp_dir)
    curves = {
        "train": {k: [r.get(k) for r in tr] for k in ("step", "loss", "perplexity", "aux_loss")},
        "dev": {k: [r[k] for r in dv] for k in ("step", "loss")},
    }
    Path(out_json).write_text(json.dumps(curves))
    print(f"curves -> {out_json}")
    return tr, dv


def evaluate(exp_dir, qroot, n_utts=12, max_frames=None, checkpoint="checkpoint_latest.npz",
             use_ema="auto", device="cuda") -> dict:
    """Reconstruction of dev and test utterances, the calibration and the
    curves of one experiment; writes and returns ``quality_metrics.json``.
    ``use_ema="auto"`` takes the EMA shadow only once it is warm."""
    from wavenet_autoencoders_tpu_torch.cli.main import _load_model

    exp_dir, qroot = Path(exp_dir).resolve(), Path(qroot).resolve()
    cfg = Config.load(exp_dir / "config.json")
    model = _load_model(cfg, str(exp_dir / checkpoint), use_ema=use_ema, device=device)

    out = {"exp": str(exp_dir)}
    tr, dv = curve_data(exp_dir, exp_dir / "curves.json")
    out["train_loss_first"] = tr[0]["loss"] if tr else None
    out["train_loss_last"] = tr[-1]["loss"] if tr else None
    out["final_perplexity"] = tr[-1]["perplexity"] if tr else None
    if dv:
        out["dev_loss_last"] = dv[-1]["loss"]
    for split in ("dev", "test"):
        print(f"== reconstruction: {split} ==")
        rows = reconstruction_metrics(cfg, model, qroot / SPLITS / split, n_utts=n_utts,
                                      out_dir=exp_dir / f"recon_{split}", max_frames=max_frames, root=qroot,
                                      device=device)
        out[f"{split}_mcd_db_mean"] = float(np.mean([r["mcd_db"] for r in rows]))
        out[f"{split}_mel_l1_mean"] = float(np.mean([r["mel_l1"] for r in rows]))
    out["test_note"] = (
        "test speakers are UNSEEN (challenge setup): their speaker "
        "embeddings are untrained, so own-speaker test reconstruction is "
        "expected to be poor and is reported for completeness only. "
        "Fidelity is measured on dev (seen speakers); test-content "
        "quality is measured by the voice-conversion submission path "
        "(trained target voices), as in the reference."
    )
    out.update(mismatched_calibration(cfg, qroot / SPLITS / "test", root=qroot))
    (exp_dir / "quality_metrics.json").write_text(json.dumps(out, indent=2))
    print(json.dumps(out, indent=2))
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(prog="quality recon", description=__doc__.split("\n\n")[0])
    ap.add_argument("exp_dir")
    ap.add_argument("qroot")
    ap.add_argument("n_utts", nargs="?", type=int, default=12)
    ap.add_argument("max_frames", nargs="?", type=int, default=None)
    ap.add_argument("--checkpoint", default="checkpoint_latest.npz", help="file name in exp_dir")
    ap.add_argument("--use-ema", action=argparse.BooleanOptionalAction, default="auto",
                    help="the *_ema sibling (default: only once the shadow is warm)")
    ap.add_argument("--device", default="cuda", help="torch device (default cuda; 'cpu' to run on the CPU)")
    a = ap.parse_args(argv)
    return evaluate(a.exp_dir, a.qroot, a.n_utts, a.max_frames, a.checkpoint, a.use_ema, a.device)
