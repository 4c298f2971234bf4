"""Feature extraction pipeline (``preprocess_2019.py`` parity; counterpart of
``wavenet_autoencoders_tpu/data/preprocess.py``, writing the same files,
dtypes and ``train.txt`` rows).

Per utterance: load wav → trim (train only) → FIR high-pass → log-mel +
MFCC(39) → global gain → preemphasis → clip → mu-law target → pad/truncate
to N*hop → save ``wave.npy``/``mel.npy``/``mfcc.npy``; returns the manifest
row (dir, n_frames, speaker_ind, text).

Embarrassingly parallel per utterance. The process pool starts its workers
with ``spawn``: the caller may be a process that already holds a CUDA
context and runs threads (the CLI called in-process after training), and a
forked child would inherit both. The workers import only numpy, scipy and
this package's config and dsp modules; the start method changes no output.
As with any ``spawn`` pool, a script that calls ``preprocess`` with more
than one worker must guard its entry point with ``if __name__ ==
"__main__":`` (the CLI does). Each worker runs numpy's BLAS on one thread:
workers that each start a BLAS thread pool the size of the machine
oversubscribe its cores (7 workers took 3.8x as long on 600 utterances on
an 8-core host; a product's sum order does not depend on the thread count,
so the files are the same).
"""
from __future__ import annotations

import contextlib
import json
import multiprocessing
import os
from concurrent.futures import ProcessPoolExecutor
from pathlib import Path

import numpy as np

from wavenet_autoencoders_tpu_torch import dsp
from wavenet_autoencoders_tpu_torch.config import Config


def process_utterance(cfg: Config, wav_path: str, out_dir: str, sp2ind: dict) -> tuple:
    """``preprocess_2019.py:55-147``."""
    sp = Path(wav_path).name.split(".")[0].split("_")[0]
    sp_ind = sp2ind.get(sp, -1)

    wav = dsp.load_wav(wav_path, cfg.sample_rate)
    if "test" not in str(wav_path):
        wav, _ = dsp.trim_silence_db(wav, top_db=60, frame_length=2048, hop_length=512)
    if cfg.highpass_cutoff > 0:
        wav = dsp.low_cut_filter(wav, cfg.sample_rate, cfg.highpass_cutoff)

    # ascontiguousarray: np.save would otherwise write the transposed views
    # Fortran-order
    mel = np.ascontiguousarray(dsp.logmelspectrogram(wav, cfg).astype(np.float32).T)
    mfcc = np.ascontiguousarray(dsp.mfcc(wav, cfg).astype(np.float32).T)  # (N, 39)

    if cfg.global_gain_scale > 0:
        wav = wav * cfg.global_gain_scale
    if cfg.preprocess == "preemphasis":
        wav = dsp.preemphasis(wav, cfg.preemphasis_coef)
    wav = np.clip(wav, -1.0, 1.0)

    mu = cfg.quantize_channels - 1
    if cfg.is_mulaw_quantize:
        out = dsp.mulaw_quantize(wav, mu)
        constant = dsp.mulaw_quantize(0, mu)
        out_dtype = np.int16
    elif cfg.is_mulaw:
        out = dsp.mulaw(wav, mu)
        constant = dsp.mulaw(0.0, mu)
        out_dtype = np.float32
    else:
        out = wav
        constant = 0.0
        out_dtype = np.float32

    hop = cfg.get_hop_size()
    # right-pad by fft_size then truncate to N*hop (preprocess_2019.py:117-129)
    out = np.pad(out, (0, cfg.fft_size), mode="constant", constant_values=constant)
    N = mel.shape[0]
    assert len(out) >= N * hop
    out = out[: N * hop]
    assert mfcc.shape[0] == N

    d = Path(out_dir)
    d.mkdir(parents=True, exist_ok=True)
    prefix = str(d) + os.sep
    np.save(prefix + "wave.npy", out.astype(out_dtype), allow_pickle=False)
    np.save(prefix + "mel.npy", mel, allow_pickle=False)
    np.save(prefix + "mfcc.npy", mfcc, allow_pickle=False)
    return (prefix, N, sp_ind, "dummy")


_BLAS_THREADS = ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS")


@contextlib.contextmanager
def _one_blas_thread():
    """One BLAS thread in the processes started inside the block (they read
    the variables when numpy loads)."""
    saved = {k: os.environ.get(k) for k in _BLAS_THREADS}
    os.environ.update({k: "1" for k in _BLAS_THREADS})
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k)
            else:
                os.environ[k] = v


def _worker(args):
    cfg_json, wav_path, out_dir, sp2ind = args
    cfg = Config().parse_json(cfg_json)
    return process_utterance(cfg, wav_path, out_dir, sp2ind)


def preprocess(
    cfg: Config, scp_path: str, out_dir: str, sp2ind_path: str, num_workers: int | None = None
):
    """Preprocess every utterance of an scp json [(src_wav, dst_dir), ...]
    (``preprocess_2019.py:29-52``); writes train.txt."""
    from wavenet_autoencoders_tpu_torch.data.manifest import write_manifest

    src_files = json.load(open(scp_path))
    sp2ind = json.load(open(sp2ind_path))
    cfg_json = json.dumps(cfg.values())

    if num_workers is None:
        num_workers = max(1, (os.cpu_count() or 2) - 1)
    args = [(cfg_json, w, d, sp2ind) for w, d in src_files]
    if num_workers > 1 and len(args) > 8:
        ctx = multiprocessing.get_context("spawn")
        with _one_blas_thread(), ProcessPoolExecutor(max_workers=num_workers, mp_context=ctx) as ex:
            metadata = list(ex.map(_worker, args, chunksize=8))
    else:
        metadata = [_worker(a) for a in args]

    write_manifest(metadata, out_dir)
    frames = sum(m[1] for m in metadata)
    print(
        f"Wrote {len(metadata)} utterances, {frames} frames "
        f"({frames / 100 / 3600:.2f} hours)"
    )
    return metadata
