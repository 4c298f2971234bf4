#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py              # every phase
    python3 chip_smoke.py --phases 0,1 # a subset (0 always runs)

Phases (each raises on failure, so the script exits non-zero):

0. Card name and power limit (nvidia-smi), torch version; build every
   kernel from ``wavenet_autoencoders_tpu_torch/csrc``, and K1's jitter
   build, and print the time, each kernel's registers and spills (ptxas),
   and K1's bf16 block plan at svqwae width (dynamic shared memory a block,
   resident weights).
1. K1 (the fused decode kernel) against its plain versions at svqwae full
   width, teacher mode, TF32 off: at B=4, T=2560 (past the d=512 ring
   wrap) the f32 kernel vs ``WaveNet.apply`` and vs the plain decode, and
   the bf16-storage kernel vs the bf16 plain decode and vs the f32
   ``apply``; the bf16 kernel likewise at B=256 and B=37 (T=1100), B=1,
   and on a full-width net without c and g. In every bf16 case the jitter
   build (``-DWAE_JITTER``: blocks sleep at random after their waits) must
   give the plain build's logits bit for bit, which a wait short of its
   stage breaks.
2. Sampling. K1 in sampling mode at the serving shape (svqwae, B=4,
   T=32000, bf16 storage, with c and g): its logits against ``WaveNet.apply``
   run on its own sampled codes fed back one step later (127 first). The
   in-kernel Gumbel-argmax: class frequencies of 65536 draws from known
   logits against their softmax. A spiked output bias gives class 42; a
   pinned scalar mixture gives samples at 0.5; the same seed repeats,
   another seed differs.
3. The serving path through the port's CLI on ``cuda``: ``infer`` (ABX
   export + bitrate.json) and ``synthesize --batch 4`` on 4 utterances of
   200 MFCC frames with a checkpoint written from seeded full-width svqwae
   weights. K1's launch counter is zeroed before and read after.
4. Times with CUDA events after a warm-up: K1 and its plain version at
   B=256, T=5120, bf16 storage, beside the bound; K1's ms per step at
   T=256 for B=256, 64, 4, 1 and a width-16 net at B=4; and, as a
   yardstick the port never calls, a CUDA graph of one teacher-mode step
   of the plain decode at B=4 and B=256.
5. K2/K3 (the fused GLU-stack forward and backward) against their plain
   versions at svqwae width (20 layers, residual 256, gate 368, skip 256,
   cin 64), B=2 x T=2048 and B=3 x T=2000 (a row tile straddles two batch
   rows), f32 with TF32 off and bf16 storage, and B=2 x T=2048 bf16 without
   conditioning (c and g_add None): skips, ab, the final residual and all
   gradients; K3 in f32 against autograd of the plain forward; two K3 calls
   bitwise equal. (Phase 7 repeats the bf16 check at the main path's B=40 x
   T=5120.)
6. Training through the port's CLI on ``cuda``: ``train --preset svqwae
   --hparams fused_stack=true --max-steps 3`` at B=40 x T=5120 in bf16 on a
   synthetic dump (48 utterances of 200 frames, 2 speakers). The K2/K3
   counters are zeroed before and read after (one launch each per step);
   every loss and grad norm is finite; the checkpoint and its ``_ema``
   sibling exist; ``infer`` runs on it; the first step's loss and grad norm
   agree with the unfused train step's from the same init and batch.
7. At B=40 x T=5120, bf16: K2 and K3 against their plain versions on the
   same inputs (skips, ab, the final residual and all ten gradients, at
   phase 5's bf16 tolerances); then their times and the plain versions'
   with CUDA events beside their bounds; whole train steps, fused and
   unfused, in turns (host clock after a synchronize), in samples/s; one
   step of each under torch.profiler: device time by kernel, and K2/K3's
   time and TFLOP/s by pass.
8. IN-WAE at full ``inae`` width through the CLI on ``cuda``: ``train
   --preset inae --hparams fused_stack=true --max-steps 3`` at B=10 x
   T=5120 bf16 on a synthetic dump (K2/K3 counted, step 1's loss and grad
   norm against the unfused step at phase 6's bounds), ``infer`` on its
   checkpoint (ABX frames against the port's CPU encode), ``synthesize
   --batch 4`` with the auto tar_c map from the ``train_no_dev`` dump
   (AdaIN; K1 counted); host seconds of each call.
9. The zoo's shapes. K1 in teacher mode against its plain versions at
   ``inae`` (speaker ids), ``new_inae`` (continuous g) and ``vocoder_raw``
   (scalar input, 10-mixture MoL, L=24, C=128, cin=80, cin_pad 2) width,
   f32 at 2e-4 and bf16 at phase 1's bounds with the jitter build bit for
   bit; the ``vocoder_raw`` MoL draw, fed back, against ``WaveNet.apply``;
   K2/K3 against their plain versions at ``vocoder_raw`` width and at
   cin=39 (padded to 40 by the wrapper), phase 5's tolerances; K2/K3 times
   at ``inae``'s B=10 x T=5120 and ``vocoder_raw``'s B=8 x T=10240 and K1's
   ms per step at T=256 (B=4, 256) at both widths, beside their bounds;
   then one CLI ``train`` step (fused, 4 layers, B=4) and ``synthesize``
   (``infer`` for the MFCC-only AEs) for every other family, each with the
   counters zeroed before and read after.
10. The recipe from wav files to a validated submission, through the port's
   CLI in-process at full svqwae width: a synthetic ZeroSpeech-2019 tree
   (1000 train wavs of 0.5-1.0 s over 10 speakers, 4 test wavs of 2 s,
   int16 at 16 kHz, from a seed), ``subset``, ``preprocess --preset
   svqwae`` of each split, ``cmvn``, ``normalize``, ``train`` (fused,
   B=40 x T=5120 bf16, 24 steps = one epoch, with the dev pass, the sample
   dumps at steps 12 and 24, the decode hooks and the profiler at steps
   10-15), ``infer`` on the test split and ``validate``. Fails unless K1,
   K2 and K3 launched exactly as the code predicts (2, 28, 24), every hook
   wrote its wavs and none was skipped, the dev scalars are finite, the
   dev loss recomputed from the final checkpoint with the kernel and with
   the plain stack agrees with the recorded one to 1e-4, the trace names
   K2's and K3's kernels, and ``validate`` counts 4 ABX files of 64
   columns. ``--phases 10`` runs it alone.

Prints the kernel table (K1, K2, K3; ``launches`` summed over every path
driven, ``launches_by_path`` each path's count) as one JSON line, the
nvidia-smi line, and last
``{"ok": true, "device": {...}}``. Without CUDA it exits non-zero and
prints no result. It imports only the port, never JAX.
"""
from __future__ import annotations

import argparse
import contextlib
import functools
import io
import json
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

# Tolerances (max abs over all logits; svqwae logits at random init are
# O(1), max ~0.8):
# - f32 kernel vs f32 plain (apply / plain decode): 2e-4, the JAX package's
#   own kernel tolerance (tests/test_decode_kernel.py:53); only the f32
#   summation order differs (observed ~6e-7 for the plain decode vs apply
#   at full width on the CPU).
# - bf16 kernel vs bf16 plain decode: 2e-2; both round weights, rings,
#   c_up and activations to bf16 at the same places, but a different
#   summation order can flip one bf16 rounding (relative 2^-9) that then
#   propagates.
# - bf16 kernel vs f32 apply: 5e-2; bf16 storage itself moves the logits
#   (the plain bf16 decode differs from f32 apply by ~5e-3 at full width
#   over 40 steps on the CPU), with 10x margin for the longer run.
# - sampled bf16 kernel vs f32 apply on the fed-back codes: 5e-2, as for
#   teacher mode; the net is a function of the inputs in its receptive
#   field, so the error does not grow with T. Feeding back a wrong input
#   (off by one step) moves the logits by ~0.35 at this init (measured on
#   the CPU over 2560 steps), which the run also checks stays above 2x the
#   bound.
# - bf16 jitter build vs the plain build of K1: 0, bit for bit. Every sum
#   is added in a fixed order, so only a read of data not yet written (a
#   wait short of its stage) can move a bit.
# - Gumbel-argmax frequencies vs softmax: 1e-2 abs per class over 65536
#   draws, 5.4 standard errors at the largest p (0.34). The noise with the
#   wrong sign moves a frequency by 0.11, exponential noise by 0.06, and
#   no noise by 0.66 (numpy simulation of the same logits).
TOL_F32 = 2e-4
TOL_BF16_PLAIN = 2e-2
TOL_BF16_F32 = 5e-2
TOL_FREQ = 1e-2
GUMBEL_CLASSES = (5, 37, 70, 101, 140, 171, 200, 251)
GUMBEL_LOGITS = (0.0, 0.4, 0.8, 1.2, 1.6, 2.0, 2.4, 2.8)

H100_BF16_FLOPS = 989e12   # dense bf16 tensor-core peak, H100 SXM data sheet
H100_BYTES_PER_S = 3.35e12  # HBM3 bandwidth, H100 SXM data sheet


def log(*a):
    print(*a, flush=True)


def smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr}")
    return out.stdout.strip().splitlines()[0]


@contextlib.contextmanager
def k1_build(define: str):
    """Run K1's wrapper on the build of ``csrc/decode.cu`` compiled with
    ``-D<define>`` (``WAE_JITTER``, ``WAE_STAMPS``) inside the block."""
    from wavenet_autoencoders_tpu_torch.kernels import decode as K

    plain = K._lib
    K._lib = functools.partial(plain, (define,))
    try:
        yield
    finally:
        K._lib = plain


def cuda_time(fn, reps: int, warmup: bool = True) -> float:
    """Mean ms per call with CUDA events (after one warm-up call unless
    ``warmup`` is false)."""
    import torch

    if warmup:
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def full_model(seed=0):
    from wavenet_autoencoders_tpu_torch.config import load_preset
    from wavenet_autoencoders_tpu_torch.models import build_model

    cfg = load_preset("svqwae")
    return cfg, build_model(cfg, device="cuda", seed=seed)


def teacher_inputs(net, B, T, rng, cond=True):
    """Teacher-mode inputs of ``net`` on the card: codes (mu-law) or samples
    in [-1, 1] (scalar input), c_up from random latent frames through the
    net's upsampler (cin_pad context frames trimmed), and g: speaker ids
    with an embedding, continuous (B, gin) codes without one, else None."""
    import torch

    if net.scalar_input:
        codes = torch.from_numpy(rng.uniform(-1.0, 1.0, (B, T)).astype(np.float32)).cuda()
    else:
        codes = torch.from_numpy(rng.integers(0, net.out_channels, (B, T))).cuda()
    if not cond:
        return codes, None, None
    up = int(np.prod(net.upsample_scales))
    frames = -(-T // up)
    lat = torch.from_numpy(rng.standard_normal((B, frames + 2 * net.cin_pad, net.cin_channels)).astype(np.float32))
    c_up = net._align_conditioning(lat.cuda(), frames * up)[:, :T].contiguous()
    if net.has_speaker_embedding():
        g = torch.from_numpy(rng.integers(0, net.n_speakers, (B,))).cuda()
    elif net.gin_channels > 0:
        g = torch.from_numpy(rng.standard_normal((B, net.gin_channels)).astype(np.float32)).cuda()
    else:
        g = None
    return codes, c_up, g


def k1_errors(net, B, T, rng, dtypes, cond=True):
    """Teacher-mode logits of K1 at (B, T) against the plain decode in the
    same storage and against the f32 ``apply``, and in bf16 the jitter
    build's against the plain build's: {name: max abs difference}."""
    import torch

    from wavenet_autoencoders_tpu_torch.kernels import decode as K

    with torch.no_grad():
        codes, c_up, g = teacher_inputs(net, B, T, rng, cond)
        y_apply = net.apply(codes[..., None] if net.scalar_input else codes, c_up, g, upsampled=True)
        packed = K.pack_decode_weights(net)
        g_add = K.precompute_g_add(net, g)
        before = K.LAUNCHES
        out = {dt: K.wavenet_decode(net, packed, T, 0, c_up, g_add, codes, True, dt)[1] for dt in dtypes}
        torch.cuda.synchronize()
        if K.LAUNCHES != before + len(dtypes):
            raise RuntimeError(f"launch counter moved by {K.LAUNCHES - before}, expected {len(dtypes)}")
        with k1_build("WAE_JITTER"):
            jittered = K.wavenet_decode(net, packed, T, 0, c_up, g_add, codes, True, "bfloat16")[1]
        plain = {dt: K.wavenet_decode_reference(net, packed, T, 0, c_up, g_add, codes, True, dt)[1] for dt in dtypes}
    errs = {"bf16_jitter_vs_plain_build": (jittered - out["bfloat16"]).abs().max().item()}
    if "float32" in dtypes:
        errs["f32_vs_apply"] = (out["float32"] - y_apply).abs().max().item()
        errs["f32_vs_plain"] = (out["float32"] - plain["float32"]).abs().max().item()
    errs["bf16_vs_plain_bf16"] = (out["bfloat16"] - plain["bfloat16"]).abs().max().item()
    errs["bf16_vs_apply_f32"] = (out["bfloat16"] - y_apply).abs().max().item()
    return errs


def phase1(res):
    import torch

    from wavenet_autoencoders_tpu_torch.models.wavenet import WaveNet

    _cfg, model = full_model(seed=1)
    net = model.wavenet
    # full width without c and g (K = 3C in the gate product, no g_add)
    bare = WaveNet(out_channels=256, layers=20, stacks=2, residual_channels=256, gate_channels=368,
                   skip_out_channels=256, dropout=0.0, generator=torch.Generator().manual_seed(1)).cuda()
    # the old case (f32 and bf16), then bf16 at B=256 and a ragged B=37 past
    # the d=512 ring wrap (the large-batch schedule and the tile edges), B=1,
    # and the net without conditioning
    cases = [("B4_T2560", net, 4, 2560, ("float32", "bfloat16"), True),
             ("B256_T1100", net, 256, 1100, ("bfloat16",), True),
             ("B37_T1100", net, 37, 1100, ("bfloat16",), True),
             ("B1_T1100", net, 1, 1100, ("bfloat16",), True),
             ("nocond_B4_T1100", bare, 4, 1100, ("bfloat16",), False)]
    bounds = {"f32_vs_apply": TOL_F32, "f32_vs_plain": TOL_F32,
              "bf16_vs_plain_bf16": TOL_BF16_PLAIN, "bf16_vs_apply_f32": TOL_BF16_F32,
              "bf16_jitter_vs_plain_build": 0.0}
    out = {}
    for name, m, B, T, dts, cond in cases:
        errs = k1_errors(m, B, T, np.random.default_rng(1), dts, cond)
        log(f"phase 1: {name}: max|kernel - plain| {json.dumps(errs)} bounds {json.dumps(bounds)}")
        for k, e in errs.items():
            if not np.isfinite(e) or e > bounds[k]:
                raise AssertionError(f"K1 {name} {k} = {e} exceeds {bounds[k]}")
        out[name] = errs
    # the main path's storage: the bf16 kernel against the bf16 plain decode
    res["max_abs_err"] = max(e["bf16_vs_plain_bf16"] for e in out.values())
    res["errors"] = out
    res["tolerances"] = bounds


def phase2(res):
    import torch

    from wavenet_autoencoders_tpu_torch.kernels import decode as K
    from wavenet_autoencoders_tpu_torch.models.wavenet import WaveNet

    _cfg, model = full_model(seed=2)
    net = model.wavenet
    rng = np.random.default_rng(2)
    with torch.no_grad():
        # sampling mode at the serving shape: the kernel's logits must be
        # apply's on the codes it sampled, each fed back one step later
        B, T = 4, 32000
        lat = torch.from_numpy(rng.standard_normal((B, T // 640, net.cin_channels)).astype(np.float32)).cuda()
        g = torch.tensor([3, 40, 99, 152], device="cuda")
        codes, lg = net.decode_kernel(T, c=lat, g=g, seed=11, dtype_str="bfloat16")
        start = torch.full((B, 1), 127, dtype=codes.dtype, device="cuda")
        fed = torch.cat([start, codes[:, :-1]], dim=1)
        fed_err = (lg - net.apply(fed, lat, g)).abs().max().item()
        # the same check against a wrong feedback (each code fed at its own
        # step) must fail, or the check could not see a wrong feedback
        wrong_err = (lg - net.apply(codes, lat, g)).abs().max().item()
        if not fed_err <= TOL_BF16_F32 or not wrong_err > 2 * TOL_BF16_F32:
            raise AssertionError(f"sampled logits vs apply on fed-back codes {fed_err} (bound {TOL_BF16_F32}); "
                                 f"vs a wrong feedback {wrong_err} (must exceed {2 * TOL_BF16_F32})")

        # the Gumbel-argmax draws: zero weights leave logits = bp2
        zeroed = {k: torch.zeros_like(v) for k, v in K.pack_decode_weights(net).items()}
        packed = {k: v.clone() for k, v in zeroed.items()}
        packed["bp2"].fill_(-30.0)  # below any live class plus any noise draw
        live = torch.tensor(GUMBEL_CLASSES, device="cuda")
        packed["bp2"][live] = torch.tensor(GUMBEL_LOGITS, device="cuda")
        draws, _ = K.wavenet_decode(net, packed, 1024, 5, c_up=torch.zeros(64, 1024, net.cin_channels,
                                                                           device="cuda"))
        counts = torch.bincount(draws.flatten().long(), minlength=net.out_channels)
        if counts[live].sum().item() != draws.numel():
            raise AssertionError("Gumbel-argmax drew a class whose logit is -30")
        freq = (counts[live].double() / draws.numel()).cpu().numpy()
        want = torch.softmax(torch.tensor(GUMBEL_LOGITS, dtype=torch.float64), 0).numpy()
        freq_err = float(np.abs(freq - want).max())
        log(f"phase 2: sampled B={B} T={T} bf16: max|logits - apply(fed-back codes)| {fed_err:.5f} "
            f"(bound {TOL_BF16_F32}), wrong feedback {wrong_err:.4f}; Gumbel-argmax over {draws.numel()} draws: "
            f"freq {np.round(freq, 4).tolist()} vs softmax {np.round(want, 4).tolist()}, max diff {freq_err:.5f} "
            f"(bound {TOL_FREQ})")
        if not freq_err <= TOL_FREQ:
            raise AssertionError(f"Gumbel-argmax frequencies differ from softmax by {freq_err}")

        packed = {k: v.clone() for k, v in zeroed.items()}
        packed["bp2"][42] = 30.0
        c0 = torch.zeros(4, 64, net.cin_channels, device="cuda")
        codes, _ = K.wavenet_decode(net, packed, 64, 0, c_up=c0, dtype_str="bfloat16")
        frac42 = (codes == 42).float().mean().item()
        if frac42 < 0.95:
            raise AssertionError(f"spiked bias: {frac42:.3f} of codes are 42")
        pins = {}
        for dist in ("Logistic", "Normal"):
            snet = WaveNet(out_channels=30, layers=4, stacks=2, residual_channels=16, gate_channels=32,
                           skip_out_channels=16, dropout=0.0, scalar_input=True,
                           output_distribution=dist, generator=torch.Generator().manual_seed(0)).cuda()
            sp = {k: torch.zeros_like(v) for k, v in K.pack_decode_weights(snet).items()}
            sp["bp2"][10:20] = 0.5    # means
            sp["bp2"][20:30] = -10.0  # log scales
            s, _ = K.wavenet_decode(snet, sp, 32, 11, teach=torch.zeros(2, 32, device="cuda"))
            pins[dist] = (s - 0.5).abs().max().item()
            if pins[dist] > 1e-2:
                raise AssertionError(f"scalar {dist} pin: max |x - 0.5| = {pins[dist]}")
        c_up = net._align_conditioning(lat[:, :1], 640)[:, :256].contiguous()
        runs = [net.decode_kernel(256, c=c_up, g=g, seed=s, upsampled=True)[0] for s in (7, 7, 8)]
    same = bool(torch.equal(runs[0], runs[1]))
    differ = bool(not torch.equal(runs[0], runs[2]))
    log(f"phase 2: spiked bias -> {frac42:.4f} class 42; scalar pins max|x-0.5| {pins}; "
        f"same seed equal {same}; other seed differs {differ}")
    if not (same and differ):
        raise AssertionError("seeding: same seed must repeat and another seed must differ")
    res["sampling"] = {"fed_back_err": fed_err, "fed_back_tol": TOL_BF16_F32, "wrong_feedback_err": wrong_err,
                       "gumbel_freq_err": freq_err, "gumbel_freq_tol": TOL_FREQ, "gumbel_draws": draws.numel(),
                       "frac42": frac42, "scalar_pin_err": pins, "same_seed_equal": same,
                       "other_seed_differs": differ}


def phase3(res, tmp: Path):
    import torch
    from scipy.io import wavfile

    from wavenet_autoencoders_tpu_torch.cli.main import main as cli
    from wavenet_autoencoders_tpu_torch.kernels import decode as K
    from wavenet_autoencoders_tpu_torch.utils.params import flatten_params

    cfg, model = full_model(seed=3)
    ckpt = tmp / "checkpoint_step000000000.npz"
    np.savez(ckpt, step=np.int64(0),
             **{f"params/{k}": v.detach().cpu().numpy() for k, v in flatten_params(model).items()})
    test, utts, feats, syn, sp2ind, scp = make_test_set(tmp / "dump", np.random.default_rng(3), 4, 200, target=None)
    abx, wav_dir = tmp / "abx", tmp / "syn"

    K.LAUNCHES = 0
    t0 = time.perf_counter()
    cli(["infer", "--preset", "svqwae", "--device", "cuda", str(ckpt), str(scp), str(abx)])
    t1 = time.perf_counter()
    cli(["synthesize", "--preset", "svqwae", "--device", "cuda", "--batch", "4", str(ckpt),
         str(test), str(wav_dir), str(syn), str(sp2ind), "english"])
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    launches = K.LAUNCHES
    log(f"phase 3: infer {t1 - t0:.2f} s, synthesize {t2 - t1:.2f} s (host clock), K1 launches {launches}")
    if launches < 1:
        raise AssertionError("the serving path did not launch K1")

    # ABX export: files, bitrate.json, and agreement with the port's encode
    # on the CPU from the same checkpoint
    from wavenet_autoencoders_tpu_torch.cli.main import _load_model

    cpu_model = _load_model(cfg, str(ckpt), use_ema=False, device="cpu")
    match = []
    for u in utts:
        got = np.loadtxt(abx / "2019" / "english" / "test" / f"{u}.txt")
        if got.shape != (50, cpu_model.hid):
            raise AssertionError(f"ABX {u}: shape {got.shape}")
        with torch.no_grad():
            want = cpu_model.encode(torch.from_numpy(feats[u])[None])[0].numpy()
        match.append(np.all(np.abs(got - want) < 2e-6 + 1e-5, axis=1).mean())
    br = json.loads((abx / "bitrate.json").read_text())
    frac = float(np.mean(match))
    # a near-tie in the nearest-code search may resolve differently on
    # another device; anything beyond a couple of frames is a fault
    if frac < 0.98:
        raise AssertionError(f"ABX export agrees with the CPU encode on {frac:.3f} of frames")
    lens = []
    for i, u in enumerate(utts):
        sr, w = wavfile.read(wav_dir / "2019" / "english" / "test" / f"V00{2 - i % 2}_{u.split('_')[1]}.wav")
        lens.append(len(w))
        if len(w) != 32000 or sr != cfg.sample_rate or not np.isfinite(w.astype(np.float64)).all():
            raise AssertionError(f"wav {u}: {len(w)} samples at {sr} Hz")
    log(f"phase 3: ABX frames equal to the CPU encode {frac:.4f}; bitrate {br['bitrate']:.1f} bits/s; "
        f"wav lengths {lens}")
    count_launches(res, "svqwae_cli_synthesize", launches)
    res["serving"] = {"abx_match": frac, "bitrate": br["bitrate"], "wav_samples": lens,
                      "infer_s": t1 - t0, "synthesize_s": t2 - t1}


def phase4(res):
    import torch

    from wavenet_autoencoders_tpu_torch.kernels import decode as K
    from wavenet_autoencoders_tpu_torch.models.wavenet import WaveNet

    _cfg, model = full_model(seed=4)
    net = model.wavenet
    B, T = 256, 5120
    rng = np.random.default_rng(4)
    with torch.no_grad():
        c_up = torch.from_numpy(rng.standard_normal((B, T, net.cin_channels)).astype(np.float32)).cuda()
        c_up = c_up.to(torch.bfloat16)
        g = torch.from_numpy(rng.integers(0, net.n_speakers, (B,))).cuda()
        packed = K.pack_decode_weights(net)
        g_add = K.precompute_g_add(net, g)
        ms = cuda_time(lambda: K.wavenet_decode(net, packed, T, 0, c_up, g_add, dtype_str="bfloat16"), reps=2)
        # the plain version over the whole T, once, after a short warm-up
        K.wavenet_decode_reference(net, packed, 8, 0, c_up[:, :8], g_add, dtype_str="bfloat16")
        plain_ms = cuda_time(
            lambda: K.wavenet_decode_reference(net, packed, T, 0, c_up, g_add, dtype_str="bfloat16"),
            reps=1, warmup=False,
        )
        # where a step's time goes: full width at B=256, 64, 4 and 1, and a
        # 20-layer net of width 16 at B=4, whose steps are almost all
        # stage hand-offs and per-stage latency (2L+3 stages per step)
        tiny = WaveNet(out_channels=256, layers=20, stacks=2, residual_channels=16, gate_channels=32,
                       skip_out_channels=16, cin_channels=16, dropout=0.0,
                       generator=torch.Generator().manual_seed(0)).cuda()
        short = 256
        breakdown = {}
        for name, m, b in (("full_B256", net, 256), ("full_B64", net, 64), ("full_B4", net, 4), ("full_B1", net, 1),
                           ("width16_B4", tiny, 4)):
            cu = c_up[:b, :short, : m.cin_channels].contiguous()
            pk = K.pack_decode_weights(m)
            breakdown[name] = cuda_time(lambda: K.wavenet_decode(m, pk, short, 0, cu, dtype_str="bfloat16"),
                                        reps=1) / short
        log(f"phase 4: ms per step at T={short}: {json.dumps(breakdown)}")
        graph = {f"B{b}": reference_step_graph_ms(net, packed, b, rng) for b in (4, 256)}
        log(f"phase 4: yardstick, ms per step of a CUDA graph of one teacher-mode step of the plain decode "
            f"(bf16 storage, f32 products; the port never calls it): {json.dumps(graph)}")
    flop, t_ops, t_bytes = k1_bound(net, packed, B, T, has_g=True)
    audio_s = B * T / 16000.0
    log(f"phase 4: K1 B={B} T={T} bf16: {ms:.3f} ms/call = {audio_s / (ms / 1e3):.2f} audio-s/s; "
        f"{flop / 1e12:.3f} TFLOP -> bound {max(t_ops, t_bytes):.3f} ms (ops {t_ops:.3f}, bytes {t_bytes:.3f}), "
        f"{100 * max(t_ops, t_bytes) / ms:.2f}% of bound; plain version {plain_ms:.1f} ms/call")
    res.update({
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": max(t_ops, t_bytes),
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "library_ms": None,  # no single PyTorch call computes the AR decode
        "shape": f"B={B},T={T},bf16 storage",
        "flop": flop,
        "audio_s_per_s": audio_s / (ms / 1e3),
        "ms_per_step": breakdown,
        "graph_step_ms": graph,
    })


def k1_bound(net, packed, B, T, has_g):
    """(FLOP, ms bound by operations, ms bound by bytes) of one bf16 K1 call
    of T steps at batch B: the products of every step at the bf16 peak; the
    bf16 weights and c_up and the f32 g_add read once, the f32 logits and
    samples written once, over the HBM rate."""
    C, G, S, O, L = net.residual_channels, net.gate_channels, net.skip_out_channels, net.out_channels, net.n_layers
    cin = max(net.cin_channels, 0)
    mac_row_step = L * (3 * C * G + cin * G + (G // 2) * (C + S)) + S * S + S * O
    flop = 2.0 * mac_row_step * B * T
    n_weights = sum(v.numel() for v in packed.values())
    in_bytes = n_weights * 2 + B * T * cin * 2 + (L * B * G * 4 if has_g else 0)
    out_bytes = B * T * O * 4 + B * T * 4
    return flop, flop / H100_BF16_FLOPS * 1e3, (in_bytes + out_bytes) / H100_BYTES_PER_S * 1e3


def reference_step_graph_ms(net, packed, B, rng, reps=50) -> float:
    """ms per step of one teacher-mode step of ``wavenet_decode_reference``
    (its loop body at t=700, without the sampling draw: weights, rings, c
    and activations rounded to bf16, products in f32) captured in a CUDA
    graph and replayed: what eager PyTorch gives for a step once launch
    overhead is gone. A yardstick beside K1's ms per step."""
    import torch

    from wavenet_autoencoders_tpu_torch.kernels import decode as K

    def q(x):
        return x.to(torch.bfloat16).float()

    L, C, G, O = net.n_layers, net.residual_channels, net.gate_channels, net.out_channels
    G2, dev, t = G // 2, "cuda", 700
    w = {k: q(v) for k, v in packed.items() if k in K._WEIGHTS}
    offs = K._ring_offsets(net)
    ring = torch.from_numpy(rng.standard_normal((offs[-1], B, C)).astype(np.float32)).to(dev, torch.bfloat16)
    x = torch.from_numpy(rng.integers(0, O, (B,))).to(dev)
    c_t = q(torch.from_numpy(rng.standard_normal((B, net.cin_channels)).astype(np.float32)).to(dev))
    g_add = torch.from_numpy(0.1 * rng.standard_normal((L, B, G)).astype(np.float32)).to(dev)
    logits = torch.empty(B, O, device=dev)

    def step():
        h = w["w1"][x] + packed["b1"]
        skip = 0.0
        for l in range(L):
            d = net.dilation(l)
            s0, s1 = offs[l] + t % (2 * d), offs[l] + (t + d) % (2 * d)
            ab = (ring[s0].float() @ w["wconv"][l, 0] + ring[s1].float() @ w["wconv"][l, 1]
                  + q(h) @ w["wconv"][l, 2] + packed["bconv"][l] + c_t @ w["wc"][l] + g_add[l])
            act = q(torch.tanh(ab[:, :G2]) * torch.sigmoid(ab[:, G2:]))
            skip = skip + act @ w["wskip"][l] + packed["bskip"][l]
            out = act @ w["wout"][l] + packed["bout"][l]
            ring[s0] = h.to(torch.bfloat16)
            h = (out + h) * 0.7071067811865476
        y = q(torch.relu(skip * (1.0 / L) ** 0.5))
        y = q(torch.relu(y @ w["wp1"] + packed["bp1"]))
        logits.copy_(y @ w["wp2"] + packed["bp2"])

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            step()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        step()
    return cuda_time(graph.replay, reps)


def glu_inputs(B, T, store, rng, C=256, G=368, S=256, cin=64, L=20, stacks=2):
    """Seeded inputs of the GLU stack (default svqwae width: C=256, G=368,
    S=256, cin=64, L=20, dilations 1..512 twice) on the card: weights
    N(0, 1/fan_in) so that the residual stays O(1) over the layers."""
    import torch

    def mk(shape, std):
        return torch.from_numpy((std * rng.standard_normal(shape)).astype(np.float32)).cuda()

    x = mk((B, T, C), 0.5).to(store)
    c = mk((B, T, cin), 1.0).to(store)
    g_add = mk((B, L, G), 0.1)
    w = {"wconv": mk((L, 3, C, G), (3 * C) ** -0.5), "bconv": mk((L, G), 0.05),
         "wc": mk((L, cin, G), cin ** -0.5), "wout": mk((L, G // 2, C), (G // 2) ** -0.5),
         "bout": mk((L, C), 0.05), "wskip": mk((L, G // 2, S), (G // 2) ** -0.5), "bskip": mk((L, S), 0.05)}
    w = {k: (v if k.startswith("b") else v.to(store)) for k, v in w.items()}
    dils = tuple(2 ** (i % (L // stacks)) for i in range(L))
    return x, c, g_add, w, dils


FWD_OUTPUTS = ("skips", "ab", "hfin")
GLU_GRADS = ("dx", "dc", "dgadd", "dwconv", "dbconv", "dwc", "dwout", "dbout", "dwskip", "dbskip")
# Tolerances of K2/K3 against their plain versions, max abs error relative to
# the max abs of the plain value:
# - f32 (TF32 off): forward 1e-4, gradients 1e-3. Only the f32 summation
#   order differs (~1e-7 relative per sum), but the backward inverts the
#   residual update layer by layer, which multiplies the error of h by sqrt 2
#   per layer: 2^10 over 20 layers, ~1e-4 relative at layer 0.
# - bf16 storage: forward 2e-2, gradients 5e-2. Both versions round at the
#   same points, but a different summation order flips a bf16 rounding of
#   ab or act (2^-8 relative) now and then, and the flip propagates.
TOL_GLU = {"float32": (1e-4, 1e-3), "bfloat16": (2e-2, 5e-2)}


def rel_err(a, b) -> float:
    return ((a.float() - b.float()).abs().max() / b.float().abs().max().clamp_min(1e-30)).item()


def glu_errors(fwd, p_fwd, grads, p_grads):
    """Errors of K2's (skips, hfin, ab) and K3's ten gradients against their
    plain versions: ({output: max abs error relative to the plain max},
    largest abs error of K2, largest abs error of K3)."""
    fwd = dict(zip(("skips", "hfin", "ab"), fwd))
    p_fwd = dict(zip(("skips", "hfin", "ab"), p_fwd))
    for n, g, p in zip(GLU_GRADS, grads, p_grads):
        if (g is None) != (p is None):
            raise AssertionError(f"K3 returned {n} {'None' if g is None else 'a tensor'}, its plain version not")
    live = [(n, g, p) for n, g, p in zip(GLU_GRADS, grads, p_grads) if g is not None]
    errs = {k: rel_err(fwd[k], p_fwd[k]) for k in FWD_OUTPUTS}
    errs.update({n: rel_err(g, p) for n, g, p in live})
    abs2 = max((fwd[k].float() - p_fwd[k].float()).abs().max().item() for k in FWD_OUTPUTS)
    abs3 = max((g.float() - p.float()).abs().max().item() for _, g, p in live)
    return errs, abs2, abs3


def check_glu(errs, name, where):
    tol_f, tol_b = TOL_GLU[name]
    for k, e in errs.items():
        tol = tol_f if k in FWD_OUTPUTS else tol_b
        if not np.isfinite(e) or e > tol:
            raise AssertionError(f"K2/K3 {where} {name}: {k} rel error {e} exceeds {tol}")


def phase5(k2, k3):
    import torch

    from wavenet_autoencoders_tpu_torch.kernels import glu_stack as K

    out, abs_err = {}, {"K2": 0.0, "K3": 0.0}
    # the last case has no conditioning: K = 3C in the gate product, N = C in dx
    cases = [(B, T, n, s, True) for B, T in ((2, 2048), (3, 2000))
             for n, s in (("float32", torch.float32), ("bfloat16", torch.bfloat16))]
    cases.append((2, 2048, "bfloat16", torch.bfloat16, False))
    for B, T, name, store, cond in cases:
        rng = np.random.default_rng(5 + B)
        x, c, g_add, w, dils = glu_inputs(B, T, store, rng)
        if not cond:
            c = g_add = w["wc"] = None
        args = (x, c, g_add, w["wconv"], w["bconv"], w["wc"], w["wout"], w["bout"], w["wskip"],
                w["bskip"], dils)
        dskips = torch.from_numpy(rng.standard_normal((B, T, 256)).astype(np.float32)).cuda().to(store)
        with torch.no_grad():
            skips, hfin, ab = K.glu_stack_forward(*args)
            p_skips, p_hfin, p_ab = K.glu_stack_forward_reference(*args)
            bargs = (c, ab, w["wconv"], w["wc"], w["wout"], w["bout"], w["wskip"], dils, cond)
            grads = K.glu_stack_backward(dskips, hfin, *bargs)
            again = K.glu_stack_backward(dskips, hfin, *bargs)
            plain = K.glu_stack_backward_reference(dskips, p_hfin, c, p_ab, *bargs[2:])
        torch.cuda.synchronize()
        errs, a2, a3 = glu_errors((skips, hfin, ab), (p_skips, p_hfin, p_ab), grads, plain)
        abs_err["K2"], abs_err["K3"] = max(abs_err["K2"], a2), max(abs_err["K3"], a3)
        bitwise = all(g is None or torch.equal(g, h) for g, h in zip(grads, again))
        if store == torch.float32:
            # K3 against autograd of the plain forward (leaves in GLU_GRADS order)
            leaves = [t.detach().clone().requires_grad_(True) for t in args[:-1]]
            s, _, _ = K.glu_stack_forward_reference(*leaves, dils)
            (s * dskips).sum().backward()
            errs.update({f"{n}_vs_autograd": rel_err(g, t.grad) for n, g, t in zip(GLU_GRADS, grads, leaves)})
        case = f"B={B} T={T} {name}" + ("" if cond else " c=None g_add=None")
        log(f"phase 5: {case}: bitwise-equal K3 reruns {bitwise}; "
            f"rel errors {json.dumps({k: float(f'{v:.3g}') for k, v in errs.items()})}")
        check_glu(errs, name, case)
        if not bitwise:
            raise AssertionError("two K3 calls on the same inputs differ")
        out[f"B{B}_T{T}_{name}" + ("" if cond else "_nocond")] = errs
    k2["max_rel_err"] = {case: max(e[k] for k in FWD_OUTPUTS) for case, e in out.items()}
    k3["max_rel_err"] = {case: max(v for k, v in e.items() if k not in FWD_OUTPUTS) for case, e in out.items()}
    k2["max_abs_err"], k3["max_abs_err"] = abs_err["K2"], abs_err["K3"]
    k2["tolerances_rel"] = k3["tolerances_rel"] = TOL_GLU


def make_dump(root: Path, rng, n_utts=48, frames=200, hop=160, split="train", raw=False, feat="mfcc", dim=39):
    """A synthetic training dump: ``train.txt`` and, per utterance,
    ``wave.npy`` (mu-law codes, or samples in [-1, 1] when ``raw``) and
    ``<feat>.norm.npy`` (``dim`` features a frame), 2 speakers."""
    lines, dirs = [], []
    for i in range(n_utts):
        d = root / "english" / split / f"V00{i % 2 + 1}_{2000 + i}"
        d.mkdir(parents=True)
        wave = rng.uniform(-1.0, 1.0, frames * hop).astype(np.float32) if raw else rng.integers(0, 256, frames * hop)
        np.save(d / "wave.npy", wave)
        np.save(d / f"{feat}.norm.npy", rng.standard_normal((frames, dim)).astype(np.float32))
        lines.append(f"{d}/|{frames}|{i % 2}|dummy")
        dirs.append(d)
    (root / "train.txt").write_text("\n".join(lines) + "\n")
    return dirs


def make_test_set(root: Path, rng, n_utts, frames, dim=39, target="V002"):
    """``<root>/english/test/<utt>/mfcc.norm.npy`` for ``n_utts`` utterances
    of speakers V001 and V002 in turns, a ``synthesis.txt`` sending each to
    ``target`` (None: to the other speaker), a speaker map and an ABX scp.
    Returns (test dir, utterance names, features, synthesis list, speaker
    map, scp)."""
    test = root / "english" / "test"
    utts = [f"V00{i % 2 + 1}_{1000 + i}" for i in range(n_utts)]
    feats = {}
    for u in utts:
        (test / u).mkdir(parents=True)
        feats[u] = rng.standard_normal((frames, dim)).astype(np.float32)
        np.save(test / u / "mfcc.norm.npy", feats[u])
    syn, sp2ind, scp = root / "synthesis.txt", root / "speaker2ind.json", root / "test_src_dst.json"
    syn.write_text("".join(f"{u} {target or f'V00{2 - i % 2}'}\n" for i, u in enumerate(utts)))
    sp2ind.write_text(json.dumps({"V001": 0, "V002": 1}))
    scp.write_text(json.dumps([[f"wav/{u}.wav", str(test / u) + "/"] for u in utts]))
    return test, utts, feats, syn, sp2ind, scp


# The first fused train step against the unfused one from the same init and
# batch, bf16 compute, relative difference. The fused path rounds the
# residual into the kernel to bf16 and keeps ab and act in bf16 where the
# unfused path keeps f32 activations.
# - loss: 1e-4. Sound kernels read 8e-7 to 1.1e-6 at B=40 x T=5120 (H100
#   runs of this script); a copy of K2 without the speaker addend g_add
#   reads 2.0e-3.
# - grad norm: 5e-3. Sound kernels read 5.4e-4 (bf16 products whose
#   roundings differ between the paths). A copy of K3 whose weight-gradient
#   reductions add only their first 32 of the 50 row chunks reads 2.4e-2,
#   while its loss is exact: the loss comes before the backward.
TOL_STEP1 = {"loss": 1e-4, "grad_norm": 5e-3}


def check_step1(cfg, dump: Path, fused: dict, where: str):
    """Run step 1 unfused from the same init and first batch of ``dump`` as
    the CLI's fused run, and hold the fused run's step-1 ``fused`` loss and
    grad norm against it to TOL_STEP1. Returns (unfused values, relative
    differences)."""
    import torch

    from wavenet_autoencoders_tpu_torch.data.dataset import WaveDataset, data_iterator
    from wavenet_autoencoders_tpu_torch.models import build_model
    from wavenet_autoencoders_tpu_torch.train.loop import batch_to_device
    from wavenet_autoencoders_tpu_torch.train.step import init_state, make_train_step

    cfg = cfg.replace(fused_stack=False)
    model = build_model(cfg, device="cuda").train()
    batch = next(data_iterator(WaveDataset(str(dump), cfg), cfg, prefetch=0,
                               transform=lambda b: batch_to_device(b, torch.device("cuda"))))
    _, m = make_train_step(cfg, model)(init_state(cfg, model), batch)
    unfused = {"loss": m["loss"].item(), "grad_norm": m["grad_norm"].item()}
    diff = {k: abs(fused[k] - unfused[k]) / abs(unfused[k]) for k in fused}
    log(f"{where}: step 1 fused {json.dumps(fused)} vs unfused {json.dumps(unfused)}: rel diff {json.dumps(diff)} "
        f"(bounds {json.dumps(TOL_STEP1)})")
    for k, tol in TOL_STEP1.items():
        if not diff[k] <= tol:
            raise AssertionError(f"{where}: fused step-1 {k} {fused[k]} vs unfused {unfused[k]}: rel diff {diff[k]}")
    return unfused, diff


def phase6(k2, k3, tmp: Path):
    import torch

    from wavenet_autoencoders_tpu_torch.cli.main import main as cli
    from wavenet_autoencoders_tpu_torch.config import load_preset
    from wavenet_autoencoders_tpu_torch.kernels import glu_stack as K

    dump, ckpt, abx = tmp / "dump", tmp / "exp", tmp / "abx"
    dirs = make_dump(dump, np.random.default_rng(6))
    K.LAUNCHES_FWD = K.LAUNCHES_BWD = 0
    t0 = time.perf_counter()
    cli(["train", "--preset", "svqwae", "--hparams", "fused_stack=true", "--device", "cuda",
         "--max-steps", "3", str(dump), str(ckpt)])
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    launches = (K.LAUNCHES_FWD, K.LAUNCHES_BWD)
    log(f"phase 6: train 3 steps at B=40 x T=5120 bf16 through the CLI: {t1 - t0:.2f} s host clock "
        f"(build and data included); K2/K3 launches {launches}")
    if launches != (3, 3):
        raise AssertionError(f"K2/K3 launched {launches} times in 3 fused train steps, expected (3, 3)")
    # 48 utterances at B=40 make one step per epoch, so the epoch records hold
    # every step's loss; the step records (step 1, and the last) the grad norms
    recs = [json.loads(line) for line in (ckpt / "logs" / "metrics.jsonl").read_text().splitlines()]
    losses = {r["step"]: r["loss"] for r in recs if r["phase"] == "train_no_dev_epoch"}
    gnorms = {r["step"]: r["grad_norm"] for r in recs if r["phase"] == "train_no_dev"}
    if sorted(losses) != [1, 2, 3] or sorted(gnorms) != [1, 3] or not np.isfinite(
            list(losses.values()) + list(gnorms.values())).all():
        raise AssertionError(f"metrics of the 3 steps: losses {losses}, grad norms {gnorms}")
    for name in ("checkpoint_step000000003.npz", "checkpoint_step000000003_ema.npz"):
        if not (ckpt / name).exists():
            raise AssertionError(f"{name} was not written")

    scp = tmp / "scp.json"
    scp.write_text(json.dumps([[f"wav/{d.name}.wav", f"{d}/"] for d in dirs[:4]]))
    cli(["infer", "--preset", "svqwae", "--device", "cuda", str(ckpt / "checkpoint_step000000003.npz"),
         str(scp), str(abx), "--lan", "english"])
    codes = [np.loadtxt(abx / "2019" / "english" / "test" / f"{d.name}.txt") for d in dirs[:4]]
    if any(a.shape != (50, 64) or not np.isfinite(a).all() for a in codes):
        raise AssertionError(f"ABX export of the trained checkpoint: {[a.shape for a in codes]}")

    log(f"phase 6: losses {[round(losses[s], 5) for s in (1, 2, 3)]}, grad norms steps 1, 3 "
        f"{[round(gnorms[s], 4) for s in (1, 3)]}; infer wrote {len(codes)} ABX files of 50 x 64")
    unfused, diff = check_step1(load_preset("svqwae"), dump, {"loss": losses[1], "grad_norm": gnorms[1]}, "phase 6")
    count_launches(k2, "svqwae_cli_train", launches[0])
    count_launches(k3, "svqwae_cli_train", launches[1])
    k2["train_path"] = {"steps": 3, "losses": [losses[s] for s in (1, 2, 3)],
                        "grad_norms_steps_1_3": [gnorms[s] for s in (1, 3)],
                        "step1_unfused": unfused, "step1_rel_diff": diff, "tol": TOL_STEP1,
                        "cli_train_s": t1 - t0}


def glu_bound(B, T, C=256, G=368, S=256, cin=64, L=20, has_g=True):
    """(K2 FLOP, K2 bytes, K3 FLOP, K3 bytes), by default at svqwae width, bf16
    storage: each input read once, each output written once (g_add and
    dgadd only with global conditioning)."""
    G2, rows = G // 2, B * T * L
    f2 = 2.0 * rows * ((3 * C + cin) * G + G2 * (C + S))
    # rebuild out; dact; dwout+dwskip; dwconv+dwc; dx+dc
    f3 = 2.0 * rows * (G2 * C + (C + S) * G2 + G2 * (C + S) + (3 * C + cin) * G + (3 * C + cin) * G)
    w_bf16 = 2 * L * (3 * C * G + cin * G + G2 * (C + S))
    b_f32 = 4 * L * (G + C + S)
    ab = 2 * B * L * T * G
    g = 4 * B * L * G if has_g else 0
    by2 = 2 * B * T * (C + cin) + g + w_bf16 + b_f32 + 2 * B * T * S + 4 * B * T * C + ab
    # in: dskips, hfin, c, ab, weights, bout; out: dx, dc, dgadd, f32 weight and bias grads
    by3 = (2 * B * T * S + 4 * B * T * C + 2 * B * T * cin + ab + w_bf16 + 4 * L * C
           + 2 * B * T * C + 4 * B * T * cin + g + 2 * w_bf16 + b_f32)
    return f2, by2, f3, by3


GLU_PASSES = ("GateOp", "OutOp", "gate_act_kernel", "RebuildOp", "DactOp", "W1Op", "W2Op", "DxOp",
              "reduce_kernel<W", "colsum_")


def glu_pass_flop(B, T, C=256, G=368, S=256, cin=64, L=20):
    """FLOP of each K2/K3 product pass over all layers (what the function
    needs; DxOp's dc columns also run over the two zero taps of wx, which
    are not counted)."""
    G2, rows = G // 2, 2.0 * B * T * L
    return {"GateOp": rows * (3 * C + cin) * G, "OutOp": rows * G2 * (C + S), "RebuildOp": rows * G2 * C,
            "DactOp": rows * (C + S) * G2, "W1Op": rows * G2 * (C + S), "W2Op": rows * (3 * C + cin) * G,
            "DxOp": rows * (3 * C + cin) * G}


def kernel_breakdown(fn):
    """Device time by kernel name over one call of ``fn`` (torch.profiler):
    [(name, ms, launches)] sorted by time. Empty when the profiler sees no
    device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    # kernels only: the host-side ops above them carry their children's time too
    rows = [(e.key, e.self_device_time_total / 1e3, e.count) for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    return sorted(rows, key=lambda r: -r[1])


def phase7(k2, k3):
    import torch

    from wavenet_autoencoders_tpu_torch.config import load_preset
    from wavenet_autoencoders_tpu_torch.kernels import glu_stack as K
    from wavenet_autoencoders_tpu_torch.models import build_model
    from wavenet_autoencoders_tpu_torch.train.step import init_state, make_train_step

    B, T = 40, 5120
    rng = np.random.default_rng(7)
    x, c, g_add, w, dils = glu_inputs(B, T, torch.bfloat16, rng)
    args = (x, c, g_add, w["wconv"], w["bconv"], w["wc"], w["wout"], w["bout"], w["wskip"], w["bskip"], dils)
    dskips = torch.from_numpy(rng.standard_normal((B, T, 256)).astype(np.float32)).cuda().to(torch.bfloat16)
    with torch.no_grad():
        # first the check at the main path's shape (50 row chunks of the
        # weight-gradient reductions, 20 time chunks of the column sums), at
        # phase 5's bf16 tolerances; K3 and its plain version on the same
        # inputs (K2's hfin and ab)
        fwd = K.glu_stack_forward(*args)
        p_fwd = K.glu_stack_forward_reference(*args)
        hfin, ab = fwd[1], fwd[2]
        bargs = (c, ab, w["wconv"], w["wc"], w["wout"], w["bout"], w["wskip"], dils, True)
        grads = K.glu_stack_backward(dskips, hfin, *bargs)
        p_grads = K.glu_stack_backward_reference(dskips, hfin, *bargs)
        torch.cuda.synchronize()
        errs, a2, a3 = glu_errors(fwd, p_fwd, grads, p_grads)
        del p_fwd, grads, p_grads
        log(f"phase 7: B={B} T={T} bfloat16 against the plain versions: "
            f"rel errors {json.dumps({k: float(f'{v:.3g}') for k, v in errs.items()})}")
        check_glu(errs, "bfloat16", f"B={B} T={T}")
        k2["max_abs_err"], k3["max_abs_err"] = max(k2["max_abs_err"] or 0.0, a2), max(k3["max_abs_err"] or 0.0, a3)
        k2["max_rel_err_main_shape"] = max(errs[k] for k in FWD_OUTPUTS)
        k3["max_rel_err_main_shape"] = max(v for k, v in errs.items() if k not in FWD_OUTPUTS)

        k2_ms = cuda_time(lambda: K.glu_stack_forward(*args), reps=3)
        k3_ms = cuda_time(lambda: K.glu_stack_backward(dskips, hfin, *bargs), reps=3)
        p2_ms = cuda_time(lambda: K.glu_stack_forward_reference(*args), reps=2)
        p3_ms = cuda_time(lambda: K.glu_stack_backward_reference(dskips, hfin, *bargs), reps=2)
    del fwd, ab, hfin, bargs
    f2, by2, f3, by3 = glu_bound(B, T)

    # whole train steps, fused and unfused, at the preset's shape, in turns
    def stepper(fused):
        cfg = load_preset("svqwae", f"fused_stack={str(fused).lower()}")
        model = build_model(cfg, device="cuda").train()
        st, step = init_state(cfg, model), make_train_step(cfg, model)
        r = np.random.default_rng(8)
        codes = torch.from_numpy(r.integers(0, 256, (B, T))).cuda()
        batch = {"x": codes, "y": codes[..., None], "lengths": torch.full((B,), T, device="cuda"),
                 "c": torch.from_numpy(r.standard_normal((B, T // 160, 39)).astype(np.float32)).cuda(),
                 "g": torch.from_numpy(r.integers(0, 153, (B,))).cuda()}
        torch.cuda.reset_peak_memory_stats()
        step(st, batch)  # warm-up
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() / 2**30

        def run(n=2):
            t0 = time.perf_counter()
            for _ in range(n):
                step(st, batch)
            torch.cuda.synchronize()
            return (time.perf_counter() - t0) / n * 1e3

        return run, peak

    unfused, peak_u = stepper(False)
    fused, peak_f = stepper(True)
    order = [("unfused", unfused), ("fused", fused), ("fused", fused), ("unfused", unfused)]
    times = {"unfused": [], "fused": []}
    for name, run in order:
        times[name].append(run())
    step_ms = {k: float(np.mean(v)) for k, v in times.items()}
    sps = {k: B * T / (v / 1e3) for k, v in step_ms.items()}
    rest = step_ms["fused"] - k2_ms - k3_ms
    log(f"phase 7: B={B} T={T} bf16: K2 {k2_ms:.2f} ms (plain {p2_ms:.2f}), K3 {k3_ms:.2f} ms (plain {p3_ms:.2f}); "
        f"train step fused {times['fused']} ms, unfused {times['unfused']} ms (host clock, 2 steps each, in turns) "
        f"= {sps['fused']:,.0f} vs {sps['unfused']:,.0f} samples/s; fused step minus K2+K3 {rest:.1f} ms; "
        f"peak memory fused {peak_f:.1f} GiB, unfused {peak_u:.1f} GiB")
    # where a step's device time goes, by kernel (one more step each)
    breakdown, pass_flop = {}, glu_pass_flop(B, T)
    log(f"phase 7: K2/K3 FLOP per pass {json.dumps({p: f'{v:.4g}' for p, v in pass_flop.items()})}")
    for name, run in (("fused", fused), ("unfused", unfused)):
        t0 = time.perf_counter()
        rows = kernel_breakdown(lambda: run(1))
        wall = (time.perf_counter() - t0) * 1e3
        busy = sum(r[1] for r in rows)
        passes = {p: sum(ms for k, ms, _ in rows if p in k) for p in GLU_PASSES}
        tflops = {p: pass_flop[p] / (passes[p] / 1e3) / 1e12 for p in pass_flop if passes[p] > 0}
        breakdown[name] = {"device_ms": busy, "wall_ms_profiled": wall,
                           "top": [(k[:100], ms, n) for k, ms, n in rows[:12]],
                           "glu_passes_ms": {p: v for p, v in passes.items() if v > 0},
                           "glu_passes_tflop_s": tflops}
        log(f"phase 7: {name} step under the profiler: device busy {busy:.1f} ms of {wall:.1f} ms wall; "
            f"K2/K3 passes ms {json.dumps({p: round(v, 2) for p, v in passes.items() if v > 0})}, "
            f"TFLOP/s {json.dumps({p: round(v, 1) for p, v in tflops.items()})}")
        for k, ms, n in rows[:12]:
            log(f"  {ms:9.3f} ms {n:5d}x  {k[:110]}")
    for rec, ms, plain, flop, nbytes in ((k2, k2_ms, p2_ms, f2, by2), (k3, k3_ms, p3_ms, f3, by3)):
        t_ops, t_bytes = flop / H100_BF16_FLOPS * 1e3, nbytes / H100_BYTES_PER_S * 1e3
        rec.update({"ms": ms, "plain_ms": plain, "bound_ms": max(t_ops, t_bytes),
                    "bound_by": "operations" if t_ops >= t_bytes else "bytes",
                    "library_ms": None,  # no single PyTorch call computes the stack or its backward
                    "shape": f"B={B},T={T},bf16 storage", "flop": flop, "bytes": nbytes})
        log(f"phase 7: {rec['name']}: {flop / 1e12:.3f} TFLOP, {nbytes / 1e9:.3f} GB -> bound {rec['bound_ms']:.3f} ms "
            f"(ops {t_ops:.3f}, bytes {t_bytes:.3f}); {100 * rec['bound_ms'] / ms:.2f}% of bound")
    k2["train_step"] = {"fused_ms": times["fused"], "unfused_ms": times["unfused"], "samples_per_s": sps,
                        "fused_minus_k2_k3_ms": rest, "peak_gib": {"fused": peak_f, "unfused": peak_u},
                        "profile": breakdown}
    k3["unfused_step_ms"] = k2["unfused_step_ms"] = step_ms["unfused"]


def count_launches(rec, path, n):
    """Add one path's launches of a kernel to its record; ``launches`` is
    the sum over every path this run drove."""
    rec.setdefault("launches_by_path", {})[path] = n
    rec["launches"] = sum(rec["launches_by_path"].values())


def read_metrics(ckpt_dir: Path) -> list[dict]:
    return [json.loads(line) for line in (ckpt_dir / "logs" / "metrics.jsonl").read_text().splitlines()]


def phase8(k1, k2, k3, tmp: Path):
    """IN-WAE at full inae width through the CLI: train (fused, bf16), ABX
    export, AdaIN synthesis with an auto tar_c map."""
    import torch
    from scipy.io import wavfile

    from wavenet_autoencoders_tpu_torch.cli.main import _load_model
    from wavenet_autoencoders_tpu_torch.cli.main import main as cli
    from wavenet_autoencoders_tpu_torch.config import load_preset
    from wavenet_autoencoders_tpu_torch.kernels import decode as K1
    from wavenet_autoencoders_tpu_torch.kernels import glu_stack as K

    rng = np.random.default_rng(8)
    dump, ckpt_dir, abx, wav_dir = tmp / "dump", tmp / "exp", tmp / "abx", tmp / "syn"
    make_dump(dump, rng, split="train_no_dev")
    test, utts, feats, syn, sp2ind, scp = make_test_set(dump, rng, 4, 200)
    secs, hp = {}, "fused_stack=true"
    K.LAUNCHES_FWD = K.LAUNCHES_BWD = 0
    t0 = time.perf_counter()
    cli(["train", "--preset", "inae", "--hparams", hp, "--device", "cuda", "--max-steps", "3",
         str(dump), str(ckpt_dir)])
    torch.cuda.synchronize()
    secs["train"] = time.perf_counter() - t0
    glu = (K.LAUNCHES_FWD, K.LAUNCHES_BWD)
    if glu != (3, 3):
        raise AssertionError(f"K2/K3 launched {glu} times in 3 fused inae train steps, expected (3, 3)")
    recs = [r for r in read_metrics(ckpt_dir) if r["phase"] == "train_no_dev"]
    step1 = next(r for r in recs if r["step"] == 1)
    if not all(np.isfinite([r["loss"], r["grad_norm"]]).all() for r in recs):
        raise AssertionError(f"inae train metrics not finite: {recs}")
    ckpt = ckpt_dir / "checkpoint_step000000003.npz"
    for f in (ckpt, ckpt_dir / "checkpoint_step000000003_ema.npz"):
        if not f.exists():
            raise AssertionError(f"{f.name} was not written")

    t0 = time.perf_counter()
    cli(["infer", "--preset", "inae", "--hparams", hp, "--device", "cuda", str(ckpt), str(scp), str(abx)])
    secs["infer"] = time.perf_counter() - t0
    K1.LAUNCHES = 0
    t0 = time.perf_counter()
    cli(["synthesize", "--preset", "inae", "--hparams", hp, "--device", "cuda", "--batch", "4", str(ckpt),
         str(test), str(wav_dir), str(syn), str(sp2ind), "english"])
    torch.cuda.synchronize()
    secs["synthesize"] = time.perf_counter() - t0
    launches = K1.LAUNCHES
    log(f"phase 8: inae through the CLI, host seconds {json.dumps({k: round(v, 2) for k, v in secs.items()})}; "
        f"K2/K3 launches {glu}, K1 launches {launches}")
    if launches < 1:
        raise AssertionError("inae synthesis did not launch K1")

    # ABX frames against the port's encode on the CPU from the same
    # checkpoint (the IN latent is continuous: f32 on two devices, written
    # '%.6f'; a wrong latent is off by O(1))
    cfg = load_preset("inae", hp)
    cpu_model = _load_model(cfg, str(ckpt), use_ema=False, device="cpu")
    abx_err = 0.0
    for u in utts:
        got = np.loadtxt(abx / "2019" / "english" / "test" / f"{u}.txt")
        if got.shape != (100, cpu_model.hid):
            raise AssertionError(f"ABX {u}: shape {got.shape}")
        with torch.no_grad():
            want = cpu_model.encode(torch.from_numpy(feats[u])[None])[0].numpy()
        abx_err = max(abx_err, float(np.abs(got - want).max()))
    if not abx_err <= 1e-3:
        raise AssertionError(f"ABX export differs from the CPU encode by {abx_err}")
    lens = []
    for u in utts:
        sr, w = wavfile.read(wav_dir / "2019" / "english" / "test" / f"V002_{u.split('_')[1]}.wav")
        lens.append(len(w))
        if len(w) != 32000 or sr != cfg.sample_rate or not np.isfinite(w.astype(np.float64)).all():
            raise AssertionError(f"wav {u}: {len(w)} samples at {sr} Hz")
    log(f"phase 8: ABX max|cuda - cpu| {abx_err:.2e} (bound 1e-3); wav lengths {lens}")
    _, diff = check_step1(cfg, dump, {"loss": step1["loss"], "grad_norm": step1["grad_norm"]}, "phase 8 inae")
    count_launches(k1, "inae_cli_synthesize", launches)
    count_launches(k2, "inae_cli_train", glu[0])
    count_launches(k3, "inae_cli_train", glu[1])
    k1["inae_cli"] = {"host_s": secs, "abx_max_abs_err": abx_err, "step1_rel_diff": diff, "wav_samples": lens}


# Widths of the zoo's kernel shapes: (preset, K2/K3 batch, K2/K3 T)
ZOO_SHAPES = (("inae", 10, 5120), ("vocoder_raw", 8, 10240))
# The CLI runs of phase 9, each at 4 layers in 2 stacks, B=4, fused stack:
# (label, preset, extra hparams, what serves the checkpoint)
ZOO_CLI = (
    ("wvae", "wvae", "", "synthesize"),
    ("ae", "ae", "", "synthesize"),
    ("inae1", "inae", "name=inae1", "synthesize"),
    ("new_inae", "new_inae", "", "synthesize"),
    ("catae", "catae", "", "synthesize"),
    ("syn", "syn", "", "synthesize"),
    ("vocoder", "vocoder", "", "synthesize"),
    ("vocoder_raw", "vocoder_raw", "", "synthesize"),
    ("mfcc_ae", "ae", "name=model2", "infer"),
    ("cat_mfcc_ae", "ae", "name=cat_ae,frame_rate=25", "infer"),
)


def zoo_model(preset, seed=9):
    from wavenet_autoencoders_tpu_torch.config import load_preset
    from wavenet_autoencoders_tpu_torch.models import build_model

    return build_model(load_preset(preset), device="cuda", seed=seed)


def phase9(k1, k2, k3, tmp: Path):
    """The zoo's kernel shapes: K1 at inae, new_inae and vocoder_raw width,
    the vocoder_raw MoL draw, K2/K3 at vocoder_raw width and cin = 39, their
    times, and one CLI train step plus synthesis (or ABX export) for every
    other family."""
    import torch

    from wavenet_autoencoders_tpu_torch.kernels import decode as K1
    from wavenet_autoencoders_tpu_torch.kernels import glu_stack as K

    bounds = {"f32_vs_apply": TOL_F32, "f32_vs_plain": TOL_F32,
              "bf16_vs_plain_bf16": TOL_BF16_PLAIN, "bf16_vs_apply_f32": TOL_BF16_F32,
              "bf16_jitter_vs_plain_build": 0.0}
    zoo1, zoo2, zoo3 = k1.setdefault("zoo", {}), k2.setdefault("zoo", {}), k3.setdefault("zoo", {})
    for preset, T in (("inae", 1100), ("new_inae", 1100), ("vocoder_raw", 600)):
        net = zoo_model(preset).wavenet
        errs = k1_errors(net, 4, T, np.random.default_rng(9), ("float32", "bfloat16"))
        log(f"phase 9: K1 {preset} B=4 T={T} teacher mode: max|kernel - plain| {json.dumps(errs)}")
        for k, e in errs.items():
            if not np.isfinite(e) or e > bounds[k]:
                raise AssertionError(f"K1 {preset} {k} = {e} exceeds {bounds[k]}")
        zoo1[f"{preset}_errors"] = errs
        k1["max_abs_err"] = max(k1["max_abs_err"] or 0.0, errs["bf16_vs_plain_bf16"])

    # the raw vocoder's MoL draw, each sample fed back one step later (0 first)
    net = zoo_model("vocoder_raw").wavenet
    rng = np.random.default_rng(10)
    B, T = 4, 4096
    with torch.no_grad():
        lat = torch.from_numpy(rng.standard_normal((B, T // 256 + 2 * net.cin_pad, 80)).astype(np.float32)).cuda()
        x, lg = net.decode_kernel(T, c=lat, seed=13, dtype_str="bfloat16")
        fed = torch.cat([torch.zeros(B, 1, device="cuda"), x[:, :-1]], dim=1)
        fed_err = (lg - net.apply(fed[..., None], lat)).abs().max().item()
        wrong_err = (lg - net.apply(x[..., None], lat)).abs().max().item()
    spread = x.float().std().item()
    log(f"phase 9: vocoder_raw MoL draw B={B} T={T} bf16: max|params - apply(fed-back samples)| {fed_err:.5f} "
        f"(bound {TOL_BF16_F32}), wrong feedback {wrong_err:.4f}; samples in [{x.min().item():.3f}, "
        f"{x.max().item():.3f}], std {spread:.4f}")
    if not fed_err <= TOL_BF16_F32 or not wrong_err > 2 * TOL_BF16_F32:
        raise AssertionError(f"MoL fed-back params vs apply {fed_err}; vs a wrong feedback {wrong_err}")
    if not (torch.isfinite(x).all() and x.abs().max().item() <= 1.0 and spread > 1e-3):
        raise AssertionError("MoL samples are not finite draws in [-1, 1]")
    zoo1["vocoder_raw_mol_draw"] = {"fed_back_err": fed_err, "wrong_feedback_err": wrong_err, "std": spread}

    # K2/K3 against their plain versions at vocoder_raw width and at cin = 39
    # (the wrapper zero-pads cin to 40), phase 5's tolerances
    widths = {"vocoder_raw": dict(C=128, G=256, S=128, cin=80, L=24, stacks=4), "cin39": dict(cin=39)}
    for name, w in widths.items():
        for dt, store in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
            rng = np.random.default_rng(11)
            x, c, g_add, wt, dils = glu_inputs(2, 2048, store, rng, **w)
            if name == "vocoder_raw":
                g_add = None  # gin = -1
            args = (x, c, g_add, wt["wconv"], wt["bconv"], wt["wc"], wt["wout"], wt["bout"], wt["wskip"],
                    wt["bskip"], dils)
            S = wt["wskip"].shape[-1]
            dskips = torch.from_numpy(rng.standard_normal((2, 2048, S)).astype(np.float32)).cuda().to(store)
            bargs = (c, None, wt["wconv"], wt["wc"], wt["wout"], wt["bout"], wt["wskip"], dils, g_add is not None)
            with torch.no_grad():
                fwd = K.glu_stack_forward(*args)
                p_fwd = K.glu_stack_forward_reference(*args)
                bargs = (c, fwd[2], *bargs[2:])
                grads = K.glu_stack_backward(dskips, fwd[1], *bargs)
                p_grads = K.glu_stack_backward_reference(dskips, fwd[1], *bargs)
            torch.cuda.synchronize()
            errs, a2, a3 = glu_errors(fwd, p_fwd, grads, p_grads)
            log(f"phase 9: K2/K3 {name} B=2 T=2048 {dt}: rel errors "
                f"{json.dumps({k: float(f'{v:.3g}') for k, v in errs.items()})}")
            check_glu(errs, dt, name)
            zoo2[f"{name}_{dt}_max_rel_err"] = max(errs[k] for k in FWD_OUTPUTS)
            zoo3[f"{name}_{dt}_max_rel_err"] = max(v for k, v in errs.items() if k not in FWD_OUTPUTS)
            k2["max_abs_err"], k3["max_abs_err"] = max(k2["max_abs_err"] or 0.0, a2), max(k3["max_abs_err"] or 0.0, a3)

    # K2/K3 against their plain versions at the zoo's training shapes (phase
    # 5's bf16 tolerances, K3 and its plain version on K2's hfin and ab, as
    # phase 7 does at svqwae's), their times, and K1 ms per step at T=256
    for preset, B, T in ZOO_SHAPES:
        net = zoo_model(preset).wavenet
        C, G, S, L, cin = net.residual_channels, net.gate_channels, net.skip_out_channels, net.n_layers, net.cin_channels
        has_g = net.gin_channels > 0
        rng = np.random.default_rng(12)
        x, c, g_add, wt, _ = glu_inputs(B, T, torch.bfloat16, rng, C=C, G=G, S=S, cin=cin, L=L, stacks=net.stacks)
        dils = tuple(net.dilation(i) for i in range(L))
        args = (x, c, g_add if has_g else None, wt["wconv"], wt["bconv"], wt["wc"], wt["wout"], wt["bout"],
                wt["wskip"], wt["bskip"], dils)
        dskips = torch.from_numpy(rng.standard_normal((B, T, S)).astype(np.float32)).cuda().to(torch.bfloat16)
        with torch.no_grad():
            fwd = K.glu_stack_forward(*args)
            p_fwd = K.glu_stack_forward_reference(*args)
            bargs = (c, fwd[2], wt["wconv"], wt["wc"], wt["wout"], wt["bout"], wt["wskip"], dils, has_g)
            grads = K.glu_stack_backward(dskips, fwd[1], *bargs)
            p_grads = K.glu_stack_backward_reference(dskips, fwd[1], *bargs)
            torch.cuda.synchronize()
            errs, a2, a3 = glu_errors(fwd, p_fwd, grads, p_grads)
            del p_fwd, grads, p_grads
            log(f"phase 9: K2/K3 {preset} B={B} T={T} bfloat16 against the plain versions: "
                f"rel errors {json.dumps({k: float(f'{v:.3g}') for k, v in errs.items()})}")
            check_glu(errs, "bfloat16", f"{preset} B={B} T={T}")
            k2["max_abs_err"], k3["max_abs_err"] = max(k2["max_abs_err"] or 0.0, a2), max(k3["max_abs_err"] or 0.0, a3)
            t2 = cuda_time(lambda: K.glu_stack_forward(*args), reps=3)
            t3 = cuda_time(lambda: K.glu_stack_backward(dskips, fwd[1], *bargs), reps=3)
            p2 = cuda_time(lambda: K.glu_stack_forward_reference(*args), reps=1)
            p3 = cuda_time(lambda: K.glu_stack_backward_reference(dskips, fwd[1], *bargs), reps=1)
        del fwd, bargs
        f2, by2, f3, by3 = glu_bound(B, T, C, G, S, cin, L, has_g)
        for rec, ms, plain, flop, nbytes in ((zoo2, t2, p2, f2, by2), (zoo3, t3, p3, f3, by3)):
            t_ops, t_bytes = flop / H100_BF16_FLOPS * 1e3, nbytes / H100_BYTES_PER_S * 1e3
            rec[f"{preset}_B{B}_T{T}"] = {"ms": ms, "plain_ms": plain, "bound_ms": max(t_ops, t_bytes),
                                          "bound_by": "operations" if t_ops >= t_bytes else "bytes"}
        zoo2[f"{preset}_B{B}_T{T}"]["max_rel_err"] = max(errs[k] for k in FWD_OUTPUTS)
        zoo3[f"{preset}_B{B}_T{T}"]["max_rel_err"] = max(v for k, v in errs.items() if k not in FWD_OUTPUTS)
        per_step = {}
        with torch.no_grad():
            packed = K1.pack_decode_weights(net)
            for b in (4, 256):
                codes, c_up, g = teacher_inputs(net, b, 256, rng)
                g_add = K1.precompute_g_add(net, g)
                ms = cuda_time(lambda: K1.wavenet_decode(net, packed, 256, 0, c_up, g_add, dtype_str="bfloat16"),
                               reps=1)
                flop, t_ops, t_bytes = k1_bound(net, packed, b, 256, g_add is not None)
                per_step[f"B{b}"] = {"ms_per_step": ms / 256, "bound_ms_per_step": max(t_ops, t_bytes) / 256,
                                     "bound_by": "operations" if t_ops >= t_bytes else "bytes"}
        zoo1[f"{preset}_T256"] = per_step
        log(f"phase 9: {preset} bf16: K2 {t2:.2f} ms (plain {p2:.2f}, bound {zoo2[f'{preset}_B{B}_T{T}']['bound_ms']:.3f}), "
            f"K3 {t3:.2f} ms (plain {p3:.2f}, bound {zoo3[f'{preset}_B{B}_T{T}']['bound_ms']:.3f}) at B={B} T={T}; "
            f"K1 at T=256 {json.dumps(per_step)}")

    zoo_cli(k1, k2, k3, tmp)


def zoo_cli(k1, k2, k3, tmp: Path):
    """One CLI train step (fused stack) at 4 layers, B=4, and synthesis of
    two utterances (ABX export for the feature AEs) for each family of
    ``ZOO_CLI``, each with the kernels' counters zeroed before and read
    after."""
    import torch
    from scipy.io import wavfile

    from wavenet_autoencoders_tpu_torch.cli.main import main as cli
    from wavenet_autoencoders_tpu_torch.config import load_preset
    from wavenet_autoencoders_tpu_torch.kernels import decode as K1
    from wavenet_autoencoders_tpu_torch.kernels import glu_stack as K

    out, totals = {}, {"K1": 0, "K2": 0, "K3": 0}
    for label, preset, hp, serve in ZOO_CLI:
        hp = ",".join(h for h in ("layers=4,stacks=2,batch_size=4,fused_stack=true", hp) if h)
        cfg = load_preset(preset, hp)
        raw, feat_dim = not cfg.is_mulaw_quantize, (80 if cfg.cin_channels == 80 else 39)
        root = tmp / label
        rng = np.random.default_rng(13)
        make_dump(root, rng, n_utts=8, frames=60, hop=cfg.get_hop_size(), split="train_no_dev", raw=raw,
                  feat="mel" if feat_dim == 80 else "mfcc", dim=feat_dim)
        test, utts, _, syn, sp2ind, scp = make_test_set(root, rng, 2, 40, dim=feat_dim)
        common = ["--preset", preset, "--hparams", hp, "--device", "cuda"]
        ckpt = root / "exp" / "checkpoint_step000000001.npz"
        K.LAUNCHES_FWD = K.LAUNCHES_BWD = K1.LAUNCHES = 0
        t0 = time.perf_counter()
        cli(["train", *common, "--max-steps", "1", "--feat-type", "mel" if feat_dim == 80 else "mfcc",
             str(root), str(root / "exp")])
        t1 = time.perf_counter()
        loss = next(r["loss"] for r in read_metrics(root / "exp") if r["phase"] == "train_no_dev")
        feature_ae = serve == "infer"
        if feature_ae:
            cli(["infer", *common, str(ckpt), str(scp), str(root / "abx")])
            files = [np.loadtxt(root / "abx" / "2019" / "english" / "test" / f"{u}.txt") for u in utts]
            if not all(np.isfinite(f).all() and f.size for f in files):
                raise AssertionError(f"{label}: ABX export not finite")
        else:
            cli(["synthesize", *common, "--batch", "2", str(ckpt), str(test), str(root / "syn"), str(syn),
                 str(sp2ind), "english"])
            files = [wavfile.read(root / "syn" / "2019" / "english" / "test" / f"V002_{u.split('_')[1]}.wav")[1]
                     for u in utts]
            if not all(len(w) and np.isfinite(w.astype(np.float64)).all() for w in files):
                raise AssertionError(f"{label}: synthesized waveforms empty or not finite")
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        n = {"K1": K1.LAUNCHES, "K2": K.LAUNCHES_FWD, "K3": K.LAUNCHES_BWD}
        log(f"phase 9: {label} ({preset} {hp}): train step loss {loss:.4f} in {t1 - t0:.2f} s, "
            f"{serve} {t2 - t1:.2f} s (host clock); launches {json.dumps(n)}; "
            f"outputs {[f.shape for f in files]}")
        if not np.isfinite(loss):
            raise AssertionError(f"{label}: train loss {loss}")
        if (n["K2"], n["K3"]) != ((0, 0) if feature_ae else (1, 1)):
            raise AssertionError(f"{label}: K2/K3 launched {n['K2']}, {n['K3']} times in one fused step")
        if not feature_ae and n["K1"] < 1:
            raise AssertionError(f"{label}: synthesis did not launch K1")
        out[label] = {"loss": loss, "train_s": t1 - t0, "serve_s": t2 - t1, "launches": n}
        for k in totals:
            totals[k] += n[k]
    for rec, k in ((k1, "K1"), (k2, "K2"), (k3, "K3")):
        count_launches(rec, "zoo_cli", totals[k])
    k1.setdefault("zoo", {})["cli"] = out


@contextlib.contextmanager
def tee_stdout():
    """Yield a buffer that receives a copy of everything printed inside the
    block (which still goes to stdout)."""
    out, buf = sys.stdout, io.StringIO()

    class Tee:
        def write(self, text):
            buf.write(text)
            return out.write(text)

        def flush(self):
            out.flush()

    with contextlib.redirect_stdout(Tee()):
        yield buf


def make_zs2019(root: Path, rng, n_train=1000, n_test=4, sr=16000):
    """A ZeroSpeech-2019 wav tree: ``english/train/unit`` (speakers
    S000..S007) and ``english/train/voice`` (V001, V002) with ``n_train``
    int16 wavs of 0.5-1.0 s (a sine at the speaker's f0 with harmonics, plus
    noise), and ``english/test`` with ``n_test`` wavs of 2 s."""
    from scipy.io import wavfile

    def wav(path, dur, f0):
        t = np.arange(int(dur * sr)) / sr
        y = sum(a * np.sin(2 * np.pi * k * f0 * t) for k, a in ((1, 0.3), (2, 0.1), (3, 0.05)))
        y = y * (1.0 + 0.3 * np.sin(2 * np.pi * 3.0 * t)) + 0.02 * rng.standard_normal(len(t))
        path.parent.mkdir(parents=True, exist_ok=True)
        wavfile.write(path, sr, (np.clip(y, -1, 1) * 32767).astype(np.int16))

    speakers = [("unit", f"S{i:03d}") for i in range(8)] + [("voice", "V001"), ("voice", "V002")]
    for i in range(n_train):
        kind, sp = speakers[i % len(speakers)]
        wav(root / "english" / "train" / kind / f"{sp}_{10000 + i}.wav", rng.uniform(0.5, 1.0),
            90.0 + 25.0 * (i % len(speakers)))
    for i in range(n_test):
        wav(root / "english" / "test" / f"S{100 + i}_{20000 + i}.wav", 2.0, 110.0 + 40.0 * i)


# Launches of the recipe's train call, as the loop makes them: 24 steps of
# B=40 over 990 train utterances are one epoch; one K2 and one K3 a fused
# step; a checkpoint and a sample dump (one forward-only K2) at steps 12
# and 24; at step 24 the train decode hook (K1 at B=1), then the epoch's
# dev pass over the 10 dev utterances (one batch: K2 on the live weights,
# K2 on the EMA shadow) and its AR decode of the first dev batch (K1).
RECIPE_LAUNCHES = {"K1": 2, "K2": 24 + 2 + 2, "K3": 24}
RECIPE_HP = ("fused_stack=true,checkpoint_interval=12,train_eval_interval=24,test_eval_epoch_interval=1,"
             "profile_dir={prof}")
# the dev loss recomputed from the final checkpoint against the loop's record
# (phase 6's step-1 loss bound: the same bf16 forward, or the unfused one)
TOL_DEV = 1e-4


def phase10(k1, k2, k3, tmp: Path):
    """The recipe end to end through the CLI: wav files -> subset ->
    preprocess -> cmvn -> normalize -> train (dev pass, hooks, profiler) ->
    infer -> validate."""
    import torch

    from wavenet_autoencoders_tpu_torch.cli.main import main as cli
    from wavenet_autoencoders_tpu_torch.config import load_preset
    from wavenet_autoencoders_tpu_torch.data.dataset import WaveDataset, data_iterator
    from wavenet_autoencoders_tpu_torch.kernels import decode as K1
    from wavenet_autoencoders_tpu_torch.kernels import glu_stack as K
    from wavenet_autoencoders_tpu_torch.models import build_model
    from wavenet_autoencoders_tpu_torch.train.checkpoint import load_checkpoint
    from wavenet_autoencoders_tpu_torch.train.loop import batch_to_device
    from wavenet_autoencoders_tpu_torch.train.step import init_state, make_eval_step

    raw, dump, scp, exp, sub = tmp / "raw", tmp / "dump", tmp / "scp", tmp / "exp", tmp / "sub"
    prof = tmp / "prof"
    hp = RECIPE_HP.format(prof=prof)
    secs = {}

    def timed(name, fn):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        secs[name] = time.perf_counter() - t0

    timed("make_wavs", lambda: make_zs2019(raw, np.random.default_rng(10)))
    timed("subset", lambda: cli(["subset", "english", str(raw), str(dump), str(scp)]))
    splits = {s: json.loads((scp / f"{s}_src_dst.json").read_text()) for s in ("train_no_dev", "dev", "test")}
    log(f"phase 10: subset: {json.dumps({s: len(v) for s, v in splits.items()})}")
    if [len(splits[s]) for s in ("train_no_dev", "dev", "test")] != [990, 10, 4]:
        raise AssertionError("subset's 1% dev rule should give 990 / 10 / 4 utterances")
    sp2ind = scp / "2019_speaker2ind_english.json"
    for split in splits:
        timed(f"preprocess_{split}", lambda: cli(["preprocess", "--preset", "svqwae", str(scp / f"{split}_src_dst.json"),
                                                  str(dump / "english" / split), str(sp2ind)]))
    timed("cmvn", lambda: cli(["cmvn", "mfcc", str(tmp / "cmvn.npz"), str(scp / "train_no_dev_src_dst.json")]))
    for split in splits:
        timed(f"normalize_{split}", lambda: cli(["normalize", str(scp / f"{split}_src_dst.json"), "mfcc",
                                                 str(tmp / "cmvn.npz")]))

    dev_dump = dump / "english" / "dev"
    K.LAUNCHES_FWD = K.LAUNCHES_BWD = K1.LAUNCHES = 0
    with tee_stdout() as out:
        timed("train", lambda: cli(["train", "--preset", "svqwae", "--hparams", hp, "--device", "cuda",
                                    "--dev-dump-root", str(dev_dump), "--max-steps", "24",
                                    str(dump / "english" / "train_no_dev"), str(exp)]))
    launches = {"K1": K1.LAUNCHES, "K2": K.LAUNCHES_FWD, "K3": K.LAUNCHES_BWD}
    text = out.getvalue()
    hooks = {f"{m[0]}{' ' + m[1] if m[1] else ''} {m[2]}": float(m[3]) for m in re.findall(
        r"^(save_states|eval_model)(?: \((\w+)\))? at step (\d+): ([\d.]+) s$", text, re.M)}
    hooks.update({f"dev pass {m[0]}": float(m[1]) for m in re.findall(
        r"^Step (\d+) \[dev\] .*, ([\d.]+) s\)$", text, re.M)})
    hooks.update({"trace export": float(m) for m in re.findall(r"^profile trace written to .* \(([\d.]+) s\)$",
                                                               text, re.M)})
    log(f"phase 10: train launches {json.dumps(launches)} (predicted {json.dumps(RECIPE_LAUNCHES)}); "
        f"hook host seconds {json.dumps(hooks)}")
    if launches != RECIPE_LAUNCHES:
        raise AssertionError(f"recipe train launched {launches}, the loop predicts {RECIPE_LAUNCHES}")
    if "skipped:" in text:
        raise AssertionError("a training hook was skipped: " + " | ".join(
            line for line in text.splitlines() if "skipped:" in line))
    inter = exp / "intermediate"
    want = [inter / "audio" / f"step{s:09d}_{k}.wav" for s in (12, 24) for k in ("predicted", "target")]
    want += [inter / f"{ph}_eval" / f"step000000024_{k}.wav" for ph in ("train_no_dev", "dev")
             for k in ("predicted", "target")]
    missing = [str(f.relative_to(exp)) for f in want if not f.exists() or f.stat().st_size <= 44]
    if missing:
        raise AssertionError(f"hook wavs missing or empty: {missing}")
    recs = read_metrics(exp)
    dev = [r for r in recs if r["phase"] == "dev"]
    dev_ep = [r for r in recs if r["phase"] == "dev_epoch"]
    if [r["step"] for r in dev] != [24] or [r["step"] for r in dev_ep] != [1] or not all(
            np.isfinite([r[k] for k in ("loss", "recon_loss", "aux_loss", "perplexity", "recon_loss_ema")]).all()
            for r in dev + dev_ep):
        raise AssertionError(f"dev scalars: {dev} {dev_ep}")

    # the recorded dev metrics again, from the final checkpoint on the same
    # dev batch (the dev iterator's own seed), with the kernel and without
    errs = {}
    for fused in (True, False):
        cfg = load_preset("svqwae", hp).replace(fused_stack=fused)
        model = build_model(cfg, device="cuda")
        state = load_checkpoint(init_state(cfg, model), exp / "checkpoint_step000000024.npz")
        batch = next(data_iterator(WaveDataset(str(dev_dump), cfg), cfg, batch_size=cfg.dev_batch_size, prefetch=0,
                                   epochs=1, transform=lambda b: batch_to_device(b, torch.device("cuda"))))
        K.LAUNCHES_FWD = 0
        m = make_eval_step(cfg, model)(state, batch)
        if K.LAUNCHES_FWD != (2 if fused else 0):
            raise AssertionError(f"dev recompute fused={fused} launched K2 {K.LAUNCHES_FWD} times")
        for k in ("loss", "recon_loss_ema"):
            errs[f"{'fused' if fused else 'plain'}_{k}"] = abs(float(m[k]) - dev[0][k]) / abs(dev[0][k])
        del model, state
    log(f"phase 10: dev loss {dev[0]['loss']:.6f}, EMA {dev[0]['recon_loss_ema']:.6f}, perplexity "
        f"{dev[0]['perplexity']:.2f}; recomputed from the checkpoint, rel err {json.dumps(errs)} (bound {TOL_DEV})")
    if not max(errs.values()) <= TOL_DEV:
        raise AssertionError(f"dev loss recomputed from the checkpoint differs from the record: {errs}")

    traces = sorted(prof.glob("*.json"))
    if len(traces) != 1:
        raise AssertionError(f"profile_dir holds {traces}, expected one trace")
    events = json.loads(traces[0].read_text())["traceEvents"]
    kernels = {e["name"] for e in events if e.get("cat") == "kernel"}
    named = {op: sum(op in n for n in kernels) for op in ("GateOp", "OutOp", "RebuildOp", "DxOp")}
    log(f"phase 10: trace {traces[0].name}: {traces[0].stat().st_size} bytes, {len(events)} events, "
        f"{len(kernels)} kernel names; K2/K3 passes named {json.dumps(named)}")
    if not all(named.values()):
        raise AssertionError(f"the trace does not name K2's and K3's kernels: {named}")

    timed("infer", lambda: cli(["infer", "--preset", "svqwae", "--hparams", hp, "--device", "cuda",
                                str(exp / "checkpoint_step000000024.npz"), str(scp / "test_src_dst.json"), str(sub),
                                "--lan", "english"]))
    with tee_stdout() as out:
        timed("validate", lambda: cli(["validate", str(sub)]))
    summary = re.search(r"submission OK: (\{.*\})", out.getvalue())
    summary = json.loads(summary.group(1).replace("'", '"')) if summary else None
    log(f"phase 10: validate {summary}; host seconds {json.dumps({k: round(v, 2) for k, v in secs.items()})}, "
        f"{sum(secs.values()):.1f} in all")
    if summary != {"txt": 4, "wav": 0, "txt_cols": 64}:
        raise AssertionError(f"validate: {summary}, expected 4 ABX files of 64 columns")
    for rec, k in ((k1, "K1"), (k2, "K2"), (k3, "K3")):
        count_launches(rec, "recipe_cli_train", launches[k])
    k1["recipe"] = {"host_s": secs, "hook_s": hooks, "dev_rel_err": errs, "trace_passes": named}


KERNELS = {
    "K1": ("wavenet_decode", "decode.cu", "wavenet_autoencoders_tpu/kernels/decode.py:352"),
    "K2": ("glu_stack_forward", "glu_stack.cu", "wavenet_autoencoders_tpu/kernels/glu_stack.py:157"),
    "K3": ("glu_stack_backward", "glu_stack.cu", "wavenet_autoencoders_tpu/kernels/glu_stack.py:355"),
}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--phases", default="0,1,2,3,4,5,6,7,8,9,10")
    phases = {int(p) for p in ap.parse_args(argv).phases.split(",")}

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from wavenet_autoencoders_tpu_torch.kernels import build

    card = smi()
    log(f"phase 0: {card}; torch {torch.__version__} cuda {torch.version.cuda}")
    t0 = time.perf_counter()
    logs = build.build(sorted(p.stem for p in build.CSRC.glob("*.cu")) + [("decode", ("WAE_JITTER",))])
    log(f"phase 0: built {sorted(logs) or 'nothing (cached)'} in {time.perf_counter() - t0:.1f} s")
    for name, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                log(f"  {name}: {line.strip()}")
    from wavenet_autoencoders_tpu_torch.config import load_preset
    from wavenet_autoencoders_tpu_torch.kernels import decode as K1

    cfg = load_preset("svqwae")
    plan = K1.block_plan(cfg.layers, cfg.residual_channels, cfg.gate_channels, cfg.skip_out_channels,
                         cfg.out_channels, cfg.cin_channels, torch.cuda.get_device_properties(0).multi_processor_count)
    share = plan.blk[:, 3] * 16
    log(f"phase 0: K1 bf16 (decode_tc_kernel) at svqwae width on {plan.n_blocks} blocks: dynamic shared memory "
        f"{plan.smem} bytes a block (resident weights {int(share.min())}..{int(share.max())} bytes, "
        f"{int(share.sum())} in all, + {plan.smem - int(share.max())} of partial sums); {len(plan.units)} tiles")

    res = {k: {"name": n, "route": "cuda", "source": f"wavenet_autoencoders_tpu_torch/csrc/{src}",
               "replaces": rep, "launches": None, "max_abs_err": None, "ms": None, "plain_ms": None,
               "bound_ms": None, "bound_by": None, "library_ms": None}
           for k, (n, src, rep) in KERNELS.items()}
    k1, k2, k3 = res["K1"], res["K2"], res["K3"]
    if 1 in phases:
        phase1(k1)
    if 2 in phases:
        phase2(k1)
    if 3 in phases:
        with tempfile.TemporaryDirectory() as tmp:
            phase3(k1, Path(tmp))
    if 4 in phases:
        phase4(k1)
    if 5 in phases:
        phase5(k2, k3)
    if 6 in phases:
        with tempfile.TemporaryDirectory() as tmp:
            phase6(k2, k3, Path(tmp))
    if 7 in phases:
        phase7(k2, k3)
    if 8 in phases:
        with tempfile.TemporaryDirectory() as tmp:
            phase8(k1, k2, k3, Path(tmp))
    if 9 in phases:
        with tempfile.TemporaryDirectory() as tmp:
            phase9(k1, k2, k3, Path(tmp))
    if 10 in phases:
        with tempfile.TemporaryDirectory() as tmp:
            phase10(k1, k2, k3, Path(tmp))

    print(json.dumps({"kernels": list(res.values())}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
