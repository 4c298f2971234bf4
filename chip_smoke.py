#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py              # every phase
    python3 chip_smoke.py --phases 0,1 # a subset (0 always runs)

Phases (each raises on failure, so the script exits non-zero):

0. Card name and power limit (nvidia-smi), torch version; build every
   kernel from ``wavenet_autoencoders_tpu_torch/csrc`` and print the time.
1. K1 (the fused decode kernel) against its plain versions at svqwae full
   width, B=4, T=2560 (past the d=512 ring wrap), teacher mode, TF32 off:
   f32 kernel vs ``WaveNet.apply`` and vs the plain decode; bf16-storage
   kernel vs the bf16 plain decode and vs the f32 ``apply``.
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
   B=256, T=5120, bf16 storage, beside the bound.

Prints the kernel table as one JSON line, the nvidia-smi line, and last
``{"ok": true, "device": {...}}``. Without CUDA it exits non-zero and
prints no result. It imports only the port, never JAX.
"""
from __future__ import annotations

import argparse
import json
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


def teacher_inputs(net, B, T, rng):
    import torch

    codes = torch.from_numpy(rng.integers(0, net.out_channels, (B, T))).cuda()
    frames = -(-T // 640)
    lat = torch.from_numpy(rng.standard_normal((B, frames, net.cin_channels)).astype(np.float32)).cuda()
    c_up = net._align_conditioning(lat, frames * 640)[:, :T].contiguous()
    g = torch.from_numpy(rng.integers(0, net.n_speakers, (B,))).cuda()
    return codes, c_up, g


def phase1(res):
    import torch

    from wavenet_autoencoders_tpu_torch.kernels import decode as K

    _cfg, model = full_model(seed=1)
    net = model.wavenet
    B, T = 4, 2560
    with torch.no_grad():
        codes, c_up, g = teacher_inputs(net, B, T, np.random.default_rng(1))
        y_apply = net.apply(codes, c_up, g, upsampled=True)
        packed = K.pack_decode_weights(net)
        g_add = K.precompute_g_add(net, g)
        before = K.LAUNCHES
        out = {}
        for dt in ("float32", "bfloat16"):
            _, out[dt] = K.wavenet_decode(net, packed, T, 0, c_up, g_add, codes, True, dt)
        torch.cuda.synchronize()
        if K.LAUNCHES != before + 2:
            raise RuntimeError(f"launch counter moved by {K.LAUNCHES - before}, expected 2")
        plain = {}
        for dt in ("float32", "bfloat16"):
            _, plain[dt] = K.wavenet_decode_reference(net, packed, T, 0, c_up, g_add, codes, True, dt)
    errs = {
        "f32_vs_apply": (out["float32"] - y_apply).abs().max().item(),
        "f32_vs_plain": (out["float32"] - plain["float32"]).abs().max().item(),
        "bf16_vs_plain_bf16": (out["bfloat16"] - plain["bfloat16"]).abs().max().item(),
        "bf16_vs_apply_f32": (out["bfloat16"] - y_apply).abs().max().item(),
    }
    bounds = {"f32_vs_apply": TOL_F32, "f32_vs_plain": TOL_F32,
              "bf16_vs_plain_bf16": TOL_BF16_PLAIN, "bf16_vs_apply_f32": TOL_BF16_F32}
    log(f"phase 1: B={B} T={T} max|kernel - plain| {json.dumps(errs)} bounds {json.dumps(bounds)}")
    for k, e in errs.items():
        if not np.isfinite(e) or e > bounds[k]:
            raise AssertionError(f"K1 {k} = {e} exceeds {bounds[k]}")
    res["max_abs_err"] = errs["f32_vs_apply"]
    res["errors"] = errs
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
    rng = np.random.default_rng(3)
    test = tmp / "dump" / "english" / "test"
    utts = [f"V00{i % 2 + 1}_{1000 + i}" for i in range(4)]
    feats = {}
    for u in utts:
        (test / u).mkdir(parents=True)
        feats[u] = rng.standard_normal((200, 39)).astype(np.float32)
        np.save(test / u / "mfcc.norm.npy", feats[u])
    scp = tmp / "test_src_dst.json"
    scp.write_text(json.dumps([[f"wav/{u}.wav", str(test / u) + "/"] for u in utts]))
    sp2ind = tmp / "speaker2ind.json"
    sp2ind.write_text(json.dumps({"V001": 0, "V002": 1}))
    syn = tmp / "synthesis.txt"
    syn.write_text("".join(f"{u} V00{2 - i % 2}\n" for i, u in enumerate(utts)))
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
    res["launches"] = launches
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
        # where a step's time goes: full width at B=256 and B=4, and a
        # 20-layer net of width 16 at B=4, whose steps are almost all
        # barriers and per-stage latency (2L+3 stages per step)
        tiny = WaveNet(out_channels=256, layers=20, stacks=2, residual_channels=16, gate_channels=32,
                       skip_out_channels=16, cin_channels=16, dropout=0.0,
                       generator=torch.Generator().manual_seed(0)).cuda()
        short = 256
        breakdown = {}
        for name, m, b in (("full_B256", net, 256), ("full_B4", net, 4), ("width16_B4", tiny, 4)):
            cu = c_up[:b, :short, : m.cin_channels].contiguous()
            pk = K.pack_decode_weights(m)
            breakdown[name] = cuda_time(lambda: K.wavenet_decode(m, pk, short, 0, cu, dtype_str="bfloat16"),
                                        reps=1) / short
        log(f"phase 4: ms per step at T={short}: {json.dumps(breakdown)}")
    C, G, S, O, L = net.residual_channels, net.gate_channels, net.skip_out_channels, net.out_channels, net.n_layers
    cin = net.cin_channels
    mac_row_step = L * (3 * C * G + cin * G + (G // 2) * (C + S)) + S * S + S * O
    flop = 2.0 * mac_row_step * B * T
    n_weights = sum(v.numel() for v in packed.values())
    in_bytes = n_weights * 2 + c_up.numel() * 2 + g_add.numel() * 4
    out_bytes = B * T * O * 4 + B * T * 4
    t_ops = flop / H100_BF16_FLOPS * 1e3
    t_bytes = (in_bytes + out_bytes) / H100_BYTES_PER_S * 1e3
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
    })


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--phases", default="0,1,2,3,4")
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
    logs = build.build()
    log(f"phase 0: built {sorted(logs) or 'nothing (cached)'} in {time.perf_counter() - t0:.1f} s")
    for name, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")

    res = {"name": "wavenet_decode", "route": "cuda",
           "source": "wavenet_autoencoders_tpu_torch/csrc/decode.cu",
           "replaces": "wavenet_autoencoders_tpu/kernels/decode.py:352",
           "launches": None, "max_abs_err": None, "ms": None, "plain_ms": None,
           "bound_ms": None, "bound_by": None, "library_ms": None}
    if 1 in phases:
        phase1(res)
    if 2 in phases:
        phase2(res)
    if 3 in phases:
        with tempfile.TemporaryDirectory() as tmp:
            phase3(res, Path(tmp))
    if 4 in phases:
        phase4(res)

    print(json.dumps({"kernels": [res]}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
