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
   conditioning (c and g_add None); in bf16 also ``vocoder_raw``'s widths
   (residual 128, gate 256, skip 128, cin 80, 24 layers in 4 stacks) at B=2
   x T=1500 and cin 40 at B=2 x T=700: skips, ab, the final residual and all
   gradients; K3 in f32 against autograd of the plain forward; two K2 calls
   and two K3 calls bitwise equal; K2's gate pass took the TMA + wgmma
   kernel (``LAUNCHES_GATE_WG``, one a layer) in every bf16 case and in no
   f32 one, and that kernel's sigmoid equals ``sigmoidf`` on every bf16
   input; K3's dx pass took the TMA + wgmma kernel (``LAUNCHES_DX_WG``, one
   a layer) in every bf16 case and in no f32 one, and K3's outputs on that
   route against K3 with the dx pass on ``gemm_pipe``, bit for bit or with
   the largest difference printed. (Phase 7 repeats the bf16 check at the
   main path's B=40 x T=5120.)
6. Training through the port's CLI on ``cuda``: ``train --preset svqwae
   --hparams fused_stack=true --max-steps 3`` at B=40 x T=5120 in bf16 on a
   synthetic dump (48 utterances of 200 frames, 2 speakers). The K2/K3
   counters are zeroed before and read after (one launch each per step, and
   20 gate layers and 20 dx layers on the TMA + wgmma kernels);
   every loss and grad norm is finite; the checkpoint and its ``_ema``
   sibling exist; ``infer`` runs on it; the first step's loss and grad norm
   agree with the unfused train step's from the same init and batch.
7. At B=40 x T=5120, bf16: K2 and K3 against their plain versions on the
   same inputs (skips, ab, the final residual and all ten gradients, at
   phase 5's bf16 tolerances); then their times and the plain versions'
   with CUDA events beside their bounds; the train step as a CUDA graph
   against the eager body, fused and unfused, from one initial state over
   the same 4 batches for 20 steps: two eager runs give the eager spread,
   and at steps 1 (eager in both), 2 (the first replay) and 20 the graphed
   run's loss, grad norm and every parameter, Adam moment and EMA-shadow
   value must equal the eager run's bit for bit where the two eager runs
   do, and lie within twice their spread elsewhere (printed: which held),
   with the capture's time and the counted launches a replay makes; then
   the four steps timed in turns (host clock after a synchronize, 3 steps
   a turn), in samples/s; one step of each under torch.profiler: device
   time and operations by kernel, the device-busy share of the timed step,
   and K2/K3's time and TFLOP/s by pass.
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
   columns. The recipe's batches come from the native loader (counted).
   ``--phases 10`` runs it alone.
11. Training at scale, at full svqwae width: the data-parallel step, two
   ranks on the one card (gloo on CUDA tensors, B=20 x T=5120 each, 3
   fused bf16 steps; each rank a ``--dp-worker`` subprocess printing its
   K2/K3 counters) against one process at B=40 (loss and grad norm per
   step at phase 6's bounds); ``train --coordinator 127.0.0.1:<port>
   --num-processes 1 --process-id 0`` (a process group over NCCL, its
   collectives counted); ``train`` with EMA codebooks, dead-code reseed,
   time jitter and VQ-dropout (K2/K3 3/3, codes reseeded at step 3, the
   checkpoint's ``model_state`` leaves, ``infer`` on it) and with dropout
   (K2/K3 0/0: the fused stack is skipped); host ms per B=40 batch of the
   native loader and the Python collate path (phase 10's dump when it ran);
   and the supervisor taking a 3-step ``train`` to done after its CUDA
   probe.
12. Tensor parallelism and reference weights, at full svqwae width. 12a:
   two ranks of one model group (``mesh_shape`` model 2, data 1) on the
   card (gloo on CUDA tensors; ``--tp-worker`` subprocesses), each on the
   whole B=40 x T=5120 batch, 3 fused and 3 unfused bf16 steps against one
   process (every loss and step 1's grad norm at phase 6's bounds; K2/K3
   3/3 on each rank fused, 0/0 unfused); per rank ms a step, model-group
   collectives and bytes a step, peak memory; the fused run's checkpoint
   (the one-process npz's keys and shapes) loaded in one process, its f32
   logits against the TP forward's; then ``train`` on the model group with
   the checkpoint, sample-dump and decode hooks (K1 on rank 0's gathered
   copy). 12b: a reference ``state_dict`` (the inverse mapping of seeded
   weights) saved with ``torch.save``, imported with ``import_checkpoint``
   on cuda (weights and logits bit for bit), then ``batch_wavegen`` at B=4
   (K1) and ``export_representations`` from it.
13. The quality run of SVQ-WAE run K (``quality2/exp/svqwae_r5_cs0005``) at
   its published widths (16 layers, frame rate 50, B=40 x T=5120 bf16,
   fused), through the port's ``quality`` tools: the sharp synthetic corpus
   (``quality.corpus``, a worker a core) and its dumps (``subset``,
   ``preprocess`` with run K's config, ``cmvn``, ``normalize``); the
   MFCC-baseline ABX, held to the CPU's value within 0.1 points; 1500 fused
   steps of run K's schedule (``quality.run``), held to run K's logged mean
   loss over steps 1050-1500 within 0.10 nats, perplexity >= 150 there, no
   collapse abort and K2/K3 launched as the loop predicts; ``infer`` and
   the ABX of the trained codes; reconstruction of 2 dev utterances (K1
   at B=1) with the mismatched-pair calibration; ``synthesize --batch 40``
   over the first 40 of the 80 test utterances and their F0; CE by segment
   class on 8 test utterances (K2); K1 and K2 launched as predicted; each
   beside its JAX run's record. Then each kernel against its plain version
   at this depth (L=16, frame rate 50): K2 on the inputs of CE's eight
   B=1 forwards (trained weights), K2/K3 at B=40 x T=5120 bf16 (seeded),
   both at phase 5's bf16 bounds, and K1 in teacher mode at B=1 and B=40
   (T=1100, seeded run-K-width weights) at phase 1's bounds; then K2/K3
   and K1 timed at this depth, beside their bounds. ``--phases 0,13`` runs
   it alone.
14. Run K to step 4000 (``--phases 0,14``, not in the default list): the
   same corpus and recipe, 4000 fused steps of run K's schedule (the lr
   halves at step 3000; the dev pass at step 2500), held to run K's mean
   loss over steps 3550-4000 within 0.10 nats, perplexity >= 150 there and
   K2/K3 launched as the loop predicts (steps, sample dumps, the dev
   pass); the ABX of the step-4000 codes held below the MFCC baseline's
   across speakers, beside run K's; the VC F0 of 40 utterances (K1 counted).
15. Run F, IN-WAE with AdaIN (``quality2/exp/inwae_r5``: encoder 384, gin
   64, no VQ, B=24; ``--phases 0,15``, not in the default list): 3000 fused
   steps of run F's schedule held to its mean loss over steps 2550-3000
   within 0.10 nats with K2/K3 launched as predicted; the ABX of the
   continuous latent and 2 dev reconstructions (K1 at B=1), printed beside
   run F's; AdaIN voice conversion of 40 utterances through K1 (tar_c from
   the train dump), its F0 beside run F's and K1 launched as predicted;
   then K2/K3 at B=24 x T=5120 bf16 and K1 in teacher mode at B=1 and 24
   (T=1100) against their plain versions, and their times beside their
   bounds.
16. The threefry kernel (``csrc/threefry.cu``: the draws from the JAX
   package's keys, ``utils/jax_random.py``) against its plain version, bit
   for bit, at the real draws: the step keys of 256 steps (``fold_in``) and
   their splits (entry point a), run K's reseed ``randint`` bits (b), the
   uniforms of the layer-0 dropout draw at B=40 x T=5120 x 256 and of a
   MoL sampler's range (c), that dropout mask, its rows 20-40 (data rank 1
   of 2, also held against the slice of the whole draw) and rows past
   counter 2^32 (d); ``normal`` on the card against the CPU's within 1e-6;
   each timed (CUDA events) beside the plain version and the bound (int32
   operations or bytes). Then an unfused svqwae train step with dropout
   0.05 at B=40 x T=5120 bf16, once with the kernel's masks and once with
   the plain version's: the 20 masks bit for bit, step 1's loss within
   1e-6, both step times (eager); the kernel's launches counted. Then the
   same step as a CUDA graph: the masks it drew at steps 1-3 (the eager
   first step, the captured second, a replay; their keys folded from the
   device step) bit for bit against the eager step's.
17. Run E (``quality2/exp/svqwae_r4j``: time jitter from step 0,
   ``per_side`` false; ``--phases 0,17``, not in the default list): 2000
   fused steps of its schedule (``--steps 14000``) on the shared corpus;
   step 1 printed beside run E's record (which predates the JAX package's
   current initial state), and a control step 1 with the jitter gated past
   step 1 held to run G's (``svqwae_r5``, the same config gated at 3000)
   within 1e-5 in the loss (the other metrics at TOL_RECORD_STEP1); the
   mean loss over steps 1550-2000 within 0.10 nats of run E's, perplexity
   >= 64 there, K2/K3 launched as predicted and the reseeds printed beside
   run E's; no evaluation (run E's ABX predates the stale-EMA fix).
18. The upsampler's kernels (``csrc/upsample.cu``: the conditioning's
   stretch-and-smooth chain, forward and backward) against their plain
   version (``repeat_interleave`` and ``F.conv2d`` a scale) at svqwae's B=40
   x T=5120, inae's B=10 x T=5120 and vocoder_raw's B=8 x T=10240 in bf16
   (and vocoder_raw through the cin_pad 2 trim), and svqwae in f32: the
   output and the gradients of the conditioning and every scale's weights
   at phase 5's tolerances, two runs bitwise equal; then, in bf16, the
   kernels' device ms beside the bound (bytes), the plain version's and
   cuDNN's conv calls alone as a yardstick the port never calls.
   ``--phases 0,18`` runs it alone (run after phase 5 in the default list).
   Its launches stay out of the kernel table's ``launches``, which sums the
   train paths of phases 6 and 8-15: there the kernels run once forward and
   once backward a step (K2's and K3's count where the stack is fused) and
   once forward for each other pass of the model (a sample dump, a dev
   batch, a decode), each path's count held to that.

The train step runs as the CLI runs it: a CUDA graph on the card for one
process (phases 6, 8-10, 11's single-process runs, 13-15 and 17; phases 6,
10 and the quality runs fail unless the loop's ``train step:`` line says
so), eager under a process group (11's ranks and 1-rank group, 12). The
launch counters count a replay's launches (``train/graph.py``), so every
prediction holds as before.

Phases 13-15 and 17 share one corpus when they run together. ``--quality-hparams
k=v,...`` appends to their hparams (``fused_stack=false``: the fused
stack's part in a difference from the JAX run; ``seed=N``: another init
draw); the launch predictions follow the config the run saved.
``--vq-bf16-product`` rounds the inputs of the VQ distance product to bf16,
as a TPU's default-precision dot does in the JAX runs (the port computes it
in f32).

Prints the kernel table (K1, K2, K3, the threefry and upsampler kernels; ``launches``
summed over every path driven, ``launches_by_path`` each path's count) as
one JSON line, the nvidia-smi line, and last
``{"ok": true, "device": {...}}``. Without CUDA it exits non-zero and
prints no result. It imports only the port, never JAX.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import io
import json
import os
import re
import shutil
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
K1_BOUNDS = {"f32_vs_apply": TOL_F32, "f32_vs_plain": TOL_F32,
             "bf16_vs_plain_bf16": TOL_BF16_PLAIN, "bf16_vs_apply_f32": TOL_BF16_F32,
             "bf16_jitter_vs_plain_build": 0.0}
GUMBEL_CLASSES = (5, 37, 70, 101, 140, 171, 200, 251)
GUMBEL_LOGITS = (0.0, 0.4, 0.8, 1.2, 1.6, 2.0, 2.4, 2.8)

H100_BF16_FLOPS = 989e12   # dense bf16 tensor-core peak, H100 SXM data sheet
H100_BYTES_PER_S = 3.35e12  # HBM3 bandwidth, H100 SXM data sheet
# SM clocks a second: 132 SMs x the 1.98 GHz boost clock (H100 SXM)
H100_SM_CLOCKS = 132 * 1.98e9
# Integer operations a threefry counter costs, counted from csrc/threefry.cu:
# the 2 initial key adds, 20 rounds of add, funnel-shift rotate and xor, 5
# key injections of 2 adds, the counter's (hi, lo) split and the outputs'
# xor. The 20 rotates and 20 xors run only on an SM's 64-lane integer
# pipe; the adds can issue as IMAD on its 128-lane FMA pipe (phase 16
# prints the mask kernel's loop from cuobjdump of the sm_90a build), and an
# SM issues 128 thread-instructions a clock: the least time is the larger
# of the two.
THREEFRY_OPS = 2 + 20 * 3 + 5 * 2 + 2 + 1
THREEFRY_ALU_OPS = 20 + 20


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


def build_model_s(cfg, reps: int = 3) -> list:
    """Seconds of ``build_model`` on the card (the JAX draw of every initial
    weight as torch ops there), each call after a synchronize; the first
    includes CUDA's start-up."""
    import torch

    from wavenet_autoencoders_tpu_torch.models import build_model

    secs = []
    for _ in range(reps):
        t0 = time.perf_counter()
        model = build_model(cfg, device="cuda")
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    n = sum(p.numel() for p in model.parameters())
    log(f"phase 0: build_model of {cfg.name} at run K's full width ({n:,} parameters): "
        f"{' / '.join(f'{t:.3f}' for t in secs)} s")
    return secs


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
    from wavenet_autoencoders_tpu_torch.utils.jax_random import PRNGKey

    _cfg, model = full_model(seed=1)
    net = model.wavenet
    # full width without c and g (K = 3C in the gate product, no g_add)
    bare = WaveNet(out_channels=256, layers=20, stacks=2, residual_channels=256, gate_channels=368,
                   skip_out_channels=256, dropout=0.0, key=PRNGKey(1, "cuda"))
    # the old case (f32 and bf16), then bf16 at B=256 and a ragged B=37 past
    # the d=512 ring wrap (the large-batch schedule and the tile edges), B=1,
    # and the net without conditioning
    cases = [("B4_T2560", net, 4, 2560, ("float32", "bfloat16"), True),
             ("B256_T1100", net, 256, 1100, ("bfloat16",), True),
             ("B37_T1100", net, 37, 1100, ("bfloat16",), True),
             ("B1_T1100", net, 1, 1100, ("bfloat16",), True),
             ("nocond_B4_T1100", bare, 4, 1100, ("bfloat16",), False)]
    bounds = K1_BOUNDS
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
    from wavenet_autoencoders_tpu_torch.utils.jax_random import PRNGKey

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
                           output_distribution=dist, key=PRNGKey(0, "cuda"))
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
    from wavenet_autoencoders_tpu_torch.kernels import threefry as TF
    from wavenet_autoencoders_tpu_torch.utils.params import flatten_params

    cfg, model = full_model(seed=3)
    ckpt = tmp / "checkpoint_step000000000.npz"
    np.savez(ckpt, step=np.int64(0),
             **{f"params/{k}": v.detach().cpu().numpy() for k, v in flatten_params(model).items()})
    test, utts, feats, syn, sp2ind, scp = make_test_set(tmp / "dump", np.random.default_rng(3), 4, 200, target=None)
    abx, wav_dir = tmp / "abx", tmp / "syn"

    K.LAUNCHES = TF.LAUNCHES = 0
    t0 = time.perf_counter()
    cli(["infer", "--preset", "svqwae", "--device", "cuda", str(ckpt), str(scp), str(abx)])
    t1 = time.perf_counter()
    cli(["synthesize", "--preset", "svqwae", "--device", "cuda", "--batch", "4", str(ckpt),
         str(test), str(wav_dir), str(syn), str(sp2ind), "english"])
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    launches = K.LAUNCHES
    tf_launches("svqwae_cli_serve", TF.LAUNCHES)
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
    from wavenet_autoencoders_tpu_torch.utils.jax_random import PRNGKey

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
                       skip_out_channels=16, cin_channels=16, dropout=0.0, key=PRNGKey(0, "cuda"))
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

    sig_bad = K.gate_sigmoid_mismatches()
    log(f"phase 5: the TMA gate kernel's sigmoid against sigmoidf on all 65536 bf16 inputs: {sig_bad} differ")
    if sig_bad != 0:
        raise AssertionError(f"the TMA gate kernel's sigmoid differs from sigmoidf on {sig_bad} bf16 inputs")
    out, abs_err, gate_wg, dx_wg, dx_vs_pipe = {}, {"K2": 0.0, "K3": 0.0}, {}, {}, {}
    # the no-conditioning case: K = 3C in the gate product, N = C in dx;
    # vocoder_raw's widths (the G = 256 tile) and cin 40 (a part-filled box)
    sv = dict(C=256, G=368, S=256, cin=64, L=20, stacks=2)
    cases = [(B, T, n, s, True, "", sv) for B, T in ((2, 2048), (3, 2000))
             for n, s in (("float32", torch.float32), ("bfloat16", torch.bfloat16))]
    cases.append((2, 2048, "bfloat16", torch.bfloat16, False, "", sv))
    cases.append((2, 1500, "bfloat16", torch.bfloat16, True, " vocoder_raw width",
                  dict(C=128, G=256, S=128, cin=80, L=24, stacks=4)))
    cases.append((2, 700, "bfloat16", torch.bfloat16, True, " cin=40", dict(sv, cin=40)))
    for B, T, name, store, cond, tag, wd in cases:
        rng = np.random.default_rng(5 + B)
        x, c, g_add, w, dils = glu_inputs(B, T, store, rng, **wd)
        if not cond:
            c = g_add = w["wc"] = None
        args = (x, c, g_add, w["wconv"], w["bconv"], w["wc"], w["wout"], w["bout"], w["wskip"],
                w["bskip"], dils)
        dskips = torch.from_numpy(rng.standard_normal((B, T, wd["S"])).astype(np.float32)).cuda().to(store)
        with torch.no_grad():
            n0 = K.LAUNCHES_GATE_WG
            skips, hfin, ab = K.glu_stack_forward(*args)
            gate = K.LAUNCHES_GATE_WG - n0
            fwd_again = K.glu_stack_forward(*args)
            p_skips, p_hfin, p_ab = K.glu_stack_forward_reference(*args)
            bargs = (c, ab, w["wconv"], w["wc"], w["wout"], w["bout"], w["wskip"], dils, cond)
            n0 = K.LAUNCHES_DX_WG
            grads = K.glu_stack_backward(dskips, hfin, *bargs)
            dxl = K.LAUNCHES_DX_WG - n0
            again = K.glu_stack_backward(dskips, hfin, *bargs)
            with dx_on_gemm_pipe():
                piped = K.glu_stack_backward(dskips, hfin, *bargs)
            plain = K.glu_stack_backward_reference(dskips, p_hfin, c, p_ab, *bargs[2:])
        torch.cuda.synchronize()
        errs, a2, a3 = glu_errors((skips, hfin, ab), (p_skips, p_hfin, p_ab), grads, plain)
        abs_err["K2"], abs_err["K3"] = max(abs_err["K2"], a2), max(abs_err["K3"], a3)
        bitwise = all(g is None or torch.equal(g, h) for g, h in zip(grads, again))
        bitwise2 = all(torch.equal(a, b) for a, b in zip((skips, hfin, ab), fwd_again))
        # the dx route against gemm_pipe's: gy, which K3 does not return,
        # feeds every later layer's dact and dW1 products
        pipe_diff = {n: (g.float() - h.float()).abs().max().item() for n, g, h in zip(GLU_GRADS, grads, piped)
                     if g is not None}
        if store == torch.float32:
            # K3 against autograd of the plain forward (leaves in GLU_GRADS order)
            leaves = [t.detach().clone().requires_grad_(True) for t in args[:-1]]
            s, _, _ = K.glu_stack_forward_reference(*leaves, dils)
            (s * dskips).sum().backward()
            errs.update({f"{n}_vs_autograd": rel_err(g, t.grad) for n, g, t in zip(GLU_GRADS, grads, leaves)})
        case = f"B={B} T={T} {name}" + ("" if cond else " c=None g_add=None") + tag
        log(f"phase 5: {case}: gate layers on the TMA kernel {gate}, dx layers {dxl}; bitwise-equal K2 reruns "
            f"{bitwise2}, K3 reruns {bitwise}; K3 against its dx pass on gemm_pipe: "
            f"{'bit for bit' if not any(pipe_diff.values()) else 'largest abs differences ' + json.dumps(pipe_diff)}; "
            f"rel errors {json.dumps({k: float(f'{v:.3g}') for k, v in errs.items()})}")
        check_glu(errs, name, case)
        if not (bitwise and bitwise2):
            raise AssertionError(f"two {'K3' if not bitwise else 'K2'} calls on the same inputs differ ({case})")
        want = wd["L"] if store == torch.bfloat16 else 0
        if gate != want:
            raise AssertionError(f"{case}: {gate} gate layers took the TMA kernel, expected {want}")
        if dxl != want:
            raise AssertionError(f"{case}: {dxl} dx layers took the TMA kernel, expected {want}")
        key = f"B{B}_T{T}_{name}" + ("" if cond else "_nocond") + tag.replace(" ", "_").replace("=", "")
        out[key], gate_wg[key], dx_wg[key], dx_vs_pipe[key] = errs, gate, dxl, pipe_diff
    k2["max_rel_err"] = {case: max(e[k] for k in FWD_OUTPUTS) for case, e in out.items()}
    k3["max_rel_err"] = {case: max(v for k, v in e.items() if k not in FWD_OUTPUTS) for case, e in out.items()}
    k2["max_abs_err"], k3["max_abs_err"] = abs_err["K2"], abs_err["K3"]
    k2["tolerances_rel"] = k3["tolerances_rel"] = TOL_GLU
    k2["gate_wg_launches"] = gate_wg
    k3["dx_wg_launches"], k3["dx_route_vs_gemm_pipe_max_abs"] = dx_wg, dx_vs_pipe


@contextlib.contextmanager
def dx_on_gemm_pipe():
    """K3's dx pass on gemm_pipe whatever ``dx_route`` says, inside the block."""
    from wavenet_autoencoders_tpu_torch.kernels import glu_stack as K

    route = K.dx_route
    K.dx_route = lambda *a: "gemm_pipe"
    try:
        yield
    finally:
        K.dx_route = route


# The upsampler's shapes: each preset's training batch, the frame
# conditioning (B, T0, cin) that its conv_in hands on, and the trim of the
# cin_pad path of ``UpsampleNetwork`` (vocoder_raw's cin_pad 2).
UP_CASES = (("svqwae", 40, 5120, 0, "bfloat16"), ("inae", 10, 5120, 0, "bfloat16"),
            ("vocoder_raw", 8, 10240, 0, "bfloat16"), ("vocoder_raw", 8, 10240, 2, "bfloat16"),
            ("svqwae", 40, 5120, 0, "float32"))
UP_REPS = 20


def upsample_inputs(preset, B, T, cin_pad, store, seed):
    """x (B, T0, cin), the folded smoothing weights (uniform taps in
    [0.2, 1), a gain in [0.5, 1.5)) and dy (B, T, cin), in ``store``, from a
    seed; and the scales."""
    import torch

    from wavenet_autoencoders_tpu_torch.config import load_preset

    cfg = load_preset(preset)
    scales = cfg.upsample_scales
    prod = int(np.prod(scales))
    rng = np.random.default_rng(seed)
    T0 = T // prod + 2 * cin_pad

    def dev(a):
        return torch.from_numpy(np.asarray(a, np.float32)).cuda().to(store)

    ws = []
    for s in scales:
        v = rng.uniform(0.2, 1.0, 2 * s + 1)
        ws.append(dev(rng.uniform(0.5, 1.5) * v / np.sqrt((v ** 2).sum())).reshape(1, 1, 1, -1))
    x = dev(rng.standard_normal((B, T0, cfg.cin_channels)))
    dy = dev(rng.standard_normal((B, T, cfg.cin_channels)))
    return x, ws, dy, scales, cin_pad * prod


def upsample_grads(fn, x, ws, dy, scales, indent):
    """(output, dx, dw...) of one forward and backward of ``fn``."""
    import torch

    leaves = [t.detach().clone().requires_grad_(True) for t in (x, *ws)]
    out = fn(leaves[0], leaves[1:], scales, 1, indent)
    grads = torch.autograd.grad(out, leaves, dy)
    return (out.detach(), *grads)


def upsample_device_ms(fn) -> tuple[float, dict]:
    """Device ms of one call of ``fn``: every kernel's time over UP_REPS
    calls under the profiler, divided by UP_REPS; and the upsampler kernels'
    ms by name."""
    rows = kernel_breakdown(lambda: [fn() for _ in range(UP_REPS)])
    by = {}
    for name, ms, _ in rows:
        m = re.search(r"up_(fwd|bwd|wsum)_kernel", name)
        if m:
            by[m.group(0)] = by.get(m.group(0), 0.0) + ms / UP_REPS
    return sum(ms for _, ms, _ in rows) / UP_REPS, by


def library_chain(x, ws, dy, scales):
    """cuDNN's F.conv2d calls of the plain chain alone (a yardstick the
    port never calls): each scale's conv forward and its input and weight
    gradients on inputs stretched beforehand."""
    import torch
    import torch.nn.functional as F

    with torch.no_grad():
        ys = [x.transpose(1, 2)[:, None]]
        for w, s in zip(ws, scales):
            ys.append(F.conv2d(ys[-1].repeat_interleave(s, dim=3), w, padding=(0, s)))
        ins = [y.repeat_interleave(s, dim=3) for y, s in zip(ys, scales)]
        gys = [torch.randn_like(y) for y in ys[1:-1]] + [dy.transpose(1, 2)[:, None].contiguous()]
    leaves = [(u.requires_grad_(True), w.detach().clone().requires_grad_(True)) for u, w in zip(ins, ws)]

    def run():
        for (u, w), s, gy in zip(leaves, scales, gys):
            out = F.conv2d(u, w, padding=(0, s))
            torch.autograd.grad(out, (u, w), gy)

    return run


def phase18(up):
    """The upsampler's kernels against their plain version at the presets'
    training shapes: the output and every gradient at phase 5's tolerances,
    two runs bitwise equal; device ms of the kernels, the plain chain and
    cuDNN's conv calls beside the bound (bytes)."""
    import torch

    from wavenet_autoencoders_tpu_torch.kernels import upsample as UP

    out, launches = {}, (UP.LAUNCHES_FWD, UP.LAUNCHES_BWD)
    for i, (preset, B, T, cin_pad, name) in enumerate(UP_CASES):
        store = getattr(torch, name)
        x, ws, dy, scales, indent = upsample_inputs(preset, B, T, cin_pad, store, 18 + i)
        got = upsample_grads(UP.upsample, x, ws, dy, scales, indent)
        again = upsample_grads(UP.upsample, x, ws, dy, scales, indent)
        plain = upsample_grads(UP.upsample_reference, x, ws, dy, scales, indent)
        torch.cuda.synchronize()
        names = ["out", "dx"] + [f"dw{k}" for k in range(len(scales))]
        errs = {n: rel_err(g, p) for n, g, p in zip(names, got, plain)}
        bitwise = all(torch.equal(g, a) for g, a in zip(got, again))
        tol_f, tol_b = TOL_GLU[name]
        case = f"{preset} B={B} T={T} cin_pad={cin_pad} {name}"
        rec = {"errors": errs, "bitwise_reruns": bitwise}
        if name == "bfloat16":
            eb = x.element_size()
            # forward: x and w read, the output written; backward: dy, x and
            # w read, dx and dw written
            nbytes = (3 * x.numel() + 2 * dy.numel() + 3 * sum(w.numel() for w in ws)) * eb
            bound = nbytes / H100_BYTES_PER_S * 1e3

            def kern():
                o = UP._forward_cuda(x, ws, scales, indent)
                UP._backward_cuda(dy, x, ws, scales, indent)
                return o

            ms, by_kernel = upsample_device_ms(kern)
            plain_ms = upsample_device_ms(lambda: upsample_grads(UP.upsample_reference, x, ws, dy, scales, indent))[0]
            library_ms = upsample_device_ms(library_chain(x, ws, dy, scales))[0] if indent == 0 else None
            rec.update({"ms": ms, "ms_by_kernel": by_kernel, "plain_ms": plain_ms, "library_ms": library_ms,
                        "bytes": nbytes, "bound_ms": bound, "share": bound / ms if ms else None})
            lib = "not measured" if library_ms is None else f"{library_ms:.4f} ms"
            log(f"phase 18: {case}: kernels {ms:.4f} ms (forward + backward, device; "
                f"{json.dumps({k: round(v, 4) for k, v in by_kernel.items()})}), plain {plain_ms:.4f} ms, "
                f"cuDNN's conv calls {lib}; bound {bound:.4f} ms by bytes ({nbytes / 1e6:.1f} MB), "
                f"{100 * bound / ms:.1f}% of bound" if ms else f"phase 18: {case}: the profiler saw no device time")
        log(f"phase 18: {case}: bitwise-equal reruns {bitwise}; rel errors "
            f"{json.dumps({k: float(f'{v:.3g}') for k, v in errs.items()})}")
        for k, e in errs.items():
            tol = tol_f if k == "out" else tol_b
            if not np.isfinite(e) or e > tol:
                raise AssertionError(f"upsample kernels {case}: {k} rel error {e} exceeds {tol}")
        if not bitwise:
            raise AssertionError(f"upsample kernels {case}: two runs on the same inputs differ")
        out[case] = rec
        del x, ws, dy, got, again, plain
        torch.cuda.empty_cache()
    main = out[f"svqwae B=40 T=5120 cin_pad=0 bfloat16"]
    up.update({k: main[k] for k in ("ms", "plain_ms", "library_ms", "bound_ms")})
    up.update({"bound_by": "bytes", "shape": "svqwae B=40,T=5120,cin=64,bf16 (forward + backward)",
               "cases": out, "tolerances_rel": TOL_GLU,
               "max_rel_err": {c: max(r["errors"].values()) for c, r in out.items()}})
    # the isolated check's launches (profiler repetitions and reruns
    # included), kept out of ``launches``, which sums the train paths'
    up["isolated_check_launches"] = [UP.LAUNCHES_FWD - launches[0], UP.LAUNCHES_BWD - launches[1]]


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
    from wavenet_autoencoders_tpu_torch.kernels import threefry as TF
    from wavenet_autoencoders_tpu_torch.kernels import upsample as UP

    dump, ckpt, abx = tmp / "dump", tmp / "exp", tmp / "abx"
    dirs = make_dump(dump, np.random.default_rng(6))
    K.LAUNCHES_FWD = K.LAUNCHES_BWD = K.LAUNCHES_GATE_WG = K.LAUNCHES_DX_WG = 0
    TF.LAUNCHES = UP.LAUNCHES_FWD = UP.LAUNCHES_BWD = 0
    t0 = time.perf_counter()
    with tee_stdout() as out:
        cli(["train", "--preset", "svqwae", "--hparams", "fused_stack=true", "--device", "cuda",
             "--max-steps", "3", str(dump), str(ckpt)])
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    launches = (K.LAUNCHES_FWD, K.LAUNCHES_BWD)
    tf_launches("svqwae_cli_train", TF.LAUNCHES)
    up_launches("svqwae_cli_train", (UP.LAUNCHES_FWD, UP.LAUNCHES_BWD), launches)
    log(f"phase 6: train 3 steps at B=40 x T=5120 bf16 through the CLI: {t1 - t0:.2f} s host clock "
        f"(build and data included); the step: {graph_form(out.getvalue(), 'phase 6')}; K2/K3 launches {launches} "
        f"(a replay's counted), gate layers on the TMA kernel {K.LAUNCHES_GATE_WG}, dx layers {K.LAUNCHES_DX_WG}")
    if launches != (3, 3):
        raise AssertionError(f"K2/K3 launched {launches} times in 3 fused train steps, expected (3, 3)")
    if K.LAUNCHES_GATE_WG != 3 * 20:
        raise AssertionError(f"{K.LAUNCHES_GATE_WG} gate layers took the TMA kernel in 3 steps, expected 60")
    if K.LAUNCHES_DX_WG != 3 * 20:
        raise AssertionError(f"{K.LAUNCHES_DX_WG} dx layers took the TMA kernel in 3 steps, expected 60")
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

    from wavenet_autoencoders_tpu_torch.kernels import glu_stack as K

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

    # whole train steps at the preset's shape, fused and unfused, each as a
    # CUDA graph and eager from the same initial state and batches: held
    # against each other, then timed in turns and profiled
    batches = step_batches(B, T)
    runs, holds = {}, {}
    for name, fused in (("unfused", False), ("fused", True)):
        holds[name], runs[name] = graph_hold(name, fused, batches)
        torch.cuda.empty_cache()
    order = [f"{n}_{f}" for n in ("unfused", "fused") for f in ("eager", "graphed")]
    order += order[::-1]
    times = {k: [] for k in order}
    for key in order:
        name, form = key.split("_")
        times[key].append(runs[name][form](3))
    step_ms = {k: float(np.mean(v)) for k, v in times.items()}
    sps = {k: B * T / (v / 1e3) for k, v in step_ms.items()}
    rest = step_ms["fused_graphed"] - k2_ms - k3_ms
    log(f"phase 7: B={B} T={T} bf16: K2 {k2_ms:.2f} ms (plain {p2_ms:.2f}), K3 {k3_ms:.2f} ms (plain {p3_ms:.2f}); "
        f"train step ms (host clock, 3 steps a turn, in turns {order}): "
        f"{json.dumps({k: [round(t, 2) for t in v] for k, v in times.items()})} = "
        f"{json.dumps({k: round(v) for k, v in sps.items()})} samples/s; graphed fused step minus K2+K3 {rest:.1f} ms; "
        f"{smi()}")
    # where a step's device time goes, by kernel (one more step each)
    breakdown, pass_flop = {}, glu_pass_flop(B, T)
    log(f"phase 7: K2/K3 FLOP per pass {json.dumps({p: f'{v:.4g}' for p, v in pass_flop.items()})}")
    for key in order[:4]:
        name, form = key.split("_")
        t0 = time.perf_counter()
        rows = kernel_breakdown(lambda: runs[name][form](1))
        wall = (time.perf_counter() - t0) * 1e3
        busy = sum(r[1] for r in rows)
        ops = sum(r[2] for r in rows)
        passes = {p: sum(ms for k, ms, _ in rows if p in k) for p in GLU_PASSES}
        tflops = {p: pass_flop[p] / (passes[p] / 1e3) / 1e12 for p in pass_flop if passes[p] > 0}
        breakdown[key] = {"device_ms": busy, "device_ops": ops, "wall_ms_profiled": wall,
                          "busy_share_of_timed_step": busy / step_ms[key] if busy else None,
                          "top": [(k[:100], ms, n) for k, ms, n in rows[:12]],
                          "glu_passes_ms": {p: v for p, v in passes.items() if v > 0},
                          "glu_passes_tflop_s": tflops}
        share = (f"{100 * busy / step_ms[key]:.1f}% of the timed {step_ms[key]:.1f} ms step" if busy
                 else "not measured (the profiler saw no device time)")
        log(f"phase 7: {key} step under the profiler: device busy {busy:.1f} ms in {ops} device operations, "
            f"{share} ({wall:.1f} ms wall profiled); K2/K3 passes ms "
            f"{json.dumps({p: round(v, 2) for p, v in passes.items() if v > 0})}, "
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
    k2["train_step"] = {"ms": times, "samples_per_s": sps, "graphed_fused_minus_k2_k3_ms": rest, "holds": holds,
                        "profile": breakdown}
    k3["unfused_step_ms"] = k2["unfused_step_ms"] = step_ms["unfused_graphed"]
    del runs
    torch.cuda.empty_cache()


GRAPH_STEPS = 20
HELD_AT = (1, 2, GRAPH_STEPS)  # the eager first step, the first replay, the last


def step_batches(B, T, n=4, seed=8) -> list[dict]:
    """n svqwae batches of random codes, features and speakers on the card."""
    import torch

    r = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        codes = torch.from_numpy(r.integers(0, 256, (B, T))).cuda()
        out.append({"x": codes, "y": codes[..., None], "lengths": torch.full((B,), T, device="cuda"),
                    "c": torch.from_numpy(r.standard_normal((B, T // 160, 39)).astype(np.float32)).cuda(),
                    "g": torch.from_numpy(r.integers(0, 153, (B,))).cuda()})
    return out


def step_diff(a: dict, b: dict) -> dict:
    """Max |a - b| of two snapshots (``step_snapshot``), by field: the loss,
    the grad norm and each tree of the state."""
    return {k: abs(a[k] - b[k]) if isinstance(a[k], float) else float((a[k] - b[k]).abs().max()) for k in a}


def step_snapshot(st, m) -> dict:
    """A step's loss and grad norm and its state's tensors, flat by tree
    (params, model_state, mu, nu, ema), copied on the card."""
    import torch

    from wavenet_autoencoders_tpu_torch.train.graph import state_tensors

    trees = {}
    for k, t in state_tensors(st).items():
        trees.setdefault(k.split("/", 1)[0], []).append(t.detach().reshape(-1).float())
    return {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
            **{k: torch.cat(v) for k, v in trees.items()}}


def graph_hold(name, fused, batches):
    """The svqwae step (``name``: fused or unfused) as a CUDA graph against
    the eager body, from the same initial weights over the same batches
    (cycled) for GRAPH_STEPS steps: two eager runs give the eager spread at
    steps HELD_AT; the graphed run must equal the first eager run bit for
    bit where the eager runs do, and elsewhere lie within twice their
    spread. Returns (the hold's record, {"eager": run, "graphed": run}),
    each run ``run(n)`` timing n more steps (ms a step, host clock)."""
    import torch

    from wavenet_autoencoders_tpu_torch.config import load_preset
    from wavenet_autoencoders_tpu_torch.models import build_model
    from wavenet_autoencoders_tpu_torch.train.step import init_state, make_train_step

    cfg = load_preset("svqwae", f"fused_stack={str(fused).lower()}")
    snaps, diffs, steppers, rec = {}, {}, {}, {}
    for run_name, graph in (("eager", False), ("eager_again", False), ("graphed", True)):
        model = build_model(cfg, device="cuda").train()
        st, step = init_state(cfg, model), make_train_step(cfg, model, graph=graph)
        torch.cuda.synchronize()
        base, t0 = torch.cuda.memory_allocated(), time.perf_counter()
        torch.cuda.reset_peak_memory_stats()
        for i in range(1, GRAPH_STEPS + 1):
            st, m = step(st, batches[(i - 1) % len(batches)])
            if i in HELD_AT:
                s = step_snapshot(st, m)
                if run_name == "eager":
                    snaps[i] = s
                else:
                    diffs.setdefault(run_name, {})[i] = step_diff(s, snaps[i])
                del s
        torch.cuda.synchronize()
        rec[run_name] = {"first_steps_s": time.perf_counter() - t0,
                         "peak_gib": (torch.cuda.max_memory_allocated() - base) / 2**30}
        if graph:
            rec["capture_s"] = step.runner.capture_s
            rec["replay_counts"] = step.runner.launches
        if run_name != "eager_again":
            steppers[run_name] = (st, step)
        del model, st, step
    spread, off = diffs["eager_again"], diffs["graphed"]
    bitwise = all(v == 0 for d in spread.values() for v in d.values())
    bad = {i: {k: (off[i][k], spread[i][k]) for k in off[i] if not off[i][k] <= 2 * spread[i][k]} for i in HELD_AT}
    bad = {i: v for i, v in bad.items() if v}
    held = "bit for bit" if bitwise else "within twice the eager spread"
    rec.update({"eager_spread": spread, "graphed_off": off, "held": held})
    log(f"phase 7: {name} svqwae step, CUDA graph against the eager body over {GRAPH_STEPS} steps from one state "
        f"and {len(batches)} batches: eager against eager max|diff| at steps {HELD_AT} "
        f"{json.dumps({i: {k: float(f'{v:.3g}') for k, v in d.items()} for i, d in spread.items()})}; graphed "
        f"against eager {json.dumps({i: {k: float(f'{v:.3g}') for k, v in d.items()} for i, d in off.items()})}; "
        f"held {held}{': OFF ' + json.dumps(bad) if bad else ''}; capture {rec['capture_s']:.2f} s, a replay "
        f"launches {json.dumps(rec['replay_counts'])} of the counted kernels; peak GiB above the run's start: eager "
        f"{rec['eager']['peak_gib']:.2f}, graphed {rec['graphed']['peak_gib']:.2f}")
    if bad:
        raise AssertionError(f"the graphed {name} step is off the eager body: {bad}")

    def timer(st, step):
        def run(n):
            nonlocal st
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for i in range(n):
                st, _ = step(st, batches[i % len(batches)])
            torch.cuda.synchronize()
            return (time.perf_counter() - t0) / n * 1e3
        return run

    return rec, {k: timer(*v) for k, v in steppers.items()}


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
    from wavenet_autoencoders_tpu_torch.kernels import upsample as UP

    rng = np.random.default_rng(8)
    dump, ckpt_dir, abx, wav_dir = tmp / "dump", tmp / "exp", tmp / "abx", tmp / "syn"
    make_dump(dump, rng, split="train_no_dev")
    test, utts, feats, syn, sp2ind, scp = make_test_set(dump, rng, 4, 200)
    secs, hp = {}, "fused_stack=true"
    K.LAUNCHES_FWD = K.LAUNCHES_BWD = UP.LAUNCHES_FWD = UP.LAUNCHES_BWD = 0
    t0 = time.perf_counter()
    cli(["train", "--preset", "inae", "--hparams", hp, "--device", "cuda", "--max-steps", "3",
         str(dump), str(ckpt_dir)])
    torch.cuda.synchronize()
    secs["train"] = time.perf_counter() - t0
    glu = (K.LAUNCHES_FWD, K.LAUNCHES_BWD)
    if glu != (3, 3):
        raise AssertionError(f"K2/K3 launched {glu} times in 3 fused inae train steps, expected (3, 3)")
    up_launches("inae_cli_train", (UP.LAUNCHES_FWD, UP.LAUNCHES_BWD), glu)
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
    from wavenet_autoencoders_tpu_torch.kernels import upsample as UP

    out, totals, up, up_want = {}, {"K1": 0, "K2": 0, "K3": 0}, [0, 0], [0, 0]
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
        K.LAUNCHES_FWD = K.LAUNCHES_BWD = K1.LAUNCHES = UP.LAUNCHES_FWD = UP.LAUNCHES_BWD = 0
        t0 = time.perf_counter()
        cli(["train", *common, "--max-steps", "1", "--feat-type", "mel" if feat_dim == 80 else "mfcc",
             str(root), str(root / "exp")])
        t1 = time.perf_counter()
        # the train step's alone: synthesis runs the upsampler's forward too
        up_train = [UP.LAUNCHES_FWD, UP.LAUNCHES_BWD]
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
        # a family whose WaveNet takes its conditioning through the
        # upsampler runs it once a step, beside K2 and K3
        want = [n["K2"], n["K3"]] if cfg.upsample_conditional_features else [0, 0]
        if up_train != want:
            raise AssertionError(f"{label}: the upsampler kernels launched {up_train} times in one fused step, "
                                 f"expected {want}")
        out[label] = {"loss": loss, "train_s": t1 - t0, "serve_s": t2 - t1, "launches": n,
                      "upsample_launches": up_train}
        for k in totals:
            totals[k] += n[k]
        up, up_want = [a + b for a, b in zip(up, up_train)], [a + b for a, b in zip(up_want, want)]
    for rec, k in ((k1, "K1"), (k2, "K2"), (k3, "K3")):
        count_launches(rec, "zoo_cli", totals[k])
    up_launches("zoo_cli", up, up_want)
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


def graph_form(text: str, where: str) -> str:
    """The train loop's ``train step:`` line in ``text``; raises unless the
    step ran as a CUDA graph."""
    m = re.search(r"^train step: (.*)$", text, re.M)
    if m is None or not m.group(1).startswith("CUDA graph"):
        raise AssertionError(f"{where}: the train step did not run as a CUDA graph ({m.group(1) if m else 'no line'})")
    return m.group(1)


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
    from wavenet_autoencoders_tpu_torch.data import native
    from wavenet_autoencoders_tpu_torch.data.dataset import WaveDataset, data_iterator
    from wavenet_autoencoders_tpu_torch.kernels import decode as K1
    from wavenet_autoencoders_tpu_torch.kernels import glu_stack as K
    from wavenet_autoencoders_tpu_torch.kernels import threefry as TF
    from wavenet_autoencoders_tpu_torch.kernels import upsample as UP
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
    K.LAUNCHES_FWD = K.LAUNCHES_BWD = K1.LAUNCHES = TF.LAUNCHES = UP.LAUNCHES_FWD = UP.LAUNCHES_BWD = 0
    loads = native.LOADS
    with tee_stdout() as out:
        timed("train", lambda: cli(["train", "--preset", "svqwae", "--hparams", hp, "--device", "cuda",
                                    "--dev-dump-root", str(dev_dump), "--max-steps", "24",
                                    str(dump / "english" / "train_no_dev"), str(exp)]))
    launches = {"K1": K1.LAUNCHES, "K2": K.LAUNCHES_FWD, "K3": K.LAUNCHES_BWD}
    tf_launches("recipe_cli_train", TF.LAUNCHES)
    up_recipe = (UP.LAUNCHES_FWD, UP.LAUNCHES_BWD)
    # the train batches (and the prefetch thread's few ahead) and the dev batch
    loads = native.LOADS - loads
    log(f"phase 10: the native loader assembled {loads} batches in train")
    if loads < 25:
        raise AssertionError(f"the recipe's 24 steps and dev pass took {loads} batches from the native loader")
    text = out.getvalue()
    log(f"phase 10: the step: {graph_form(text, 'phase 10')}")
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
    # every pass of the model runs the upsampler: K2's and K1's forwards, K3's backwards
    up_launches("recipe_cli_train", up_recipe, (launches["K2"] + launches["K1"], launches["K3"]))
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
    steps = sorted(e["args"]["step"] for e in events if e.get("cat") == "program_span" and e["name"] == "step")
    launch = [e["dur"] for e in events if e.get("cat") == "program_span" and e["name"] == "step.launch"]
    counters = json.loads(traces[0].read_text())["programCounters"]
    log(f"phase 10: the tracer's steps {steps}, step.launch us {launch}, counters {json.dumps(counters)}")
    if steps != [10, 11, 12, 13, 14] or len(launch) != 5 or not counters.get("graph.nodes"):
        raise AssertionError(f"the trace lacks the tracer's steps 10-14, their launches or graph.nodes: {steps}, "
                             f"{launch}, {counters}")

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


# Phase 11's data-parallel step: 2 ranks on the one card (gloo on CUDA
# tensors: NCCL refuses two ranks on one GPU) of B=20 each against one
# process at B=40, 3 fused steps from the same init and batches, in bf16
# (the main path) and f32 (fused f32 kernels, TF32 off). Held: every step's
# loss (bf16 1e-4, phase 6's fused-vs-unfused bound; f32 1e-5) and step 1's
# grad norm (bf16 5e-3, phase 6's bound; f32 1e-4). A missed gradient sum
# halves step 1's grad norm; a rank's own mean moves the loss.
# Steps 2-3's grad norms are printed, not held, beside the one-process
# fused-against-unfused runs as the yardstick: Adam's first updates move
# every weight by about lr whatever its gradient's size, so weights whose
# gradient is rounding noise (at B=20 cuBLAS and cuDNN pick other
# algorithms than at B=40: step 1's f32 grad norms differ by ~2e-5 while
# its f32 losses are equal) move either way, and two runs' weights part by
# ~2 lr there. On an H100 80GB HBM3 (700 W) step 3's bf16 grad norms read
# 7.6e-2 apart (fused against unfused, one process: 1.9e-2) while every
# loss agreed to 1.1e-5, and in f32 step 2's read 1.1e-3 apart.
TOL_DP_F32 = {"loss": 1e-5, "grad_norm": 1e-4}
DP_HP = {"bf16": "fused_stack=true", "f32": "fused_stack=true,compute_dtype=float32"}
DP_RANKS, DP_STEPS = 2, 3
# the training options at full svqwae width: with threshold 1.0 and usage
# decay 0.5 every code used less than the uniform share in a step dies and
# is revived in it (from step 1 on), so every step reseeds
OPTIONS_HP = ("fused_stack=true,ema=true,vq_reseed=true,vq_reseed_start=0,vq_reseed_thresh=1.0,"
              "vq_reseed_decay=0.5,time_jitter=true,vq_drop=true,drop_dim=8")
DROPOUT_HP = "fused_stack=true,dropout=0.05"


def dp_steps(dump: Path, hp: str = "fused_stack=true", ckpt: Path | None = None) -> dict:
    """DP_STEPS svqwae train steps (``hp`` overrides; fused bf16 by default)
    on this rank's slice of each of ``dump``'s batches (the mesh of ``hp``'s
    ``mesh_shape`` over the process group; the whole batch without one),
    through the native loader: per step the loss, grad norm and ms (CUDA
    synchronized); K2/K3 launches; collectives issued, and the model
    group's a step with their bytes; peak device memory. With ``ckpt``,
    then a checkpoint there (every rank joins the gather, rank 0 writes)
    and, from rank 0, ``logits.npy``: the f32 teacher-forced logits of the
    first batch's first 4 rows."""
    import torch

    from wavenet_autoencoders_tpu_torch.config import load_preset
    from wavenet_autoencoders_tpu_torch.data.dataset import WaveDataset, data_iterator
    from wavenet_autoencoders_tpu_torch.kernels import glu_stack as K
    from wavenet_autoencoders_tpu_torch.kernels import upsample as UP
    from wavenet_autoencoders_tpu_torch.models import build_model
    from wavenet_autoencoders_tpu_torch.parallel import distributed as D
    from wavenet_autoencoders_tpu_torch.parallel.mesh import model_axis
    from wavenet_autoencoders_tpu_torch.train.checkpoint import save_checkpoint
    from wavenet_autoencoders_tpu_torch.train.loop import batch_to_device
    from wavenet_autoencoders_tpu_torch.train.step import init_state, make_train_step, prep_x, shard_state
    from wavenet_autoencoders_tpu_torch.utils.params import flatten_state

    dev = D.local_device("cuda")
    cfg = load_preset("svqwae", hp)
    model = build_model(cfg, device=dev).train()
    state = init_state(cfg, model)
    D.broadcast_from_main(list(state.params().values()) + list(flatten_state(model).values()))
    D.init_mesh(model_axis(cfg))
    shard_state(cfg, state)
    host_slice = D.host_local_batch_slice(cfg.batch_size) if D.world_size() > 1 else None
    step = make_train_step(cfg, model)
    it = data_iterator(WaveDataset(str(dump), cfg), cfg, prefetch=0, host_slice=host_slice,
                       transform=lambda b: batch_to_device(b, dev))
    K.LAUNCHES_FWD = K.LAUNCHES_BWD = UP.LAUNCHES_FWD = UP.LAUNCHES_BWD = 0
    counts = (D.COLLECTIVES, D.MODEL_COLLECTIVES, D.MODEL_BYTES)
    torch.cuda.reset_peak_memory_stats(dev)
    rec = {"loss": [], "grad_norm": [], "ms": [], "rows": None}
    first = None
    for _ in range(DP_STEPS):
        batch = next(it)
        first = first or batch
        rec["rows"] = int(batch["x"].shape[0])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, batch)
        torch.cuda.synchronize()
        rec["ms"].append((time.perf_counter() - t0) * 1e3)
        rec["loss"].append(m["loss"].item())
        rec["grad_norm"].append(m["grad_norm"].item())
    rec["launches"] = [K.LAUNCHES_FWD, K.LAUNCHES_BWD]
    # the upsampler runs fused or not, replicated over the model axis
    rec["upsample_launches"] = [UP.LAUNCHES_FWD, UP.LAUNCHES_BWD]
    rec["collectives"] = D.COLLECTIVES - counts[0]
    rec["model_collectives_per_step"] = (D.MODEL_COLLECTIVES - counts[1]) / DP_STEPS
    rec["model_bytes_per_step"] = (D.MODEL_BYTES - counts[2]) / DP_STEPS
    rec["peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2**30
    if ckpt is not None:
        save_checkpoint(state, ckpt, write=D.rank() == 0)
        with torch.no_grad():
            y = model(prep_x(cfg, first["x"][:4]), first["c"][:4], first["g"][:4], train=False)[0]
        if D.rank() == 0:
            np.save(ckpt / "logits.npy", y.float().cpu().numpy())
        rec["logits_launches"] = [K.LAUNCHES_FWD - rec["launches"][0], K.LAUNCHES_BWD - rec["launches"][1]]
        rec["upsample_logits_launches"] = [UP.LAUNCHES_FWD - rec["upsample_launches"][0],
                                           UP.LAUNCHES_BWD - rec["upsample_launches"][1]]
    return rec


def dp_worker(init: str, rank: int, dump: str) -> None:
    """One rank of phase 11's data-parallel step (``--dp-worker``): joins a
    gloo group of DP_RANKS on the card and prints its record as a line
    ``DP_RANK {json}`` (the launch counters are per process)."""
    import torch

    from wavenet_autoencoders_tpu_torch.parallel import distributed as D

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    D.initialize_distributed(init, DP_RANKS, rank, device="cuda", backend="gloo")
    try:
        rec = {dtype: dp_steps(Path(dump), DP_HP[dtype]) for dtype in DP_HP}
        rec.update(rank=rank, device=str(D.local_device("cuda")))
        print("DP_RANK " + json.dumps(rec), flush=True)
    finally:
        D.shutdown()


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def loader_ms(dump: Path, n: int = 10) -> dict:
    """Host ms per B=40 x T=5120 svqwae batch over ``n`` batches after one,
    native loader against the Python collate path (no prefetch thread)."""
    from wavenet_autoencoders_tpu_torch.config import load_preset
    from wavenet_autoencoders_tpu_torch.data import native
    from wavenet_autoencoders_tpu_torch.data.dataset import WaveDataset, data_iterator

    cfg = load_preset("svqwae")
    ds = WaveDataset(str(dump), cfg)
    out = {"utterances": len(ds)}
    for name, use_native in (("native", True), ("python", False)):
        it = data_iterator(ds, cfg, prefetch=0, use_native=use_native)
        next(it)
        loads = native.LOADS
        t0 = time.perf_counter()
        for _ in range(n):
            b = next(it)
        out[f"{name}_ms"] = (time.perf_counter() - t0) * 1e3 / n
        out[f"{name}_loader_batches"] = native.LOADS - loads
        if b["x"].shape != (40, 5120):
            raise AssertionError(f"loader batch {b['x'].shape}")
    if out["native_loader_batches"] != n or out["python_loader_batches"] != 0:
        raise AssertionError(f"loader routing: {out}")
    return out


def phase11(k2, k3, tmp: Path, recipe_dump: Path | None):
    """Training at scale on the card: the 2-rank data-parallel step against
    one process, a process group over NCCL through the CLI, the training
    options (EMA codebooks, reseed, time jitter, VQ-dropout; then dropout),
    the native loader against the Python collate path, and the supervisor."""
    import torch

    from wavenet_autoencoders_tpu_torch.cli.main import main as cli
    from wavenet_autoencoders_tpu_torch.data import native
    from wavenet_autoencoders_tpu_torch.kernels import glu_stack as K
    from wavenet_autoencoders_tpu_torch.kernels import upsample as UP
    from wavenet_autoencoders_tpu_torch.parallel import distributed as D
    from wavenet_autoencoders_tpu_torch.train import supervisor as S

    t_phase = time.perf_counter()
    dump = tmp / "dump"
    dirs = make_dump(dump, np.random.default_rng(11))
    rec = {}

    # 1. data parallel: 2 ranks on the card against 1 process
    t0 = time.perf_counter()
    init = f"file://{tmp / 'dp_store'}"
    procs = [subprocess.Popen([sys.executable, str(Path(__file__).resolve()), "--dp-worker", init, str(r), str(dump)],
                              cwd=Path(__file__).resolve().parent, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for r in range(DP_RANKS)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=600)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, out) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            raise AssertionError(f"DP rank {r} exited {p.returncode}:\n{out[-6000:]}")
    ranks = [json.loads(re.search(r"^DP_RANK (\{.*\})$", out, re.M).group(1)) for out in outs]
    dp_wall = time.perf_counter() - t0
    refs = {dtype: dp_steps(dump, hp) for dtype, hp in DP_HP.items()}
    unfused = {dtype: dp_steps(dump, hp.replace("fused_stack=true", "fused_stack=false"))
               for dtype, hp in DP_HP.items()}

    def rel(a, b):
        return {k: [abs(x - y) / abs(y) for x, y in zip(a[k], b[k])] for k in ("loss", "grad_norm")}

    diff = {dtype: rel(ranks[0][dtype], refs[dtype]) for dtype in DP_HP}
    yardstick = {dtype: rel(unfused[dtype], refs[dtype]) for dtype in DP_HP}
    for dtype in DP_HP:
        r0, r1, ref = ranks[0][dtype], ranks[1][dtype], refs[dtype]
        log(f"phase 11: DP {dtype}, {DP_RANKS} ranks x B={r0['rows']} on one card (gloo): losses {r0['loss']}, "
            f"grad norms {r0['grad_norm']}, ms/step {[round(v, 2) for v in r0['ms']]} (rank 1 "
            f"{[round(v, 2) for v in r1['ms']]}); 1 process B={ref['rows']}: losses {ref['loss']}, grad norms "
            f"{ref['grad_norm']}, ms/step {[round(v, 2) for v in ref['ms']]}; rel diff {json.dumps(diff[dtype])}; "
            f"K2/K3 launches per rank {[r[dtype]['launches'] for r in ranks]}, collectives per rank "
            f"{[r[dtype]['collectives'] for r in ranks]}")
    log(f"phase 11: yardstick, 1 process unfused against fused: rel diff {json.dumps(yardstick)}, ms/step "
        f"{json.dumps({d: [round(v, 2) for v in unfused[d]['ms']] for d in DP_HP})}; {dp_wall:.1f} s for both "
        "ranks' processes")
    for dtype in DP_HP:
        for r in ranks:
            if r[dtype]["launches"] != [DP_STEPS, DP_STEPS]:
                raise AssertionError(f"DP {dtype} rank {r['rank']} launched K2/K3 {r[dtype]['launches']}")
            if r[dtype]["rows"] != 40 // DP_RANKS or r[dtype]["loss"] != ranks[0][dtype]["loss"]:
                raise AssertionError(f"DP {dtype} rank {r['rank']}: rows {r[dtype]['rows']}, losses "
                                     f"{r[dtype]['loss']} vs rank 0's")
        if refs[dtype]["launches"] != [DP_STEPS, DP_STEPS]:
            raise AssertionError(f"the 1-process {dtype} steps launched K2/K3 {refs[dtype]['launches']}")
    held = {"bf16 loss": (diff["bf16"]["loss"], TOL_STEP1["loss"]),
            "bf16 step-1 grad_norm": (diff["bf16"]["grad_norm"][:1], TOL_STEP1["grad_norm"]),
            "f32 loss": (diff["f32"]["loss"], TOL_DP_F32["loss"]),
            "f32 step-1 grad_norm": (diff["f32"]["grad_norm"][:1], TOL_DP_F32["grad_norm"])}
    for what, (vals, tol) in held.items():
        if not max(vals) <= tol:
            raise AssertionError(f"DP {what} differs from the 1-process step: {vals} > {tol}")
    for r in ranks:
        count_launches(k2, f"dp_step_rank{r['rank']}", sum(r[d]["launches"][0] for d in DP_HP))
        count_launches(k3, f"dp_step_rank{r['rank']}", sum(r[d]["launches"][1] for d in DP_HP))
    count_launches(k2, "dp_reference", sum(refs[d]["launches"][0] for d in DP_HP))
    count_launches(k3, "dp_reference", sum(refs[d]["launches"][1] for d in DP_HP))
    steps_up = [len(DP_HP) * DP_STEPS] * 2
    for r in ranks:
        up_launches(f"dp_step_rank{r['rank']}", [sum(r[d]["upsample_launches"][i] for d in DP_HP) for i in (0, 1)],
                    steps_up)
    up_launches("dp_reference", [sum(refs[d]["upsample_launches"][i] for d in DP_HP) for i in (0, 1)], steps_up)
    rec["dp"] = {"ranks": ranks, "one_process": refs, "one_process_unfused": unfused, "rel_diff": diff,
                 "yardstick_rel_diff": yardstick, "tol_bf16": TOL_STEP1, "tol_f32": TOL_DP_F32, "wall_s": dp_wall}

    # 2. a process group over NCCL through the CLI (one rank: the card's only)
    K.LAUNCHES_FWD = K.LAUNCHES_BWD = UP.LAUNCHES_FWD = UP.LAUNCHES_BWD = 0
    collectives = D.COLLECTIVES
    t0 = time.perf_counter()
    cli(["train", "--preset", "svqwae", "--hparams", "fused_stack=true", "--device", "cuda", "--max-steps", "3",
         str(dump), str(tmp / "exp_nccl"), "--coordinator", f"127.0.0.1:{free_port()}", "--num-processes", "1",
         "--process-id", "0"])
    nccl = {"backend": D.BACKEND, "collectives": D.COLLECTIVES - collectives, "s": time.perf_counter() - t0,
            "launches": [K.LAUNCHES_FWD, K.LAUNCHES_BWD], "upsample_launches": [UP.LAUNCHES_FWD, UP.LAUNCHES_BWD]}
    log(f"phase 11: train --coordinator 127.0.0.1:<port> --num-processes 1: {json.dumps(nccl)}")
    if nccl["backend"] != "nccl" or nccl["collectives"] < 3 or nccl["launches"] != [3, 3]:
        raise AssertionError(f"the NCCL run: {nccl}")
    if not (tmp / "exp_nccl" / "checkpoint_step000000003.npz").exists():
        raise AssertionError("the NCCL run wrote no checkpoint")
    count_launches(k2, "nccl_cli_train", nccl["launches"][0])
    count_launches(k3, "nccl_cli_train", nccl["launches"][1])
    up_launches("nccl_cli_train", nccl["upsample_launches"], nccl["launches"])
    rec["nccl"] = nccl

    # 3. the training options, then dropout (which skips the fused stack)
    runs = {}
    for name, hp in (("options", OPTIONS_HP), ("dropout", DROPOUT_HP)):
        ckpt = tmp / f"exp_{name}"
        K.LAUNCHES_FWD = K.LAUNCHES_BWD = UP.LAUNCHES_FWD = UP.LAUNCHES_BWD = 0
        t0 = time.perf_counter()
        cli(["train", "--preset", "svqwae", "--hparams", hp, "--device", "cuda", "--max-steps", "3", str(dump),
             str(ckpt)])
        torch.cuda.synchronize()
        recs = [r for r in read_metrics(ckpt) if r["phase"] == "train_no_dev"]
        runs[name] = {"launches": [K.LAUNCHES_FWD, K.LAUNCHES_BWD],
                      "upsample_launches": [UP.LAUNCHES_FWD, UP.LAUNCHES_BWD], "s": time.perf_counter() - t0,
                      "steps": {r["step"]: {k: r[k] for k in ("loss", "grad_norm", "perplexity", "reseeded")}
                                for r in recs}}
        if sorted(runs[name]["steps"]) != [1, 3] or not all(
                np.isfinite([r["loss"], r["grad_norm"], r["aux_loss"], r["perplexity"]]).all() for r in recs):
            raise AssertionError(f"{name} run metrics: {recs}")
    log(f"phase 11: training options {json.dumps(runs)}")
    opts = runs["options"]
    if opts["launches"] != [3, 3] or runs["dropout"]["launches"] != [0, 0]:
        raise AssertionError(f"K2/K3 launches: options {opts['launches']} (predicted [3, 3]), dropout "
                             f"{runs['dropout']['launches']} (predicted [0, 0])")
    if not opts["steps"][3]["reseeded"] > 0:
        raise AssertionError(f"no code reseeded at step 3: {opts['steps']}")
    z = np.load(tmp / "exp_options" / "checkpoint_step000000003.npz")
    state_keys = sorted(k for k in z.files if k.startswith("model_state/"))
    want = {f"model_state/{n}/{i}" for n in ("vq/codebooks", "vq/cluster_size", "vq/ema_w", "usage") for i in (0, 1)}
    if set(state_keys) != want or any(k.startswith("params/vq/") for k in z.files):
        raise AssertionError(f"options checkpoint model_state leaves: {state_keys}")
    scp = tmp / "scp.json"
    scp.write_text(json.dumps([[f"wav/{d.name}.wav", f"{d}/"] for d in dirs[:4]]))
    cli(["infer", "--preset", "svqwae", "--hparams", OPTIONS_HP, "--device", "cuda",
         str(tmp / "exp_options" / "checkpoint_step000000003.npz"), str(scp), str(tmp / "abx"), "--lan", "english"])
    codes = [np.loadtxt(tmp / "abx" / "2019" / "english" / "test" / f"{d.name}.txt") for d in dirs[:4]]
    if any(a.shape != (50, 64) or not np.isfinite(a).all() for a in codes):
        raise AssertionError(f"ABX export of the options checkpoint: {[a.shape for a in codes]}")
    for name, run in runs.items():
        count_launches(k2, f"{name}_cli_train", run["launches"][0])
        count_launches(k3, f"{name}_cli_train", run["launches"][1])
        # dropout skips the fused stack, not the upsampler: one of each a step
        up_launches(f"{name}_cli_train", run["upsample_launches"], (3, 3))
    rec["options"] = {**runs, "model_state_leaves": state_keys}

    # 4. the native loader against the Python collate path
    src = recipe_dump if recipe_dump is not None else dump
    rec["loader"] = {"dump": "phase 10 train_no_dev" if recipe_dump is not None else "phase 11", **loader_ms(src)}
    log(f"phase 11: batch assembly at B=40 x T=5120, host ms: {json.dumps(rec['loader'])}")

    # 5. the supervisor: a 3-step train of the port's CLI, probed on CUDA
    sup_log = tmp / "sup" / "train.log"
    sup_log.parent.mkdir()
    t0 = time.perf_counter()
    rc = S.main(["--steps", "3", "--log", str(sup_log), "--stale-s", "300", "--grace-s", "300", "--poll-s", "1",
                 "--", "train", "--preset", "svqwae", "--hparams", "fused_stack=true", "--device", "cuda",
                 "--max-steps", "3", str(dump), str(tmp / "exp_sup")])
    text = sup_log.read_text()
    rec["supervisor"] = {"rc": rc, "s": time.perf_counter() - t0, "done": (sup_log.parent / "TRAIN_DONE").exists()}
    log(f"phase 11: supervisor {json.dumps(rec['supervisor'])}; log tail: "
        + " | ".join(line for line in text.splitlines() if line.startswith(("supervisor", "step ")))[-600:])
    if rc != 0 or not rec["supervisor"]["done"] or not (tmp / "exp_sup" / "checkpoint_step000000003.npz").exists():
        raise AssertionError(f"the supervised run did not finish: rc {rc}\n{text[-3000:]}")
    rec["phase_s"] = time.perf_counter() - t_phase
    rec["native_loads_in_phase"] = native.LOADS
    log(f"phase 11: {rec['phase_s']:.1f} s")
    k2["phase11"] = rec


# Phase 12a: tensor parallelism, 2 ranks of one model group on the one card
# (gloo on CUDA tensors), B=40 x T=5120 each (the whole batch: data axis 1),
# 3 steps fused and 3 unfused in bf16, against one process. Held to phase
# 11's bf16 bounds: every step's loss 1e-4 and step 1's grad norm 5e-3
# (TOL_STEP1); the logits of the TP checkpoint in one process against the
# TP forward's, f32 (TF32 off) on 4 rows: 1e-4 abs, the f32 kernel bound
# of phase 5 (only the summation order of the row-parallel post2 differs).
TP_RANKS = 2
TP_MESH = 'mesh_shape={"data": -1, "model": 2}'
TP_HP = {"fused": "fused_stack=true", "unfused": "fused_stack=false"}
TOL_TP_LOGITS = 1e-4
# the loop on the model group: train() with its checkpoint, sample-dump and
# decode hooks at step 2 (rank 0 runs them on the gathered weights)
TP_TRAIN_HP = "fused_stack=true,checkpoint_interval=2,train_eval_interval=2," + TP_MESH


def tp_worker(init: str, rank: int, dump: str, tmp: str) -> None:
    """One rank of phase 12a (``--tp-worker``): joins a gloo group of
    TP_RANKS on the card, takes the fused and the unfused TP steps (the
    fused run's checkpoint and logits into ``tmp/tp_ckpt``), then trains 2
    steps through ``train`` into ``tmp/tp_train``, and prints its record as
    a line ``TP_RANK {json}``."""
    import torch

    from wavenet_autoencoders_tpu_torch.config import load_preset
    from wavenet_autoencoders_tpu_torch.kernels import decode as K1
    from wavenet_autoencoders_tpu_torch.kernels import glu_stack as K
    from wavenet_autoencoders_tpu_torch.kernels import upsample as UP
    from wavenet_autoencoders_tpu_torch.parallel import distributed as D
    from wavenet_autoencoders_tpu_torch.train.loop import train

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    D.initialize_distributed(init, TP_RANKS, rank, device="cuda", backend="gloo")
    try:
        rec = {name: dp_steps(Path(dump), f"{hp},{TP_MESH}", ckpt=Path(tmp) / "tp_ckpt" if name == "fused" else None)
               for name, hp in TP_HP.items()}
        K1.LAUNCHES = K.LAUNCHES_FWD = K.LAUNCHES_BWD = UP.LAUNCHES_FWD = UP.LAUNCHES_BWD = 0
        t0 = time.perf_counter()
        train(load_preset("svqwae", TP_TRAIN_HP), dump, str(Path(tmp) / "tp_train"), max_steps=2, log_every=1,
              device="cuda")
        torch.cuda.synchronize()
        rec["train"] = {"s": time.perf_counter() - t0, "launches": [K1.LAUNCHES, K.LAUNCHES_FWD, K.LAUNCHES_BWD],
                        "upsample_launches": [UP.LAUNCHES_FWD, UP.LAUNCHES_BWD]}
        rec.update(rank=rank, device=str(D.local_device("cuda")))
        print("TP_RANK " + json.dumps(rec), flush=True)
    finally:
        D.shutdown()


def phase12(k1, k2, k3, tmp: Path, card: str):
    """Tensor parallelism on the card (12a) and reference ``.pth`` weights
    through the importer, on the card and through K1 (12b)."""
    import torch

    from wavenet_autoencoders_tpu_torch.config import load_preset
    from wavenet_autoencoders_tpu_torch.data.dataset import WaveDataset, data_iterator
    from wavenet_autoencoders_tpu_torch.eval.infer import export_representations
    from wavenet_autoencoders_tpu_torch.eval.synthesize import batch_wavegen
    from wavenet_autoencoders_tpu_torch.kernels import decode as K1
    from wavenet_autoencoders_tpu_torch.models import build_model
    from wavenet_autoencoders_tpu_torch.train.loop import batch_to_device
    from wavenet_autoencoders_tpu_torch.train.step import prep_x
    from wavenet_autoencoders_tpu_torch.utils.params import flatten_params, load_flat_params, load_flat_state, load_jax_params
    from wavenet_autoencoders_tpu_torch.utils.torch_import import import_checkpoint, reference_state_dict

    t_phase = time.perf_counter()
    dump = tmp / "dump"
    make_dump(dump, np.random.default_rng(12))
    rec = {}

    # 12a. 2 TP ranks on the card against 1 process
    t0 = time.perf_counter()
    init = f"file://{tmp / 'tp_store'}"
    me = Path(__file__).resolve()
    procs = [subprocess.Popen([sys.executable, str(me), "--tp-worker", init, str(r), str(dump), str(tmp)], cwd=me.parent,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for r in range(TP_RANKS)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=700)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, out) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            raise AssertionError(f"TP rank {r} exited {p.returncode}:\n{out[-6000:]}")
    ranks = [json.loads(re.search(r"^TP_RANK (\{.*\})$", out, re.M).group(1)) for out in outs]
    tp_wall = time.perf_counter() - t0
    refs = {name: dp_steps(dump, hp, ckpt=tmp / "one_ckpt" if name == "fused" else None) for name, hp in TP_HP.items()}
    diff = {name: {k: [abs(x - y) / abs(y) for x, y in zip(ranks[0][name][k], refs[name][k])]
                   for k in ("loss", "grad_norm")} for name in TP_HP}
    for name in TP_HP:
        r0, r1, ref = ranks[0][name], ranks[1][name], refs[name]
        log(f"phase 12a: TP {name} bf16, {TP_RANKS} ranks of one model group x B={r0['rows']} on one card (gloo), "
            f"{card}: losses {r0['loss']}, grad norms {r0['grad_norm']}, ms/step "
            f"{[round(v, 2) for v in r0['ms']]} (rank 1 {[round(v, 2) for v in r1['ms']]}); model-group collectives "
            f"a step {r0['model_collectives_per_step']:.1f}, {r0['model_bytes_per_step'] / 1e9:.4f} GB a step; peak "
            f"{r0['peak_gib']:.2f} / {r1['peak_gib']:.2f} GiB; 1 process B={ref['rows']}: losses {ref['loss']}, "
            f"grad norms {ref['grad_norm']}, ms/step {[round(v, 2) for v in ref['ms']]}, peak {ref['peak_gib']:.2f} "
            f"GiB; rel diff {json.dumps(diff[name])}; K2/K3 launches per rank {[r[name]['launches'] for r in ranks]}")
    want = {"fused": [DP_STEPS, DP_STEPS], "unfused": [0, 0]}
    for name in TP_HP:
        for i, r in enumerate(ranks):
            if r[name]["launches"] != want[name]:
                raise AssertionError(f"TP {name} rank {i} launched K2/K3 {r[name]['launches']} (predicted {want[name]})")
            if r[name]["rows"] != 40 or r[name]["loss"] != ranks[0][name]["loss"]:
                raise AssertionError(f"TP {name} rank {i}: rows {r[name]['rows']}, losses {r[name]['loss']} vs rank 0's")
        if refs[name]["launches"] != want[name]:
            raise AssertionError(f"the 1-process {name} steps launched K2/K3 {refs[name]['launches']}")
        if not max(diff[name]["loss"]) <= TOL_STEP1["loss"]:
            raise AssertionError(f"TP {name} losses differ from 1 process: {diff[name]['loss']} > {TOL_STEP1['loss']}")
        if not diff[name]["grad_norm"][0] <= TOL_STEP1["grad_norm"]:
            raise AssertionError(f"TP {name} step-1 grad norm differs: {diff[name]['grad_norm'][0]}")
    # the TP checkpoint: the 1-process npz's keys and shapes; in 1 process, the TP forward's logits
    z_tp, z_one = (np.load(tmp / d / "checkpoint_step000000003.npz") for d in ("tp_ckpt", "one_ckpt"))
    if sorted(z_tp.files) != sorted(z_one.files) or any(z_tp[k].shape != z_one[k].shape for k in z_tp.files):
        raise AssertionError("the TP checkpoint's keys or shapes differ from the 1-process checkpoint's")
    cfg = load_preset("svqwae", "fused_stack=true")
    one = build_model(cfg, device="cuda").train()
    load_flat_params(one, z_tp, prefix="params/")
    load_flat_state(one, z_tp)
    first = next(data_iterator(WaveDataset(str(dump), cfg), cfg, prefetch=0,
                               transform=lambda b: batch_to_device(b, torch.device("cuda"))))
    with torch.no_grad():
        y = one(prep_x(cfg, first["x"][:4]), first["c"][:4], first["g"][:4], train=False)[0].float().cpu().numpy()
    tp_logits = np.load(tmp / "tp_ckpt" / "logits.npy")
    logit_err = float(np.abs(y - tp_logits).max())
    log(f"phase 12a: TP checkpoint in 1 process: max|logits - TP logits| {logit_err:.3e} (bound {TOL_TP_LOGITS}, "
        f"max|logits| {np.abs(y).max():.3f}); {len(z_tp.files)} leaves as the 1-process checkpoint")
    if not logit_err <= TOL_TP_LOGITS:
        raise AssertionError(f"TP checkpoint logits differ by {logit_err}")
    # train() on the model group: hooks on rank 0 from the gathered weights
    text0 = outs[0]
    tr = [r["train"] for r in ranks]
    log(f"phase 12a: train() on the model group, 2 steps with the hooks at step 2: {json.dumps(tr)}; "
        f"{tp_wall:.1f} s for both ranks' processes")
    if "mesh: {'data': 1, 'model': 2} over 2 devices" not in text0 or "skipped:" in text0:
        raise AssertionError(f"train() on the model group:\n{text0[-4000:]}")
    # K2: each rank's 2 steps, and rank 0's sample dump (a forward of the full copy)
    if tr[0]["launches"][0] < 1 or tr[1]["launches"][0] != 0 or [t["launches"][1:] for t in tr] != [[3, 2], [2, 2]]:
        raise AssertionError(f"train() on the model group launched K1/K2/K3 {[t['launches'] for t in tr]}")
    for name in ("checkpoint_step000000002.npz", "intermediate/train_no_dev_eval/step000000002_predicted.wav"):
        if not (tmp / "tp_train" / name).exists():
            raise AssertionError(f"train() on the model group wrote no {name}")
    for i, r in enumerate(ranks):
        count_launches(k2, f"tp_step_rank{i}", r["fused"]["launches"][0])
        count_launches(k3, f"tp_step_rank{i}", r["fused"]["launches"][1])
        count_launches(k2, f"tp_checkpoint_logits_rank{i}", r["fused"]["logits_launches"][0])
        count_launches(k1, f"tp_train_hooks_rank{i}", r["train"]["launches"][0])
        count_launches(k2, f"tp_train_rank{i}", r["train"]["launches"][1])
        count_launches(k3, f"tp_train_rank{i}", r["train"]["launches"][2])
    count_launches(k2, "tp_reference", refs["fused"]["launches"][0] + refs["fused"]["logits_launches"][0])
    count_launches(k3, "tp_reference", refs["fused"]["launches"][1])
    for i, r in enumerate(ranks):
        # the steps (fused and unfused), the checkpoint's logits (a forward),
        # and train(): its steps, K2's sample dump and K1's decode on rank 0
        up_launches(f"tp_step_rank{i}", [sum(r[n]["upsample_launches"][j] for n in TP_HP) for j in (0, 1)],
                    [len(TP_HP) * DP_STEPS] * 2)
        up_launches(f"tp_checkpoint_logits_rank{i}", r["fused"]["upsample_logits_launches"], (1, 0))
        t = r["train"]["launches"]
        up_launches(f"tp_train_rank{i}", r["train"]["upsample_launches"], (t[0] + t[1], t[2]))
    up_launches("tp_reference", [sum(refs[n]["upsample_launches"][j] for n in TP_HP) for j in (0, 1)],
                [len(TP_HP) * DP_STEPS] * 2)
    rec["tp"] = {"ranks": ranks, "one_process": refs, "rel_diff": diff, "tol": TOL_STEP1, "logit_err": logit_err,
                 "wall_s": tp_wall}

    # 12b. a reference state_dict (of seeded svqwae weights) through the importer, on the card
    cfg = load_preset("svqwae")
    src = build_model(cfg, device="cuda", seed=12)
    pth = tmp / "reference.pth"
    torch.save({"state_dict": {k: torch.from_numpy(v) for k, v in reference_state_dict(src).items()}, "global_step": 0},
               pth)
    model = build_model(cfg, device="cuda", seed=13)
    load_jax_params(model, import_checkpoint(str(pth), cfg))
    same = all(torch.equal(p, flatten_params(src)[k]) for k, p in flatten_params(model).items())
    rng = np.random.default_rng(12)
    x = torch.from_numpy(rng.integers(0, 256, (2, 5120))).cuda()
    c = torch.from_numpy(rng.standard_normal((2, 32, 39)).astype(np.float32)).cuda()
    g = torch.tensor([3, 70]).cuda()
    with torch.no_grad():
        y_src, y_imp = (m(x, c, g, train=False)[0] for m in (src, model))
    bitwise = bool(torch.equal(y_src, y_imp))
    K1.LAUNCHES = 0
    t0 = time.perf_counter()
    wav = batch_wavegen(cfg, model, rng.standard_normal((4, 40, 39)).astype(np.float32), g=np.array([0, 1, 2, 3]))
    torch.cuda.synchronize()
    wavegen_s, k1_launches = time.perf_counter() - t0, K1.LAUNCHES
    test, utts, _, _, _, scp = make_test_set(tmp / "ref_test", rng, 4, 200, target=None)
    export_representations(cfg, model, str(scp), str(tmp / "ref_abx"), lan="english")
    abx = [np.loadtxt(tmp / "ref_abx" / "2019" / "english" / "test" / f"{u}.txt") for u in utts]
    rec["reference_pth"] = {"params_equal": same, "logits_bitwise": bitwise, "wav_shape": list(wav.shape),
                            "wavegen_s": wavegen_s, "k1_launches": k1_launches, "abx_shapes": [a.shape for a in abx]}
    log(f"phase 12b: reference .pth (svqwae, {len(reference_state_dict(src))} tensors) imported on cuda: "
        f"{json.dumps(rec['reference_pth'])}")
    if not (same and bitwise):
        raise AssertionError(f"the imported weights' logits differ from their source's: {rec['reference_pth']}")
    if wav.shape != (4, 6400) or not np.isfinite(wav).all() or k1_launches < 1:
        raise AssertionError(f"batch_wavegen from the imported weights: {rec['reference_pth']}")
    if any(a.shape != (50, 64) or not np.isfinite(a).all() for a in abx):
        raise AssertionError(f"ABX export from the imported weights: {rec['reference_pth']}")
    count_launches(k1, "reference_pth_batch_wavegen", k1_launches)
    rec["phase_s"] = time.perf_counter() - t_phase
    log(f"phase 12: {rec['phase_s']:.1f} s")
    k2["phase12"] = rec


# Phases 13-15: the quality runs of QUALITY.md's two headline models on the
# card, each at the published widths of its JAX run's frozen config
# (quality2/exp/<run>/config.json) and held to that run's log
# (logs/metrics.jsonl), through the port's quality tools: run K (SVQ-WAE:
# residual 256, gate 368, skip 256, 16 layers in 2 stacks, encoder 768,
# sliced VQ 2 x 256, frame rate 50, B=40 x 5120, bf16) to steps 1500 (13) and
# 4000 (14), and run F (IN-WAE with AdaIN: the same WaveNet, gin 64, encoder
# 384, no VQ, B=24) to step 3000 (15); all fused.
# the threefry kernel's record in the kernel table; the paths that draw from
# JAX keys on the card add their launches to it (``tf_launches``)
TF_REC: dict = {}


def tf_launches(path: str, n: int) -> None:
    """Add a path's launches of the threefry kernel (counted from 0 around
    it) to its record; every such path draws from JAX keys on the card, so
    it must have launched the kernel."""
    if n < 1:
        raise AssertionError(f"{path} drew from JAX keys without launching the threefry kernel")
    count_launches(TF_REC, path, n)


# the upsampler kernels' record in the kernel table; the train paths add
# their launches to it (``up_launches``)
UP_REC: dict = {}


def up_launches(path: str, got, want) -> None:
    """Add a train path's launches of the upsampler kernels, [forward,
    backward] counted from 0 around it, to their record, after holding them
    to ``want``: a step's forward and backward (K2's and K3's where the
    stack is fused, a replay's counted), a forward for each other pass of
    the model (K2's sample dumps and dev passes, K1's decodes)."""
    got, want = [int(n) for n in got], [int(n) for n in want]
    if got != want:
        raise AssertionError(f"{path} launched the upsampler kernels {got} times (forward, backward), "
                             f"expected {want}")
    UP_REC.setdefault("fwd_bwd_by_path", {})[path] = got
    count_launches(UP_REC, path, sum(got))


def threefry_bound(n: int, nbytes: int) -> tuple[float, str]:
    """(ms, what bounds it) of n counters moving nbytes: the larger of the
    integer operations over the SMs' pipes (the rotates and xors over the
    64-lane integer pipe, every operation over the 128-lane issue) and the
    bytes over the memory rate."""
    cycles = max(THREEFRY_ALU_OPS / 64, THREEFRY_OPS / 128)
    ops, by = n * cycles / H100_SM_CLOCKS * 1e3, nbytes / H100_BYTES_PER_S * 1e3
    return max(ops, by), "operations" if ops >= by else "bytes"


@contextlib.contextmanager
def threefry_plain():
    """Every ``utils.jax_random`` draw on the card through the threefry
    kernel's plain version (torch ops on the card) inside the block."""
    from wavenet_autoencoders_tpu_torch.kernels import threefry as TF

    names = ("threefry2x32", "bits", "uniform", "keep_mask")
    kernels = {n: getattr(TF, n) for n in names}
    TF.threefry2x32, TF.bits = TF.threefry2x32_reference, TF.bits_reference
    TF.uniform, TF.keep_mask = TF.uniform_reference, TF.keep_reference
    try:
        yield
    finally:
        for n, f in kernels.items():
            setattr(TF, n, f)


def threefry_loop_sass() -> dict | None:
    """The instruction mix of the dropout-mask kernel's inner loop, one
    counter an iteration: ``cuobjdump -sass`` of the built library, the
    instructions from the target of the innermost backward branch to the
    branch. None where the toolkit has no cuobjdump."""
    import collections

    from wavenet_autoencoders_tpu_torch.kernels import build

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        return None
    sass = subprocess.run([tool, "-sass", str(build._lib_path("threefry"))], capture_output=True, text=True,
                          timeout=120, check=True).stdout
    body = sass.split("iota_kernelILi2EE", 1)[1].split("Function :", 1)[0]  # the keep-mask kernel
    ins = [(int(a, 16), op, args) for a, op, args in
           re.findall(r"/\*([0-9a-f]+)\*/\s+(?:@!?\w+\s+)?([A-Z][A-Z0-9_]*)[.\w]*\s*([^;]*);", body)]
    back = [(int(args.split()[0], 16), a) for a, op, args in ins
            if op == "BRA" and args.startswith("0x") and int(args.split()[0], 16) < a]
    first, last = max(back)
    mix = collections.Counter(op for a, op, _ in ins if first <= a <= last)
    return {"instructions": sum(mix.values()), "by_opcode": dict(mix.most_common())}


DROPOUT_B, DROPOUT_T = 40, 5120
DROPOUT_GRAPH_STEPS = 3
TOL_DROPOUT_STEP1 = 1e-6
TOL_NORMAL = 1e-6


def dropout_masks(cfg, batch: dict, graph: bool) -> tuple[list, list]:
    """The decoder's dropout masks (copies of what the threefry kernel's
    ``keep_mask`` returned inside the step) and the loss of each of an
    svqwae train step's first DROPOUT_GRAPH_STEPS steps on ``batch``,
    graphed or eager. A replay writes the masks into the tensors the
    capture returned, so each step's are read after it."""
    from wavenet_autoencoders_tpu_torch.kernels import threefry as TF
    from wavenet_autoencoders_tpu_torch.models import build_model
    from wavenet_autoencoders_tpu_torch.train.step import init_state, make_train_step

    model = build_model(cfg, device="cuda").train()
    st, step = init_state(cfg, model), make_train_step(cfg, model, graph=graph)
    drawn, kernel, L = [], TF.keep_mask, cfg.layers

    def keep_mask(*a):
        out = kernel(*a)
        drawn.append(out)
        return out

    masks, losses = [], []
    TF.keep_mask = keep_mask
    try:
        for _ in range(DROPOUT_GRAPH_STEPS):
            n = len(drawn)
            st, m = step(st, batch)
            if len(drawn) - n not in (0, L) or len(drawn) < L:
                raise AssertionError(f"a dropout step drew {len(drawn) - n} masks, expected {L} (or 0 in a replay)")
            masks.append([t.clone() for t in drawn[-L:]])
            losses.append(float(m["loss"]))
            del drawn[:-L]
    finally:
        TF.keep_mask = kernel
    return masks, losses


def phase16(tf):
    """The threefry kernel's entry points against their plain version at the
    real draws' keys, counters and offsets, bit for bit; ``normal`` on the
    card against the CPU's within 1e-6; times beside the bound; then an
    unfused svqwae train step with dropout at full width with the kernel's
    masks and with the plain masks."""
    import torch

    from wavenet_autoencoders_tpu_torch.config import load_preset
    from wavenet_autoencoders_tpu_torch.kernels import threefry as TF
    from wavenet_autoencoders_tpu_torch.models import build_model
    from wavenet_autoencoders_tpu_torch.train.step import init_state, make_train_step
    from wavenet_autoencoders_tpu_torch.utils import jax_random as jr

    t_phase = time.perf_counter()
    cfg = load_preset("svqwae", "dropout=0.05")
    B, T, C, L = DROPOUT_B, DROPOUT_T, cfg.residual_channels, cfg.layers
    base = jr.PRNGKey(cfg.seed + 1, "cuda")
    keep = float(np.float32(1.0 - cfg.dropout))
    entries = {}

    def held(name, got, want, n, nbytes, kernel, plain, reps=20):
        eq = all(torch.equal(g, w) for g, w in zip(got, want))
        err = max(float((g.double() - w.double()).abs().max()) for g, w in zip(got, want))
        ms, plain_ms = cuda_time(kernel, reps), cuda_time(plain, max(1, reps // 10))
        bound, by = threefry_bound(n, nbytes)
        entries[name] = {"n": n, "bytes": nbytes, "bit_equal": eq, "max_abs_err": err, "ms": ms,
                         "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by}
        log(f"phase 16: {name}: {n:,} counters, bit for bit {eq} (max abs {err:g}); kernel {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, bound {bound:.4f} ms by {by} ({100 * bound / ms:.1f}% of bound)")
        if not eq:
            raise AssertionError(f"threefry {name}: the kernel and its plain version differ (max abs {err})")

    # (a) the step keys of 256 steps (fold_in) and their splits
    steps = torch.arange(256, device="cuda")
    k0, k1 = base[0].expand(256), base[1].expand(256)
    args = (k0, k1, torch.zeros_like(steps), steps)
    held("(a) fold_in of 256 steps", TF.threefry2x32(*args), TF.threefry2x32_reference(*args), 256, 256 * 24,
         lambda: TF.threefry2x32(*args), lambda: TF.threefry2x32_reference(*args))
    keys = jr.fold_in(base, steps)
    sargs = (keys[:, None, 0], keys[:, None, 1], torch.zeros(2, dtype=torch.int64, device="cuda"),
             torch.arange(2, device="cuda"))
    held("(a) split of 256 keys", TF.threefry2x32(*sargs), TF.threefry2x32_reference(*sargs), 512, 512 * 24,
         lambda: TF.threefry2x32(*sargs), lambda: TF.threefry2x32_reference(*sargs))
    # (b) run K's reseed candidates: randint's two draws of (K,) words for
    # 256 steps of one slice (run K: K = 256, 40 x 16 latent frames)
    rkeys = jr.split(jr.fold_in(jr.fold_in(keys, 0x5EED), 0))[:, 0]
    held("(b) bits of run K's reseed draw", (TF.bits(rkeys, 256),), (TF.bits_reference(rkeys, 256),), 256 * 256,
         256 * 256 * 4, lambda: TF.bits(rkeys, 256), lambda: TF.bits_reference(rkeys, 256))
    cand = jr.randint(jr.fold_in(jr.fold_in(keys, 0x5EED), 0), (256,), 0, 640)
    with threefry_plain():
        cand_plain = jr.randint(jr.fold_in(jr.fold_in(keys, 0x5EED), 0), (256,), 0, 640)
    if not torch.equal(cand, cand_plain):
        raise AssertionError("run K's reseed candidates differ between the kernel and its plain version")
    # the layer-0 dropout key of step 0 (the decoder's first split)
    lkey = jr.split(jr.fold_in(base, 0))[1][None]
    n = B * T * C
    # (c) the uniforms of that draw, and of a MoL sampler's range (lo 1e-5)
    # at a B=256 decode step's 10 mixtures
    held("(c) uniform of the dropout draw", (TF.uniform(lkey, n, 0, 0.0, 1.0),),
         (TF.uniform_reference(lkey, n, 0, 0.0, 1.0),), n, n * 4,
         lambda: TF.uniform(lkey, n, 0, 0.0, 1.0), lambda: TF.uniform_reference(lkey, n, 0, 0.0, 1.0), reps=10)
    lo = float(np.float32(1e-5))
    span = float(np.float32(np.float32(1.0 - 1e-5) - np.float32(lo)))
    held("(c) uniform of a MoL draw", (TF.uniform(lkey, 2560, 0, lo, span),),
         (TF.uniform_reference(lkey, 2560, 0, lo, span),), 2560, 2560 * 4,
         lambda: TF.uniform(lkey, 2560, 0, lo, span), lambda: TF.uniform_reference(lkey, 2560, 0, lo, span))
    # (d) the dropout mask at B=40 x 5120 x 256 (the main path's draw), the
    # rows of data rank 1 of 2, and rows whose counters lie past 2^32
    held("(d) dropout mask", (TF.keep_mask(lkey, n, 0, keep),), (TF.keep_reference(lkey, n, 0, keep),), n, n,
         lambda: TF.keep_mask(lkey, n, 0, keep), lambda: TF.keep_reference(lkey, n, 0, keep), reps=10)
    half = n // 2
    held("(d) rows 20-40 of the dropout mask", (TF.keep_mask(lkey, half, half, keep),),
         (TF.keep_reference(lkey, half, half, keep),), half, half,
         lambda: TF.keep_mask(lkey, half, half, keep), lambda: TF.keep_reference(lkey, half, half, keep), reps=10)
    whole = jr.bernoulli(lkey[0], keep, (B, T, C))
    if not torch.equal(jr.bernoulli(lkey[0], keep, (B, T, C), rows=(B // 2, B)), whole[B // 2:]):
        raise AssertionError("rows 20-40 of the dropout mask are not the slice of the whole draw")
    del whole
    big = (2**20 + 3, 2**12 + 1)
    first = (big[0] - 2) * big[1]
    held("(d) rows past counter 2^32", (TF.keep_mask(lkey, 2 * big[1], first, keep),),
         (TF.keep_reference(lkey, 2 * big[1], first, keep),), 2 * big[1], 2 * big[1],
         lambda: TF.keep_mask(lkey, 2 * big[1], first, keep), lambda: TF.keep_reference(lkey, 2 * big[1], first, keep))
    sass = threefry_loop_sass()
    log(f"phase 16: the mask kernel's loop, one counter (cuobjdump -sass of the build): "
        + ("not measured (no cuobjdump)" if sass is None else
           f"{sass['instructions']} instructions, {json.dumps(sass['by_opcode'])}"))
    # normal: the card's (kernel uniforms, erf_inv in torch ops) against the CPU's
    nk = jr.fold_in(base, 7)
    got, want = jr.normal(nk, (256, 256)).cpu(), jr.normal(nk.cpu(), (256, 256))
    nerr = float(((got - want).abs() / want.abs().clamp_min(1e-3)).max())
    log(f"phase 16: normal (256, 256) on the card against the CPU's: max rel error {nerr:.3g} (bound {TOL_NORMAL})")
    if not nerr <= TOL_NORMAL:
        raise AssertionError(f"normal on the card is {nerr} off the CPU's")
    torch.cuda.empty_cache()

    # the main path: an unfused svqwae train step with dropout at full width,
    # its masks from the kernel and from the plain version
    r = np.random.default_rng(16)
    codes = torch.from_numpy(r.integers(0, 256, (B, T))).cuda()
    batch = {"x": codes, "y": codes[..., None], "lengths": torch.full((B,), T, device="cuda"),
             "c": torch.from_numpy(r.standard_normal((B, T // 160, 39)).astype(np.float32)).cuda(),
             "g": torch.from_numpy(r.integers(0, 153, (B,))).cuda()}
    masks_equal, key = 0, jr.fold_in(base, 0)
    for _ in range(L):
        key, sub = jr.split(key)
        m = jr.bernoulli(sub, 1.0 - cfg.dropout, (B, T, C))
        with threefry_plain():
            masks_equal += int(torch.equal(m, jr.bernoulli(sub, 1.0 - cfg.dropout, (B, T, C))))
        del m
    torch.cuda.empty_cache()
    def first_step(plain: bool) -> dict:
        model = build_model(cfg, device="cuda").train()
        st, step = init_state(cfg, model), make_train_step(cfg, model, graph=False)
        torch.cuda.synchronize()
        TF.LAUNCHES = 0
        with threefry_plain() if plain else contextlib.nullcontext():
            t0 = time.perf_counter()
            _, m = step(st, batch)
            loss = float(m["loss"])
            torch.cuda.synchronize()
            return {"loss": loss, "grad_norm": float(m["grad_norm"]), "ms": (time.perf_counter() - t0) * 1e3,
                    "launches": TF.LAUNCHES}

    first_step(False)  # warm-up: the first unfused step pays cuDNN's and the allocator's set-up
    runs = {"kernel": [], "plain": []}
    for name in ("kernel", "plain", "plain", "kernel"):  # in turns
        runs[name].append(first_step(name == "plain"))
        torch.cuda.empty_cache()
    step1 = {k: {"loss": v[0]["loss"], "grad_norm": v[0]["grad_norm"], "ms": [r["ms"] for r in v],
                 "launches": v[0]["launches"]} for k, v in runs.items()}
    losses = [r["loss"] for v in runs.values() for r in v]
    off = (max(losses) - min(losses)) / min(losses)
    log(f"phase 16: unfused svqwae train step 1 with dropout {cfg.dropout} at B={B} x T={T} bf16: masks of the "
        f"{L} layers bit for bit {masks_equal}/{L}; loss {step1['kernel']['loss']:.7f} with the kernel's masks, "
        f"{step1['plain']['loss']:.7f} with the plain ones (largest rel difference of the 4 steps {off:.2e}, "
        f"bound {TOL_DROPOUT_STEP1}); step 1 took {step1['kernel']['ms']} ms with the kernel "
        f"({step1['kernel']['launches']} launches), {step1['plain']['ms']} ms with the plain draws (host clock, "
        f"in turns after a warm-up step)")
    if masks_equal != L or not off <= TOL_DROPOUT_STEP1:
        raise AssertionError(f"dropout step: {masks_equal}/{L} masks equal, loss off by {off}")
    tf_launches("dropout_train_step", step1["kernel"]["launches"])
    # the dropout step as a CUDA graph: its masks at steps 1-3 (the eager
    # first step, the captured second, a replay), whose keys come from the
    # device step, against the eager step's
    torch.cuda.empty_cache()
    eager, e_loss = dropout_masks(cfg, batch, graph=False)
    torch.cuda.empty_cache()
    graphed, g_loss = dropout_masks(cfg, batch, graph=True)
    held = [sum(torch.equal(a, b) for a, b in zip(e, g)) for e, g in zip(eager, graphed)]
    log(f"phase 16: the dropout step as a CUDA graph: masks of steps 1-{DROPOUT_GRAPH_STEPS} bit for bit against "
        f"the eager step's {held} of {L} each; losses graphed {g_loss}, eager {e_loss}")
    if held != [L] * DROPOUT_GRAPH_STEPS:
        raise AssertionError(f"the graphed dropout step drew other masks than the eager step: {held} of {L}")
    step1["graphed_masks_equal"], step1["graphed_losses"], step1["eager_losses"] = held, g_loss, e_loss
    del eager, graphed
    torch.cuda.empty_cache()
    main = entries["(d) dropout mask"]
    tf.update({"ms": main["ms"], "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
               "bound_by": main["bound_by"], "library_ms": None,  # torch has no threefry (torch.rand is Philox)
               "max_abs_err": max(e["max_abs_err"] for e in entries.values()),
               "shape": f"dropout mask B={B},T={T},C={C}", "entries": entries, "normal_max_rel_err": nerr,
               "mask_loop_sass": sass,
               "dropout_step": step1})
    log(f"phase 16: {time.perf_counter() - t_phase:.1f} s")


QUALITY = Path(__file__).resolve().parent / "quality2"
RUN_K = QUALITY / "exp" / "svqwae_r5_cs0005"
# the "sharp" corpus of QUALITY.md §1 (seed 0)
SHARP_CORPUS = ("--n-unit", "4000", "--n-spk", "20", "--n-voice", "60", "--n-test", "80",
                "--dur-min", "0.05", "--dur-max", "0.12", "--smooth-w", "5")
# The MFCC-baseline ABX of that corpus as the port computes it on a CPU
# (quality.corpus with these arguments, the port's subset / preprocess /
# cmvn / normalize with run K's config, quality.abx): the record of
# quality2/abx_trajectory_r5.json to the digit. Host-only and seeded, so the
# card's host must give it again; 0.1 points is 20 of 20000 triplets (a
# last-bit difference of numpy's FFT may flip a few).
MFCC_ABX_CPU = {"abx_across_speaker_err_pct": 11.13, "abx_within_speaker_err_pct": 9.75,
                "abx_dtw_across_speaker_err_pct": 10.45, "abx_dtw_within_speaker_err_pct": 9.3}
TOL_ABX_PTS = 0.1
# The held window is the run's last 10 log lines. Run K's mean train loss
# over steps 1050-1500 is 3.204 nats (each line within 0.069 of it), over
# 3550-4000 3.048 (2.992-3.097); run F's over 2550-3000 3.059 (2.939-3.152);
# other healthy runs read 3.13-3.15 at 1500 and the collapsed svqwae_sharp
# 3.437 with perplexity 4 (run K: 261-314 at 1500, 316-333 at 4000).
TOL_QR_LOSS = 0.10
MIN_QR_PERPLEXITY = 150.0
# Phase 13's fused run on an NVIDIA H100 80GB HBM3 at 700 W: its window mean
# loss, perplexity range and step-1500 ABX across speakers, printed beside
# the unfused run and phase 14's ABX.
K1500_FUSED = {"window_mean_loss": 3.1577, "perplexity": (318.9, 360.3), "abx_across_speaker_err_pct": 32.70}
# VC utterances (the first of synthesis.txt's 80), batch and length bucket
# (frames, as QUALITY.md's VC run); K1's teacher-mode check
# at the runs' depth: T past the ring wrap of the largest dilation (128)
QR_VC_UTTS, QR_VC_BATCH, QR_VC_PAD, QR_K1_T = 40, 40, 64, 1100
# Step 1 of a quality run against its JAX run's log line: the port draws the
# JAX run's initial weights (PRNGKey(seed) through each module's key splits)
# and reads the same first batch, so only the arithmetic differs (bf16 on an
# H100 against bf16 on a TPU). Held where the record has the metric (run F
# has no codebook); 5e-2 on the grad norm is the bound for two frameworks'
# bf16 convs (tests/test_torch_port_train.py).
TOL_RECORD_STEP1 = {"loss": 1e-3, "aux_loss": 1e-2, "perplexity": 2e-2, "grad_norm": 5e-2}


def nearest_code_bf16_product(flat, codebook):
    """The VQ nearest-code search with the z . e product's inputs rounded
    to bf16 (f32 sums), as a TPU's default-precision f32 dot computes the
    JAX package's ``_nearest_code``; the port computes it in f32. A probe
    of the JAX run's numerics (``--vq-bf16-product``), never the port's
    default."""
    import torch

    flat, codebook = flat.float(), codebook.float()
    cross = flat.to(torch.bfloat16).float() @ codebook.to(torch.bfloat16).float().T
    return (flat.square().sum(1, keepdim=True) + codebook.square().sum(1)[None, :] - 2.0 * cross).argmin(1)


@dataclasses.dataclass(frozen=True)
class QualityRun:
    """One quality run on the card and the records it is held to. The
    corpus, its dumps and the MFCC-baseline hold are shared by every run."""
    phase: int
    run: str                      # the JAX run under quality2/exp: config.json, logs/metrics.jsonl
    label: str                    # its name in QUALITY.md
    key: str                      # the port's experiment dir, and the name of this run's records
    steps: int                    # the launcher's --steps: the lr halves every steps // 2
    max_steps: int                # where the port stops, on that schedule
    window: tuple                 # the held log lines, first and last step
    shown: tuple                  # steps printed beside the record
    abx_refs: tuple               # (label, trajectory run, step) printed beside the ABX
    f0_ref: str                   # quality2 dir of the JAX run's vc_f0_check.json
    abx_below_baseline: bool = False  # hold the ABX across speakers under the MFCC baseline's
    recon_utts: int = 0           # dev reconstructions (K1 at B=1)
    recon_ref: tuple = ()         # (label, quality_metrics.json under quality2) printed beside them
    ce_utts: int = 0              # CE-by-segment utterances (one forward-only K2 each)
    k1_batches: tuple = ()        # kernel checks and times at this depth: K1 at these B, K2/K3 at the run's B
    hparams: str = "fused_stack=true"
    min_perplexity: float = MIN_QR_PERPLEXITY  # the floor held over the window (VQ runs)
    step1_tol: tuple = ()         # (metric, bound) pairs that replace TOL_RECORD_STEP1's
    step1_held: bool = True       # hold step 1 to the run's record (else print it beside it)
    evaluations: bool = True      # infer, ABX, VC and the QualityRun's other evaluations after training
    control_hparams: str = ""     # a second run of one step with these hparams appended
    control_ref: str = ""         # the run under quality2/exp whose step 1 holds the control's


QUALITY_RUNS = {
    13: QualityRun(13, "svqwae_r5_cs0005", "run K", "quality", 6000, 1500, (1050, 1500), (1, 500, 1000, 1500),
                   abx_refs=(("run I", "run_I", 2000), ("run K", "run_K", 4000)), f0_ref="syn_out_svqK",
                   recon_utts=2, recon_ref=("run D at step 14000", "exp/svqwae_r4/quality_metrics.json"),
                   ce_utts=8, k1_batches=(1, 40)),
    14: QualityRun(14, "svqwae_r5_cs0005", "run K", "quality_k4000", 6000, 4000, (3550, 4000),
                   (1, 1000, 2000, 3000, 3500, 4000),
                   abx_refs=(("run K", "run_K", 4000), ("run K", "run_K", 6000)), f0_ref="syn_out_svqK",
                   abx_below_baseline=True),
    15: QualityRun(15, "inwae_r5", "run F", "quality_f", 20000, 3000, (2550, 3000), (1, 500, 1000, 2000, 3000),
                   abx_refs=(("run F", "run_inwae_r5", 9000),), f0_ref="syn_out_inwae",
                   recon_utts=2, recon_ref=("run F at step 20000", "exp/inwae_r5/quality_metrics.json"),
                   k1_batches=(1, 24)),
    # run E: time jitter from step 0 (per_side false), drawn from the JAX
    # step's keys. Its record's step 1 comes from the JAX package of round 4,
    # whose initial state neither key convention reproduces (step1_conventions.py:
    # loss 3.3e-4 and 2.4e-3 off, perplexity 7.7 and 13 % off), so it is
    # printed, not held. The control, run E's config with the jitter gated
    # past step 1 as run G's (svqwae_r5, round 5: the same config but for
    # the gate, the schedule and the intervals), holds run G's step 1
    # within 1e-5 in the loss. At the initial weights the bf16 gate
    # pre-activations round the conditioning's share away, so step 1's
    # loss does not see the jitter; its grad norm does. The perplexity floor
    # is half run E's window minimum (128.2; a collapse reads ~4); its
    # recorded ABX predates the stale-EMA fix (QUALITY.md): no evaluations.
    17: QualityRun(17, "svqwae_r4j", "run E", "quality_e", 14000, 2000, (1550, 2000),
                   (1, 500, 550, 1000, 1500, 2000), abx_refs=(), f0_ref="", min_perplexity=64.0,
                   step1_tol=(("loss", 1e-5),), step1_held=False, evaluations=False,
                   control_hparams="time_jitter_start=3000", control_ref="svqwae_r5"),
}


def vc_decodes(dump: Path, syn_list: Path, frame_rate: int, pad: int, batch: int, by_target: bool = False) -> int:
    """K1 launches of ``synthesize --batch B --pad-frames-multiple P`` over
    a synthesis list: ``run_synthesis_list`` decodes each group of equal
    padded frame counts (and, for the IN family, equal target speaker) in
    chunks of B."""
    div, sizes = 100 // frame_rate, {}
    for line in syn_list.read_text().split("\n"):
        if line.strip():
            utt, tar = line.split()
            n = len(np.load(dump / utt / "mfcc.norm.npy"))
            n += -n % div
            n += -n % pad
            k = (n, tar if by_target else None)
            sizes[k] = sizes.get(k, 0) + 1
    return sum(-(-v // batch) for v in sizes.values())


def quality_train_launches(cfg, n_train: int, n_dev: int, steps: int) -> dict:
    """Launches of a quality run's ``train`` call, as the loop makes them:
    one K2 and one K3 a fused step; one forward-only K2 for the sample dump
    at each checkpoint (every ``checkpoint_interval`` steps); at each
    ``dev_epoch_interval``-th epoch (the sampler drops the ragged tail, so
    an epoch is n_train // batch_size steps) the dev pass, one K2 for each
    of its n_dev // dev_batch_size batches and one more on the EMA shadow;
    no decode hook (the launcher's intervals are 1e6). Unfused, none."""
    if not cfg.fused_stack:
        return {"K1": 0, "K2": 0, "K3": 0}
    epochs = steps // (n_train // cfg.batch_size)
    dev = epochs // cfg.dev_epoch_interval * (n_dev // cfg.dev_batch_size)
    dev *= 2 if cfg.exponential_moving_average else 1
    return {"K1": 0, "K2": steps + steps // cfg.checkpoint_interval + dev, "K3": steps}


def quality_corpus(q: Path, timed, p: str) -> dict:
    """The sharp corpus under ``q`` and its dumps (``subset``,
    ``preprocess``, ``cmvn``, ``normalize``), and the MFCC-baseline ABX held
    to the CPU's. Run K's config prepares it; run F's differs from it in no
    key the preparation reads."""
    from wavenet_autoencoders_tpu_torch.cli.main import main as cli
    from wavenet_autoencoders_tpu_torch.quality import abx, corpus

    raw, dumps, scp = q / "raw", q / "dump" / "2019" / "english", q / "scp" / "2019"
    preset, jobs = str(RUN_K / "config.json"), str(os.cpu_count() or 1)
    sp2ind = scp / "2019_speaker2ind_english.json"
    splits = ("train_no_dev", "dev", "test")
    timed("corpus", lambda: corpus.main([str(raw), *SHARP_CORPUS, "--jobs", jobs]))

    def prep():
        cli(["subset", "english", str(raw), str(q / "dump" / "2019"), str(scp)])
        for s in splits:
            cli(["preprocess", "--preset", preset, str(scp / f"{s}_src_dst.json"), str(dumps / s), str(sp2ind),
                 "--num-workers", jobs])
        cli(["cmvn", "mfcc", str(q / "cmvn.npz"), str(scp / "train_no_dev_src_dst.json")])
        for s in splits:
            cli(["normalize", str(scp / f"{s}_src_dst.json"), "mfcc", str(q / "cmvn.npz")])

    timed("prep", prep)
    n_utts = {s: len(json.loads((scp / f"{s}_src_dst.json").read_text())) for s in splits}
    if n_utts != {"train_no_dev": 4020, "dev": 40, "test": 80}:
        raise AssertionError(f"the sharp corpus split into {n_utts}, expected 4020 / 40 / 80")

    # the MFCC baseline (host only, deterministic)
    labels = json.loads((raw / "test_phone_labels.json").read_text())
    traj = json.loads((QUALITY / "abx_trajectory_r5.json").read_text())
    base = timed("mfcc_abx", lambda: abx.score(abx.mfcc_vectors(dumps / "test", sorted(labels)), labels, 100.0))
    off = {k: abs(base[k] - v) for k, v in MFCC_ABX_CPU.items()}
    log(f"{p}: MFCC baseline ABX across / within / DTW across / DTW within "
        f"{' / '.join(str(base[k]) for k in MFCC_ABX_CPU)} % ({base['n_segments']} segments); CPU "
        f"{' / '.join(str(v) for v in MFCC_ABX_CPU.values())}; recorded (abx_trajectory_r5.json) "
        f"{' / '.join(str(traj['mfcc_baseline'][k]) for k in MFCC_ABX_CPU)}")
    if not max(off.values()) <= TOL_ABX_PTS:
        raise AssertionError(f"MFCC-baseline ABX {base} is off the CPU's {MFCC_ABX_CPU} by {off}")
    return {"q": q, "raw": raw, "dumps": dumps, "sp2ind": sp2ind, "traj": traj, "mfcc_abx": base}


def quality_run(spec: QualityRun, k1, k2, k3, tmp: Path, shared: dict | None) -> dict:
    """One quality run (phase 13, 14 or 15): the shared corpus (made here
    when ``shared`` is None), the run's steps through ``quality.run`` held
    to its JAX run's log, then the ABX, reconstructions, voice conversion
    and CE by segment the spec asks for, each beside its JAX run's record,
    and the kernels at the run's depth against their plain versions.
    Returns the shared corpus."""
    import torch

    from wavenet_autoencoders_tpu_torch.config import Config
    from wavenet_autoencoders_tpu_torch.data.dataset import WaveDataset
    from wavenet_autoencoders_tpu_torch.kernels import decode as K1
    from wavenet_autoencoders_tpu_torch.kernels import glu_stack as K
    from wavenet_autoencoders_tpu_torch.kernels import threefry as TF
    from wavenet_autoencoders_tpu_torch.kernels import upsample as UP
    from wavenet_autoencoders_tpu_torch.quality import recon, run

    t_phase = time.perf_counter()
    p = f"phase {spec.phase}"
    ref_dir = QUALITY / "exp" / spec.run
    secs, rec = {}, {}

    def timed(name, fn):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        secs[name] = time.perf_counter() - t0
        log(f"{p}: {name}: {secs[name]:.1f} s")
        return out

    shared = shared or quality_corpus(tmp, timed, p)
    q, raw, dumps, sp2ind, traj = (shared[k] for k in ("q", "raw", "dumps", "sp2ind", "traj"))
    exp = q / "exp" / spec.key
    rec["mfcc_abx"] = shared["mfcc_abx"]

    # 1. the run's steps on its JAX run's schedule
    def train(exp_dir, max_steps, hparams):
        return run.train_main(["--root", str(q), "--exp", str(exp_dir.relative_to(q)), "--steps", str(spec.steps),
                               "--max-steps", str(max_steps), "--preset", str(ref_dir / "config.json"),
                               "--hparams", hparams])

    K.LAUNCHES_FWD = K.LAUNCHES_BWD = K1.LAUNCHES = TF.LAUNCHES = UP.LAUNCHES_FWD = UP.LAUNCHES_BWD = 0
    with tee_stdout() as out:
        timed("train", lambda: train(exp, spec.max_steps, spec.hparams))
    launches = {"K1": K1.LAUNCHES, "K2": K.LAUNCHES_FWD, "K3": K.LAUNCHES_BWD}
    tf_launches(f"{spec.key}_train", TF.LAUNCHES)
    up_train = (UP.LAUNCHES_FWD, UP.LAUNCHES_BWD)
    text = out.getvalue()
    form = graph_form(text, p)
    cfg = Config.load(exp / "config.json")
    n_train, n_dev = (len(WaveDataset(str(dumps / s), cfg)) for s in ("train_no_dev", "dev"))
    predicted = quality_train_launches(cfg, n_train, n_dev, spec.max_steps)
    got = {r["step"]: r for r in recon.read_metrics(exp)[0]}  # the closing line repeats the last step
    ref = {r["step"]: r for r in recon.read_metrics(ref_dir)[0]}
    lines, loss = recon.log_window(exp, *spec.window)
    ref_lines, ref_loss = recon.log_window(ref_dir, *spec.window)
    win = [r["step"] for r in lines]
    perps = [r["perplexity"] for r in lines]
    vq = max(r["perplexity"] for r in ref_lines) > 0  # a codebook: its perplexity floor is held
    last = max(got)
    ms_step = (got[last]["time"] - got[100]["time"]) / (last - 100) * 1e3
    reseeded = {s: got[s]["reseeded"] for s in sorted(got) if got[s]["reseeded"]}
    ref_reseeded = {s: ref[s]["reseeded"] for s in sorted(ref) if s <= last and ref[s].get("reseeded")}
    tol1 = {**TOL_RECORD_STEP1, **dict(spec.step1_tol)}

    def against(line, record, label):
        """Step 1's metrics against a record's step-1 line: {metric: (got,
        record, rel)}, the printed comparison, and the metrics off their bound."""
        cmp = {k: (line[k], record[k], abs(line[k] - record[k]) / abs(record[k])) for k in tol1 if record.get(k)}
        txt = "; ".join(f"{k} {g:.10g} ({label} {r:.10g}, rel {d:.2e}, bound {tol1[k]:g})"
                        for k, (g, r, d) in cmp.items())
        return cmp, txt, {k: v for k, v in cmp.items() if not v[2] <= tol1[k]}

    step1, txt, step1_off = against(got[1], ref[1], spec.label)
    log(f"{p}: step 1 against {spec.label}'s record: {txt}"
        + ("" if not spec.step1_held else " -- off" if step1_off else " -- held"))
    rec["step1"] = step1
    if not spec.step1_held:
        step1_off = {}
    if spec.control_hparams:
        # the control: step 1 of the config with these hparams, held to
        # another run's record
        ctl = q / "exp" / f"{spec.key}_control"
        with tee_stdout():
            timed("control", lambda: train(ctl, 1, f"{spec.hparams},{spec.control_hparams}"))
        c1 = {r["step"]: r for r in recon.read_metrics(ctl)[0]}[1]
        cref = recon.read_metrics(QUALITY / "exp" / spec.control_ref)[0][0]
        ctl_cmp, txt, ctl_off = against(c1, cref, spec.control_ref)
        log(f"{p}: control, step 1 with {spec.control_hparams} against {spec.control_ref}'s record: {txt}"
            + (" -- off" if ctl_off else " -- held") + f"; the jittered step's loss {got[1]['loss']:.10g}, "
            f"grad norm {got[1]['grad_norm']:.10g}")
        rec["control_step1"] = ctl_cmp
        step1_off.update({f"control {k}": v for k, v in ctl_off.items()})
        shutil.rmtree(ctl)
    for s in spec.shown:
        log(f"{p}: step {s}: loss {got[s]['loss']:.4f} perplexity {got[s]['perplexity']:.1f} "
            f"({spec.label} {ref[s]['loss']:.4f}, {ref[s]['perplexity']:.1f})")
    perp_txt = (f"perplexity {min(perps):.1f}-{max(perps):.1f} (floor {spec.min_perplexity}; {spec.label} "
                f"{min(r['perplexity'] for r in ref_lines):.1f}-{max(r['perplexity'] for r in ref_lines):.1f}); "
                f"reseeded {json.dumps(reseeded)} ({spec.label} {json.dumps(ref_reseeded)}); " if vq else "")
    log(f"{p}: steps {win[0]}-{win[-1]} ({len(win)} lines): mean loss {loss:.4f} nats ({spec.label} {ref_loss:.4f}, "
        f"bound +-{TOL_QR_LOSS}), {perp_txt}grad norm at step {last} {got[last]['grad_norm']:.4f}; "
        f"{ms_step:.2f} ms a step over steps 100-{last} (host clock, log times; {form}); launches "
        f"{json.dumps(launches)} (predicted {json.dumps(predicted)}, a replay's counted)")
    if not cfg.fused_stack and spec.phase == 13:
        log(f"{p}: {spec.hparams}: beside the fused run's mean loss {K1500_FUSED['window_mean_loss']}, perplexity "
            f"{K1500_FUSED['perplexity'][0]}-{K1500_FUSED['perplexity'][1]} and ABX across speakers "
            f"{K1500_FUSED['abx_across_speaker_err_pct']} % (phase 13 on an H100)")
    if len(win) != 10 or win[-1] != spec.max_steps or not abs(loss - ref_loss) <= TOL_QR_LOSS:
        raise AssertionError(f"mean train loss over {win} is {loss}, {spec.label}'s {ref_loss} +- {TOL_QR_LOSS}")
    if vq and not min(perps) >= spec.min_perplexity:
        raise AssertionError(f"perplexity fell to {min(perps)} in steps {win} (floor {spec.min_perplexity})")
    if "collapse_abort" in text:
        raise AssertionError("the collapse monitor aborted the quality run")
    if launches != predicted:
        raise AssertionError(f"quality train launched {launches}, the loop predicts {predicted}")
    rec["train"] = {"window_mean_loss": loss, "ref_window_mean_loss": ref_loss, "perplexity": perps,
                    "reseeded": reseeded, "last_grad_norm": got[last]["grad_norm"], "ms_per_step": ms_step,
                    "form": form, "launches": launches, "n_train": n_train, "n_dev": n_dev}
    count_launches(k2, f"{spec.key}_train", launches["K2"])
    count_launches(k3, f"{spec.key}_train", launches["K3"])
    # the upsampler runs in every pass of the model, fused or not: the
    # passes the fused run's K1, K2 and K3 would count
    passes = quality_train_launches(cfg.replace(fused_stack=True), n_train, n_dev, spec.max_steps)
    up_launches(f"{spec.key}_train", up_train, (passes["K2"] + passes["K1"], passes["K3"]))
    if spec.evaluations:
        quality_evaluations(spec, cfg, exp, shared, timed, secs, rec, k1, k2, k3)
    rec["host_s"] = secs
    rec["phase_s"] = time.perf_counter() - t_phase
    log(f"{p}: host seconds {json.dumps({k: round(v, 1) for k, v in secs.items()})}; {rec['phase_s']:.1f} s")
    k2[f"{spec.key}_run"] = rec
    shutil.rmtree(exp)  # its checkpoints; a later run needs the disk
    # held last, so that a miss still prints every evaluation of the run
    if step1_off:
        raise AssertionError(f"step 1 is off its record: {step1_off} (bounds {tol1})")
    return shared


def quality_evaluations(spec: QualityRun, cfg, exp: Path, shared: dict, timed, secs: dict, rec: dict, k1, k2, k3):
    """A quality run's evaluations of its last checkpoint (the raw weights:
    the 0.9999 shadow is not warm before step 50000): the ABX of its
    export, dev reconstructions, voice conversion and its F0, CE by segment,
    each beside its JAX run's record and with K1/K2 launched as predicted;
    then the kernels at the run's depth."""
    from wavenet_autoencoders_tpu_torch.cli.main import _load_model
    from wavenet_autoencoders_tpu_torch.cli.main import main as cli
    from wavenet_autoencoders_tpu_torch.kernels import decode as K1
    from wavenet_autoencoders_tpu_torch.kernels import glu_stack as K
    from wavenet_autoencoders_tpu_torch.quality import abx, ce_by_segment, recon, run, vc_f0

    p, step = f"phase {spec.phase}", spec.max_steps
    q, raw, dumps, sp2ind, traj = (shared[k] for k in ("q", "raw", "dumps", "sp2ind", "traj"))
    ckpt, abx_dir = exp / "checkpoint_latest.npz", f"abx_{spec.key}"
    timed("infer", lambda: run.infer_main(["--root", str(q), str(ckpt.relative_to(q)), abx_dir]))
    lat = timed("abx", lambda: abx.main([str(q / abx_dir / "2019" / "english" / "test"),
                                         str(raw / "test_phone_labels.json"), str(dumps / "test"),
                                         str(cfg.frame_rate)]))["latents"]
    keys = ("abx_across_speaker_err_pct", "abx_within_speaker_err_pct", "abx_dtw_across_speaker_err_pct")
    refs = [f"{label} at step {s} {' / '.join(str(pt['abx'][k]) for k in keys)}"
            for label, r, s in spec.abx_refs for pt in traj["runs"][r] if pt["step"] == s]
    log(f"{p}: ABX at step {step} across / within / DTW across {' / '.join(str(lat[k]) for k in keys)} %; "
        f"{', '.join(refs)}")
    rec[f"abx_step{step}"] = lat
    across, base = lat[keys[0]], MFCC_ABX_CPU[keys[0]]
    if spec.abx_below_baseline:  # held after the evaluations below have printed
        log(f"{p}: ABX across speakers {across} % against the MFCC baseline's {base} % (held below it); phase "
            f"13's codes at step 1500 {K1500_FUSED['abx_across_speaker_err_pct']} %")

    model = _load_model(cfg, str(ckpt), use_ema="auto", device="cuda")
    syn_list = q / f"synthesis_{spec.key}.txt"
    syn_list.write_text("".join(f"{line}\n" for line in (raw / "synthesis.txt").read_text().split("\n")[:QR_VC_UTTS]))
    in_family = cfg.name.lower() in ("inae", "inae1", "new_inae")
    predicted = {"K1": spec.recon_utts + vc_decodes(dumps / "test", syn_list, cfg.frame_rate, QR_VC_PAD, QR_VC_BATCH,
                                                    by_target=in_family),
                 "K2": spec.ce_utts if cfg.fused_stack else 0, "K3": 0}
    K.LAUNCHES_FWD = K.LAUNCHES_BWD = K1.LAUNCHES = 0
    finite = {}
    if spec.recon_utts:
        rows = timed("recon", lambda: recon.reconstruction_metrics(cfg, model, dumps / "dev", n_utts=spec.recon_utts))
        calib = timed("calibration", lambda: recon.mismatched_calibration(cfg, dumps / "test"))
        ref_label, ref_path = spec.recon_ref
        rq = json.loads((QUALITY / ref_path).read_text())
        mcd, l1 = float(np.mean([r["mcd_db"] for r in rows])), float(np.mean([r["mel_l1"] for r in rows]))
        samples = sum(r["dur_sec"] for r in rows) * cfg.sample_rate
        log(f"{p}: reconstruction of {len(rows)} dev utterances ({samples:.0f} samples, K1 at B=1, "
            f"{secs['recon'] / samples * 1e3:.4f} ms a sample with scoring): MCD {mcd:.2f} dB, mel-L1 {l1:.3f}; "
            f"calibration {calib['mcd_db_mismatched_gt_pairs']:.2f} dB / {calib['mel_l1_mismatched_gt_pairs']:.3f}; "
            f"{ref_label} dev {rq['dev_mcd_db_mean']:.2f} / {rq['dev_mel_l1_mean']:.3f}, calibration "
            f"{rq['mcd_db_mismatched_gt_pairs']:.2f} / {rq['mel_l1_mismatched_gt_pairs']:.3f}")
        finite[f"{len(rows)} reconstructions"] = [mcd, l1]
        rec["recon"] = {"mcd_db": mcd, "mel_l1": l1, **calib}
    recon_k1 = K1.LAUNCHES
    syn = q / f"syn_out_{spec.key}"
    timed("synthesize", lambda: cli(["synthesize", "--preset", str(exp / "config.json"), str(ckpt), str(dumps / "test"),
                                     str(syn), str(syn_list), str(sp2ind), "english",
                                     "--train-dump-root", str(dumps / "train_no_dev"), "--batch", str(QR_VC_BATCH),
                                     "--pad-frames-multiple", str(QR_VC_PAD)]))
    vc_k1 = K1.LAUNCHES - recon_k1
    f0 = timed("vc_f0", lambda: vc_f0.main([str(q), str(syn), "V001"]))
    f0_ref = json.loads((QUALITY / spec.f0_ref / "vc_f0_check.json").read_text())
    parts = ("source_test", "target_natural", "vc_output")
    log(f"{p}: VC median F0 source / target / output {' / '.join(str(f0[k]['median_f0_hz']) for k in parts)} Hz; "
        f"{spec.label} {' / '.join(str(f0_ref[k]['median_f0_hz']) for k in parts)} Hz")
    finite["VC F0"] = [f0[k]["median_f0_hz"] for k in parts]
    rec["vc_f0"] = f0
    # keep the inputs of each of CE's K2 forwards (B=1 x a whole utterance)
    # to hold the kernel against its plain version on them below
    ce_args, k2_wrapper, ce_txt = [], K.glu_stack_forward, ""
    if spec.ce_utts:
        def keep_inputs(*a):
            ce_args.append(a)
            return k2_wrapper(*a)

        K.glu_stack_forward = keep_inputs
        try:
            ce = timed("ce_by_segment", lambda: ce_by_segment.ce_by_segment(cfg, model, q, spec.ce_utts))
        finally:
            K.glu_stack_forward = k2_wrapper
        finite["CE by segment"] = [ce[c]["ce_nats"] for c in ce_by_segment.CLASSES]
        rec["ce_by_segment"] = ce
        ce_txt = " / ".join(f"{ce[c]['ce_nats']:.3f}" for c in ce_by_segment.CLASSES)
        ce_txt = f"CE by segment vowel / fricative / other {ce_txt} nats; "
    ev_launches = {"K1": K1.LAUNCHES, "K2": K.LAUNCHES_FWD, "K3": K.LAUNCHES_BWD}
    log(f"{p}: {ce_txt}evaluation launches {json.dumps(ev_launches)} (predicted {json.dumps(predicted)}: K1 "
        f"{spec.recon_utts} reconstructions + {vc_k1} VC decodes)")
    if ev_launches != predicted:
        raise AssertionError(f"evaluation launched {ev_launches}, the code predicts {predicted}")
    for name, v in finite.items():
        if not np.isfinite(v).all():
            raise AssertionError(f"{name}: {v}")
    rec["eval_launches"] = ev_launches
    if spec.recon_utts:
        count_launches(k1, f"{spec.key}_recon", recon_k1)
    count_launches(k1, f"{spec.key}_synthesize", vc_k1)
    if spec.ce_utts:
        count_launches(k2, f"{spec.key}_ce_by_segment", ev_launches["K2"])
    if spec.k1_batches:
        t0 = time.perf_counter()
        depth_checks(spec, cfg, model, dumps, ce_args, k1, k2, k3, rec)
        secs["l16_checks_and_times"] = time.perf_counter() - t0
    if spec.abx_below_baseline and not across < base:
        raise AssertionError(f"ABX across speakers of the step-{step} codes is {across} %, not below the MFCC "
                             f"baseline's {base} %")


def depth_checks(spec: QualityRun, cfg, model, dumps: Path, ce_args: list, k1, k2, k3, rec: dict):
    """K1, K2 and K3 at a quality run's depth (L=16, frame rate 50) against
    their plain versions on the same inputs, at phase 1's and phase 5's
    bounds: K2 on the inputs of CE's forwards (trained weights), K2/K3 at
    the run's B x T=5120 bf16 (seeded), K1 in teacher mode at the spec's
    batches (T=1100, seeded weights of the run's widths); then their times
    (CUDA events) beside their bounds. None of these launches is counted."""
    import torch

    from wavenet_autoencoders_tpu_torch.kernels import decode as K1
    from wavenet_autoencoders_tpu_torch.kernels import glu_stack as K
    from wavenet_autoencoders_tpu_torch.models import build_model

    p, L, B = f"phase {spec.phase}", cfg.layers, cfg.batch_size
    tag = f"L{L}" if spec.phase == 13 else f"{spec.key}_L{L}"
    errs_l16 = {}
    with torch.no_grad():
        # K2 on CE's own inputs: B=1 x each whole utterance, the trained weights
        for i, a in enumerate(ce_args):
            got, want = K.glu_stack_forward(*a), K.glu_stack_forward_reference(*a)
            errs = {k: rel_err(g, w) for k, g, w in zip(("skips", "hfin", "ab"), got, want)}
            ce_store = "bfloat16" if a[0].dtype == torch.bfloat16 else "float32"
            check_glu(errs, ce_store, f"CE forward {i} B=1 T={a[0].shape[1]}")
            errs_l16[f"ce{i}_B1_T{a[0].shape[1]}"] = errs
            k2["max_abs_err"] = max(k2["max_abs_err"] or 0.0,
                                    max((g.float() - w.float()).abs().max().item() for g, w in zip(got, want)))
            del got, want
        ce_args.clear()
    if errs_l16:
        ce_rel = max(max(e.values()) for e in errs_l16.values())
        log(f"{p}: K2 on CE's {len(errs_l16)} forwards ({', '.join(errs_l16)}) against the plain version: "
            f"{ce_store} storage, max rel error {ce_rel:.3g} (bound {TOL_GLU[ce_store][0]})")
    # K2/K3 at the training shape, B x T=5120 bf16, seeded inputs
    rng = np.random.default_rng(13)
    C, G, S, cin = cfg.residual_channels, cfg.gate_channels, cfg.skip_out_channels, cfg.cin_channels
    x, c, g_add, w, dils = glu_inputs(B, 5120, torch.bfloat16, rng, C=C, G=G, S=S, cin=cin, L=L, stacks=cfg.stacks)
    args = (x, c, g_add, w["wconv"], w["bconv"], w["wc"], w["wout"], w["bout"], w["wskip"], w["bskip"], dils)
    dskips = torch.from_numpy(rng.standard_normal((B, 5120, S)).astype(np.float32)).cuda().to(torch.bfloat16)
    with torch.no_grad():
        fwd = K.glu_stack_forward(*args)
        p_fwd = K.glu_stack_forward_reference(*args)
        hfin, ab = fwd[1], fwd[2]
        bargs = (c, ab, w["wconv"], w["wc"], w["wout"], w["bout"], w["wskip"], dils, True)
        grads = K.glu_stack_backward(dskips, hfin, *bargs)
        p_grads = K.glu_stack_backward_reference(dskips, hfin, *bargs)
        torch.cuda.synchronize()
        errs, a2, a3 = glu_errors(fwd, p_fwd, grads, p_grads)
        del fwd, p_fwd, grads, p_grads
        log(f"{p}: K2/K3 at L={L}, B={B} x T=5120 bfloat16 against the plain versions: "
            f"rel errors {json.dumps({k: float(f'{v:.3g}') for k, v in errs.items()})}")
        check_glu(errs, "bfloat16", f"L={L} B={B} T=5120")
        errs_l16[f"B{B}_T5120"] = errs
        k2["max_abs_err"], k3["max_abs_err"] = max(k2["max_abs_err"] or 0.0, a2), max(k3["max_abs_err"] or 0.0, a3)
        k2_ms = cuda_time(lambda: K.glu_stack_forward(*args), reps=3)
        k3_ms = cuda_time(lambda: K.glu_stack_backward(dskips, hfin, *bargs), reps=3)
        del x, c, g_add, w, args, hfin, ab, bargs, dskips
        # K1 in teacher mode at the run's widths, seeded weights (phase 1's
        # bounds hold at random init), at B=1 (reconstruction) and the
        # spec's larger batch
        k1_errs = {}
        net = build_model(cfg, device="cuda", seed=13).wavenet
        for b in spec.k1_batches:
            e = k1_errors(net, b, QR_K1_T, np.random.default_rng(13), ("bfloat16",))
            log(f"{p}: K1 at L={L}, frame rate {cfg.frame_rate}, B={b} T={QR_K1_T} teacher mode: "
                f"max|kernel - plain| {json.dumps(e)} bounds {json.dumps(K1_BOUNDS)}")
            for k, v in e.items():
                if not np.isfinite(v) or v > K1_BOUNDS[k]:
                    raise AssertionError(f"K1 L={L} B={b} {k} = {v} exceeds {K1_BOUNDS[k]}")
            k1_errs[f"{tag}_B{b}_T{QR_K1_T}"] = e
        del net
        k1.setdefault("errors", {}).update(k1_errs)
        k1["max_abs_err"] = max([k1["max_abs_err"] or 0.0] + [e["bf16_vs_plain_bf16"] for e in k1_errs.values()])
        feats = np.load(dumps / "dev" / sorted(d.name for d in (dumps / "dev").iterdir() if d.is_dir())[0]
                        / "mfcc.norm.npy").astype(np.float32)[: 5120 // cfg.get_hop_size()]
        lat = model.encode(torch.from_numpy(feats).cuda()[None])
        k1_ms, k1_bound_ms = {}, {}
        packed = K1.pack_decode_weights(model.wavenet)
        for b in spec.k1_batches:
            g = torch.zeros(b, dtype=torch.long, device="cuda")
            k1_ms[b] = cuda_time(lambda: model.wavenet.decode_kernel(5120, c=lat.expand(b, -1, -1), g=g, seed=0),
                                 reps=1) / 5120
            k1_bound_ms[b] = max(k1_bound(model.wavenet, packed, b, 5120, True)[1:]) / 5120
    f2, by2, f3, by3 = glu_bound(B, 5120, C=C, G=G, S=S, cin=cin, L=L)
    log(f"{p}: at L={L}, B={B} x T=5120 bf16: K2 {k2_ms:.2f} ms, K3 {k3_ms:.2f} ms (bounds by "
        f"operations {f2 / H100_BF16_FLOPS * 1e3:.3f} / {f3 / H100_BF16_FLOPS * 1e3:.3f} ms); K1 ms a step at "
        f"T=5120: {', '.join(f'B={b} {k1_ms[b]:.4f}' for b in spec.k1_batches)}")
    log(f"{p}: K1 bound a step at T=5120 (the larger of operations and bytes, k1_bound): "
        f"{', '.join(f'B={b} {k1_bound_ms[b] * 1e3:.4f} us' for b in spec.k1_batches)}; K2/K3 bounds by bytes "
        f"{by2 / H100_BYTES_PER_S * 1e3:.3f} / {by3 / H100_BYTES_PER_S * 1e3:.3f} ms")
    rec["l16_ms"] = {"K2": k2_ms, "K3": k3_ms, "K1_per_step": k1_ms, "K1_bound_per_step": k1_bound_ms,
                     "K2_bound": f2 / H100_BF16_FLOPS * 1e3, "K3_bound": f3 / H100_BF16_FLOPS * 1e3}
    k2.setdefault("max_rel_err", {}).update(
        {f"{tag}_{case}": max(e[k] for k in FWD_OUTPUTS) for case, e in errs_l16.items()})
    k3.setdefault("max_rel_err", {})[f"{tag}_B{B}_T5120"] = max(
        v for k, v in errs_l16[f"B{B}_T5120"].items() if k not in FWD_OUTPUTS)
    rec["l16_errors"] = {"K2_K3": errs_l16, "K1": k1_errs}


KERNELS = {
    "K1": ("wavenet_decode", "decode.cu", "wavenet_autoencoders_tpu/kernels/decode.py:352"),
    "K2": ("glu_stack_forward", "glu_stack.cu", "wavenet_autoencoders_tpu/kernels/glu_stack.py:157"),
    "K3": ("glu_stack_backward", "glu_stack.cu", "wavenet_autoencoders_tpu/kernels/glu_stack.py:355"),
    # no TPU kernel: the JAX package draws through XLA's threefry (jax.random),
    # first after initialisation in its step key (train/step.py:166)
    "TF": ("threefry", "threefry.cu", "none: XLA's threefry2x32 under jax.random "
           "(wavenet_autoencoders_tpu/train/step.py:166), no pl.pallas_call"),
    # no TPU kernel: the JAX package leaves the upsampler to XLA
    "UP": ("upsample", "upsample.cu", "none: XLA's convolutions "
           "(wavenet_autoencoders_tpu/ops/upsample.py:upsample_network_apply), no pl.pallas_call"),
}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--phases", default="0,1,2,3,4,5,18,6,7,8,9,10,11,12,16,13")
    ap.add_argument("--quality-hparams", default="",
                    help='"k=v,..." appended to the quality phases\' (13-15) hparams, e.g. fused_stack=false, seed=1')
    ap.add_argument("--vq-bf16-product", action="store_true",
                    help="quality phases: round the VQ distance product's inputs to bf16 (a TPU's default dot)")
    ap.add_argument("--dp-worker", nargs=3, metavar=("INIT", "RANK", "DUMP"), help=argparse.SUPPRESS)
    ap.add_argument("--tp-worker", nargs=4, metavar=("INIT", "RANK", "DUMP", "TMP"), help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.dp_worker:
        dp_worker(args.dp_worker[0], int(args.dp_worker[1]), args.dp_worker[2])
        return 0
    if args.tp_worker:
        tp_worker(args.tp_worker[0], int(args.tp_worker[1]), args.tp_worker[2], args.tp_worker[3])
        return 0
    phases = {int(p) for p in args.phases.split(",")}

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
    from wavenet_autoencoders_tpu_torch.config import Config, load_preset
    from wavenet_autoencoders_tpu_torch.kernels import decode as K1

    cfg = load_preset("svqwae")
    plan = K1.block_plan(cfg.layers, cfg.residual_channels, cfg.gate_channels, cfg.skip_out_channels,
                         cfg.out_channels, cfg.cin_channels, torch.cuda.get_device_properties(0).multi_processor_count)
    share = plan.blk[:, 3] * 16
    log(f"phase 0: K1 bf16 (decode_tc_kernel) at svqwae width on {plan.n_blocks} blocks: dynamic shared memory "
        f"{plan.smem} bytes a block (resident weights {int(share.min())}..{int(share.max())} bytes, "
        f"{int(share.sum())} in all, + {plan.smem - int(share.max())} of partial sums); {len(plan.units)} tiles")
    build_model_s(Config.load(RUN_K / "config.json"))

    res = {k: {"name": n, "route": "cuda", "source": f"wavenet_autoencoders_tpu_torch/csrc/{src}",
               "replaces": rep, "launches": None, "max_abs_err": None, "ms": None, "plain_ms": None,
               "bound_ms": None, "bound_by": None, "library_ms": None}
           for k, (n, src, rep) in KERNELS.items()}
    k1, k2, k3 = res["K1"], res["K2"], res["K3"]
    TF_REC.clear()
    TF_REC.update(res["TF"])
    res["TF"] = TF_REC
    UP_REC.clear()
    UP_REC.update(res["UP"])
    res["UP"] = UP_REC
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
    if 18 in phases:
        phase18(UP_REC)
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
    with tempfile.TemporaryDirectory() as tmp:
        recipe_dump = None
        if 10 in phases:
            (Path(tmp) / "p10").mkdir()
            phase10(k1, k2, k3, Path(tmp) / "p10")
            recipe_dump = Path(tmp) / "p10" / "dump" / "english" / "train_no_dev"
        if 11 in phases:
            (Path(tmp) / "p11").mkdir()
            phase11(k2, k3, Path(tmp) / "p11", recipe_dump)
    if 12 in phases:
        with tempfile.TemporaryDirectory() as tmp:
            phase12(k1, k2, k3, Path(tmp), card)
    if 16 in phases:
        phase16(TF_REC)
    quality = [QUALITY_RUNS[n] for n in sorted(phases & set(QUALITY_RUNS))]
    if args.quality_hparams:
        quality = [dataclasses.replace(s, hparams=f"{s.hparams},{args.quality_hparams}") for s in quality]
    if args.vq_bf16_product:
        from wavenet_autoencoders_tpu_torch.models import bottlenecks

        bottlenecks._nearest_code = nearest_code_bf16_product
    if quality:
        with tempfile.TemporaryDirectory() as tmp:
            shared = None  # the corpus, made by the first quality run
            for spec in quality:
                shared = quality_run(spec, k1, k2, k3, Path(tmp), shared)

    print(json.dumps({"kernels": list(res.values())}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
