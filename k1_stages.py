#!/usr/bin/env python3
"""Where a step of K1's bf16 kernel goes, stage by stage, on one NVIDIA GPU.

    python3 k1_stages.py [--out stages.json]

Builds ``csrc/decode.cu`` with ``-DWAE_STAMPS`` into a library of its own
(the port keeps loading the plain build) and runs the decode through it.
In that build each block's thread 0 records ``%globaltimer``, for every
tile it runs in steps STAMP_T0 .. STAMP_T0+3: when it starts to wait for
the stage's inputs, when its waits pass, and when it has released its
arrival; the sampler blocks likewise for the sample stage. Per stage of
the chain (gate_l, out_l, post1, logits, sample) the script reports:

- handoff: the first consumer's passing of its wait minus the last
  producer's release of the stage before it (counter latency);
- work: a tile's mean time from its wait passing to its release;
- span: the stage's last release minus the previous stage's last release,
  the stage's share of the step's critical chain.

The skip tiles run beside the chain; their work is their last layer's.
Shapes: svqwae full width at B=4 and B=256, and a 20-layer width-16 net at
B=4, bf16 storage, T=128, teacher mode (seeded inputs and weights).
"""
from __future__ import annotations

import argparse
import ctypes
import json
import sys
from pathlib import Path

import numpy as np

from chip_smoke import k1_build, smi

STEPS, MAXU = 4, 48  # STAMP_STEPS and STAMP_U of csrc/decode.cu


def analyse(plan, st, B):
    """Per-stage handoff, work and span (µs) averaged over the stamped steps."""
    names = {0: "gate", 1: "out", 2: "skip", 3: "post1", 4: "logits"}
    L = plan.key[0]
    rows = []  # (step, stage key, tb, ta, td)
    for b in range(plan.n_blocks):
        u0, u1 = int(plan.blk[b, 0]), int(plan.blk[b, 1])
        for s in range(STEPS):
            for i in range(u1 - u0):
                kind, l = int(plan.units[u0 + i, 0]), int(plan.units[u0 + i, 1])
                tb, ta, td = st[b, s, i]
                rows.append((s, (names[kind], l if kind < 2 else 0), tb, ta, td))
            tb, ta, td = st[b, s, MAXU - 1]
            if b >= plan.nst and b - plan.nst < B:
                rows.append((s, ("sample", 0), tb, ta, td))
    chain = [k for l in range(L) for k in (("gate", l), ("out", l))] + [("post1", 0), ("logits", 0), ("sample", 0)]
    prev_of = {k: chain[i - 1] for i, k in enumerate(chain) if i}
    prev_of[("post1", 0)] = ("skip", 0)
    out = {}
    step_us = []
    for s in range(1, STEPS):
        by = {}
        for step, key, tb, ta, td in rows:
            by.setdefault((step, key), []).append((tb, ta, td))
        ends = {k: max(v[2] for v in by[(s, k)]) for (st_, k) in by if st_ == s}
        ends_prev_sample = max(v[2] for v in by[(s - 1, ("sample", 0))])
        step_us.append((ends[("sample", 0)] - ends_prev_sample) / 1e3)
        for k in chain + [("skip", 0)]:
            v = np.asarray(by[(s, k)], dtype=np.float64)
            p_end = ends_prev_sample if k == ("gate", 0) else ends.get(prev_of.get(k), np.nan)
            kind = k[0]
            rec = out.setdefault(kind, {"handoff_us": [], "work_us": [], "span_us": []})
            rec["work_us"].append(float(np.mean(v[:, 2] - v[:, 1])) / 1e3)
            if kind != "skip":
                rec["handoff_us"].append((float(v[:, 1].min()) - p_end) / 1e3)
                rec["span_us"].append((float(v[:, 2].max()) - p_end) / 1e3)
    res = {"step_us": float(np.mean(step_us))}
    for kind, rec in out.items():
        res[kind] = {k: (float(np.mean(x)) if x else None) for k, x in rec.items()}
        res[kind]["count_per_step"] = len(rec["work_us"]) // (STEPS - 1)
    res["chain_split_us"] = {kind: res[kind]["span_us"] * res[kind]["count_per_step"]
                             for kind in ("gate", "out", "post1", "logits", "sample")}
    return res


def run() -> dict:
    import torch

    from wavenet_autoencoders_tpu_torch.config import load_preset
    from wavenet_autoencoders_tpu_torch.kernels import decode as K
    from wavenet_autoencoders_tpu_torch.models import build_model
    from wavenet_autoencoders_tpu_torch.models.wavenet import WaveNet

    net = build_model(load_preset("svqwae"), device="cuda", seed=4).wavenet
    tiny = WaveNet(out_channels=256, layers=20, stacks=2, residual_channels=16, gate_channels=32,
                   skip_out_channels=16, cin_channels=16, dropout=0.0,
                   generator=torch.Generator().manual_seed(0)).cuda()
    lib = K._lib(("WAE_STAMPS",))
    lib.wae_stamps.argtypes = [ctypes.c_void_p, ctypes.c_size_t]
    lib.wae_stamps.restype = ctypes.c_int
    rng = np.random.default_rng(4)
    T, out = 128, {}
    for name, m, B in (("full_B4", net, 4), ("full_B256", net, 256), ("width16_B4", tiny, 4)):
        c = torch.from_numpy(rng.standard_normal((B, T, m.cin_channels)).astype(np.float32)).cuda()
        teach = torch.from_numpy(rng.integers(0, 256, (B, T)).astype(np.int32)).cuda()
        pk = K.pack_decode_weights(m)
        with torch.no_grad(), k1_build("WAE_STAMPS"):
            for _ in range(2):  # the second run is the one read
                K.wavenet_decode(m, pk, T, 0, c, None, teach, True, "bfloat16")
        torch.cuda.synchronize()
        n = 256 * STEPS * MAXU * 3
        host = np.zeros(n, np.uint64)
        err = lib.wae_stamps(host.ctypes.data, n)
        if err:
            raise RuntimeError(f"wae_stamps: {err}")
        plan = K.block_plan(m.n_layers, m.residual_channels, m.gate_channels, m.skip_out_channels,
                            m.out_channels, m.cin_channels, torch.cuda.get_device_properties(0).multi_processor_count)
        if int((plan.blk[:, 1] - plan.blk[:, 0]).max()) >= MAXU:
            raise RuntimeError("a block runs more tiles than the stamp buffer holds")
        st = host[: plan.n_blocks * STEPS * MAXU * 3].reshape(plan.n_blocks, STEPS, MAXU, 3).astype(np.int64)
        out[name] = analyse(plan, st, B)
        print(f"{name}: {json.dumps(out[name])}", flush=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", help="also write the result as JSON to this file")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("k1_stages: no CUDA device", file=sys.stderr)
        return 2
    card = smi()
    res = run()
    res["card"] = card
    if args.out:
        Path(args.out).write_text(json.dumps(res, indent=1))
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
