"""Operations and bytes of the port's work, computed from a configuration's
shapes and never from what the kernels ran, so a kernel's roofline share
reads the same work whatever implements it; and the H100's published
peaks (NVIDIA's data sheet, SXM part, dense bf16).

``glu_bound`` is a frozen copy of ``chip_smoke.py:glu_bound``, and
``k1_bound`` of ``chip_smoke.py:k1_bound`` with the model's widths as
arguments where the original reads them off a built model. They live
here so that later edits of ``chip_smoke.py`` leave the yardstick alone.
"""
from __future__ import annotations

import math

H100_BF16_FLOPS = 989e12   # dense bf16 tensor-core peak, H100 SXM data sheet
H100_BYTES_PER_S = 3.35e12  # HBM3 bandwidth, H100 SXM data sheet


def widths(cfg: dict) -> dict:
    """The WaveNet's widths from a configuration's keys (the JSON of
    ``benchmarks/configs``): C, G, S, O, L, cin, gin and the input width."""
    mulaw = cfg["input_type"] == "mulaw-quantize"
    return {"C": cfg["residual_channels"], "G": cfg["gate_channels"], "S": cfg["skip_out_channels"],
            "O": cfg["out_channels"], "L": cfg["layers"], "cin": max(cfg["cin_channels"], 0),
            "gin": max(cfg["gin_channels"], 0), "in_channels": cfg["out_channels"] if mulaw else 1}


def bound_ms(flop: float, nbytes: float) -> float:
    """The least time the chip could take: operations at the bf16 peak or
    bytes at the HBM rate, whichever is longer."""
    return max(flop / H100_BF16_FLOPS, nbytes / H100_BYTES_PER_S) * 1e3


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


def k1_mac_row_step(C, G, S, O, L, cin) -> int:
    """Multiply-adds of one network step of one row: every layer's 3-tap
    conv, conditioning projection, out and skip products, and the post-net."""
    return L * (3 * C * G + cin * G + (G // 2) * (C + S)) + S * S + S * O


def k1_bound(B, T, *, C, G, S, O, L, cin, in_channels, has_g, **_):
    """(FLOP, ms bound by operations, ms bound by bytes) of one bf16 K1 call
    of T steps at batch B: the products of every step at the bf16 peak; the
    bf16 weights and c_up and the f32 g_add read once, the f32 logits and
    samples written once, over the HBM rate."""
    flop = 2.0 * k1_mac_row_step(C, G, S, O, L, cin) * B * T
    G2 = G // 2
    n_weights = (in_channels * C + C + L * 3 * C * G + L * G + L * cin * G + L * G2 * C + L * C
                 + L * G2 * S + L * S + S * S + S + S * O + O)
    in_bytes = n_weights * 2 + B * T * cin * 2 + (L * B * G * 4 if has_g else 0)
    out_bytes = B * T * O * 4 + B * T * 4
    return flop, flop / H100_BF16_FLOPS * 1e3, (in_bytes + out_bytes) / H100_BYTES_PER_S * 1e3


def encoder_specs(frame_rate: int) -> list[tuple[int, int]]:
    """(kernel, stride) of the content encoder's blocks."""
    n_ds = {1: 0, 2: 1, 4: 2}[100 // frame_rate]
    return [(3, 1), (3, 1)] + [(5, 2)] * n_ds + [(5, 1)] * (2 - n_ds) + [(3, 1), (3, 1)] + [(1, 1)] * 4


def encoder_flop(cfg: dict, B: int, frames: int) -> float:
    """The content encoder over B utterances of ``frames`` feature frames:
    every block's conv and the projection to the latent."""
    macs, t, cin, hid = 0, frames, cfg["dim_in"], cfg["encoder_hid"]
    for k, s in encoder_specs(cfg["frame_rate"]):
        t = (t + 2 * (k // 2) - k) // s + 1
        macs += t * k * cin * hid
        cin = hid
    macs += t * hid * cfg["cin_channels"]
    return 2.0 * B * macs


def upsampler_flop(cfg: dict, B: int, frames: int) -> float:
    """The context conv (kernel 2·cin_pad + 1, no padding: ``frames`` in,
    ``frames`` − 2·cin_pad out) and each scale's smoothing conv over every
    channel."""
    c, pad = cfg["cin_channels"], cfg["cin_pad"]
    t = frames - 2 * pad
    macs = t * c * c * (2 * pad + 1)
    for s in cfg["upsample_params"]["upsample_scales"]:
        t *= s
        macs += t * c * (2 * s + 1)
    return 2.0 * B * macs


#: the families of ``models/zoo.py:build_model`` by ``name`` that have a
#: content encoder (``wavenet_vocoder`` is conditioned on the features)
ENCODER_FAMILIES = ("wvae", "ae", "vqvae", "inae", "inae1", "new_inae", "catae")


def forward_flop(cfg: dict, B: int, T: int) -> float:
    """One teacher-forced forward of the whole model at B × T samples. A
    family with an encoder: the encoder, the bottleneck's distances (VQ),
    the upsampler over the latent frames, the WaveNet stack (the frozen K2
    count) and the post-net. The vocoder: the upsampler over the feature
    frames of the crop and their 2·cin_pad frames of context, the stack and
    the post-net. The first layer is a row gather of its weight (mu-law
    codes) or a scaling of it (a scalar input) and counts nothing;
    elementwise work, the loss included, counts nothing."""
    name = cfg["name"].lower()
    w = widths(cfg)
    hop = cfg["hop_size"]
    frames = T // hop
    f2, _, _, _ = glu_bound(B, T, w["C"], w["G"], w["S"], w["cin"], w["L"], w["gin"] > 0)
    post = 2.0 * B * T * (w["S"] * w["S"] + w["S"] * w["O"])
    if name == "wavenet_vocoder":
        return upsampler_flop(cfg, B, frames + 2 * cfg["cin_pad"]) + f2 + post
    if name not in ENCODER_FAMILIES:
        raise ValueError(f"no count for model {cfg['name']!r}")
    latent = frames // (100 // cfg["frame_rate"])
    vq = 0.0
    if name == "vqvae":
        vq = 2.0 * B * latent * cfg["K"] * cfg["cin_channels"]
    return encoder_flop(cfg, B, frames) + vq + upsampler_flop(cfg, B, latent) + f2 + post


def train_step_flop(cfg: dict, B: int, T: int) -> float:
    """A train step's FLOPs: the forward's, times 3 for forward and backward.
    Recomputation (K3's rebuild of the gate and out products) and the
    elementwise Adam and EMA updates are left out."""
    return 3.0 * forward_flop(cfg, B, T)


def decode_flop(cfg: dict, samples: int) -> float:
    """The network FLOPs of ``samples`` decoded audio samples (one network
    step each, every row counted)."""
    w = widths(cfg)
    return 2.0 * k1_mac_row_step(w["C"], w["G"], w["S"], w["O"], w["L"], w["cin"]) * samples


def share(bound: float, measured: float) -> float | None:
    """bound / measured in percent, or None where nothing was measured."""
    if not measured or not math.isfinite(measured) or measured <= 0:
        return None
    return 100.0 * bound / measured
