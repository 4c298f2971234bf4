"""Fused WaveNet AR decode: the CUDA kernel ``csrc/decode.cu`` and its plain
PyTorch version.

Counterpart of ``wavenet_autoencoders_tpu/kernels/decode.py``. The whole
sampling loop over T steps runs in one kernel launch; per step: the first
1x1 as a row gather of W1 (mu-law) or scalar × W1 (scalar input), for each
layer the 3-tap dilated conv read from a 2d-slot ring (tap0 = x(t-2d) at
slot t mod 2d, tap1 = x(t-d) at slot (t+d) mod 2d, h_in written to slot
t mod 2d after the reads) plus c_up[t] @ wc + g_add + bias, the
tanh·sigmoid gate, the skip sum and the residual ·√½; then the output head
and in-kernel sampling (Gumbel-argmax over the mu-law logits, or the MoL /
MoG draw for scalar input). Teacher mode feeds ``teach[:, t]`` instead of
the sample.

``wavenet_decode`` dispatches on the device of the packed weights: CPU
tensors go to ``wavenet_decode_reference``, CUDA tensors to the kernel. A
CUDA tensor the kernel refuses raises; there is no fallback.

Two TPU-only knobs of the JAX kernel have no counterpart: the batch pad to
a multiple of 8 and ``hbm_min_dilation`` (the rings always live in one
device-memory arena here).
"""
from __future__ import annotations

import ctypes
import math

import torch

from wavenet_autoencoders_tpu_torch.ops.conv import conv1d_weight

#: Number of times the CUDA kernel was launched (the plain version does not
#: count). Set it to 0 before a run whose launches you want to count.
LAUNCHES = 0

_MAXL = 64
_WEIGHTS = ("w1", "wconv", "wc", "wout", "wskip", "wp1", "wp2")


def pack_decode_weights(net) -> dict:
    """Stack the WaveNet's folded weights into per-layer f32 tensors:

    w1 (in_channels, C), b1 (C); wconv (L, 3, C, G), bconv (L, G);
    wc (L, cin, G) when the model has local conditioning; wout (L, G/2, C),
    bout (L, C); wskip (L, G/2, S), bskip (L, S); wp1 (S, S), bp1 (S);
    wp2 (S, O), bp2 (O). The storage dtype is applied by the decode call.
    """
    with torch.no_grad():
        lays = net.layers
        packed = {
            "w1": conv1d_weight(net.first)[0],
            "b1": net.first.b,
            "wconv": torch.stack([conv1d_weight(lp.conv) for lp in lays]),
            "bconv": torch.stack([lp.conv.b for lp in lays]),
            "wout": torch.stack([conv1d_weight(lp.out)[0] for lp in lays]),
            "bout": torch.stack([lp.out.b for lp in lays]),
            "wskip": torch.stack([conv1d_weight(lp.skip)[0] for lp in lays]),
            "bskip": torch.stack([lp.skip.b for lp in lays]),
            "wp1": conv1d_weight(net.post1)[0],
            "bp1": net.post1.b,
            "wp2": conv1d_weight(net.post2)[0],
            "bp2": net.post2.b,
        }
        if lays[0].cproj is not None:
            packed["wc"] = torch.stack([conv1d_weight(lp.cproj)[0] for lp in lays])
        return {k: v.detach().float().contiguous() for k, v in packed.items()}


def precompute_g_add(net, g) -> torch.Tensor | None:
    """(L, B, G) f32: per-layer global-conditioning addends, constant over
    time, so computed once outside the kernel."""
    if g is None or net.gin_channels <= 0:
        return None
    with torch.no_grad():
        g_feat = net._global_features(g).float()
        return torch.stack([g_feat @ conv1d_weight(lp.gproj)[0] for lp in net.layers]).contiguous()


def _store_dtype(dtype_str: str) -> torch.dtype:
    if dtype_str not in ("float32", "bfloat16"):
        raise ValueError(f"dtype_str must be 'float32' or 'bfloat16', got {dtype_str!r}")
    return torch.bfloat16 if dtype_str == "bfloat16" else torch.float32


def _batch(c_up, teach) -> int:
    if c_up is not None:
        return c_up.shape[0]
    if teach is not None:
        return teach.shape[0]
    return 1


def _ring_offsets(net) -> list[int]:
    offs, o = [], 0
    for l in range(net.n_layers):
        offs.append(o)
        o += 2 * net.dilation(l)
    return offs + [o]


def wavenet_decode(
    net,
    packed: dict,
    T: int,
    seed: int,
    c_up: torch.Tensor | None = None,
    g_add: torch.Tensor | None = None,
    teach: torch.Tensor | None = None,
    teacher: bool = False,
    dtype_str: str = "float32",
):
    """Run the fused decode. Args:

    packed: from :func:`pack_decode_weights`.
    c_up: (B, T, cin) upsampled conditioning (or None).
    g_add: (L, B, G) per-layer global-conditioning addends (or None).
    teach: (B, T) int codes (or f32 samples) forced as inputs when teacher.
    dtype_str: storage of weights, rings, c_up and activations ('float32'
        or 'bfloat16'); accumulation is f32.
    Returns (codes (B, T) int32, logits (B, T, O) f32) on the mu-law path,
    or (samples (B, T) f32 in [-1, 1], mixture params (B, T, O)) on the
    scalar-input path.
    """
    dev = packed["wconv"].device
    if dev.type == "cpu":
        return wavenet_decode_reference(net, packed, T, seed, c_up, g_add, teach, teacher, dtype_str)
    if dev.type == "cuda":
        return _decode_cuda(net, packed, T, seed, c_up, g_add, teach, teacher, dtype_str)
    raise RuntimeError(f"no decode for device {dev}")


@torch.no_grad()
def wavenet_decode_reference(
    net,
    packed: dict,
    T: int,
    seed: int,
    c_up: torch.Tensor | None = None,
    g_add: torch.Tensor | None = None,
    teach: torch.Tensor | None = None,
    teacher: bool = False,
    dtype_str: str = "float32",
):
    """The plain PyTorch version of the kernel: the same step loop, ring
    arena, storage roundings and sampling rule, with the noise drawn from a
    ``torch.Generator`` seeded with ``seed`` (so its samples are not the
    kernel's Philox draws; teacher-mode logits are comparable)."""
    store = _store_dtype(dtype_str)
    dev = packed["wconv"].device
    scalar = net.scalar_input
    L, B = net.n_layers, _batch(c_up, teach)
    C, O = net.residual_channels, net.out_channels
    G2 = net.gate_channels // 2

    def q(x):  # round to storage precision, compute in f32
        return x.to(store).float()

    w = {k: q(v) for k, v in packed.items() if k in _WEIGHTS}
    if scalar:
        w["w1"] = packed["w1"].float()  # keeps the AR signal in f32
    cq = None if c_up is None else q(c_up)
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    offs = _ring_offsets(net)
    ring = torch.zeros(offs[-1], B, C, dtype=store, device=dev)
    codes = torch.empty(B, T, dtype=torch.float32 if scalar else torch.int32, device=dev)
    logits = torch.empty(B, T, O, dtype=torch.float32, device=dev)

    def uniform(shape, lo):
        return torch.rand(shape, generator=gen, device=dev) * (1.0 - 2.0 * lo) + lo

    x = torch.full((B,), 0.0 if scalar else 127.0, device=dev)
    for t in range(T):
        if teacher:
            x = teach[:, t].float()
        if scalar:
            h = x[:, None] * w["w1"][0] + packed["b1"]
        else:  # row gather; the start code 127 is all-zero one-hot when O <= 127
            valid = (x < O)[:, None]
            h = w["w1"][x.long().clamp(max=O - 1)] * valid + packed["b1"]
        skip = 0.0
        for l in range(L):
            d = net.dilation(l)
            s0 = offs[l] + t % (2 * d)
            s1 = offs[l] + (t + d) % (2 * d)
            ab = (
                ring[s0].float() @ w["wconv"][l, 0]
                + ring[s1].float() @ w["wconv"][l, 1]
                + q(h) @ w["wconv"][l, 2]
                + packed["bconv"][l]
            )
            if cq is not None:
                ab = ab + cq[:, t] @ w["wc"][l]
            if g_add is not None:
                ab = ab + g_add[l]
            act = q(torch.tanh(ab[:, :G2]) * torch.sigmoid(ab[:, G2:]))
            skip = skip + act @ w["wskip"][l] + packed["bskip"][l]
            out = act @ w["wout"][l] + packed["bout"][l]
            ring[s0] = h.to(store)
            h = (out + h) * math.sqrt(0.5)
        y = q(torch.relu(skip * math.sqrt(1.0 / L)))
        y = q(torch.relu(y @ w["wp1"] + packed["bp1"]))
        lg = y @ w["wp2"] + packed["bp2"]
        logits[:, t] = lg
        if scalar:
            M = O // 3
            pick = (lg[:, :M] - torch.log(-torch.log(uniform((B, M), 1e-5)))).argmax(-1)
            means = lg[:, M : 2 * M].gather(1, pick[:, None])[:, 0]
            log_s = lg[:, 2 * M :].gather(1, pick[:, None])[:, 0]
            if net.output_distribution == "Logistic":
                u = uniform((B,), 1e-5)
                noise = torch.log(u) - torch.log(1.0 - u)
            else:  # Box-Muller
                u = uniform((B, 2), 1e-7)
                noise = torch.sqrt(-2.0 * torch.log(u[:, 0])) * torch.cos(2.0 * math.pi * u[:, 1])
            x = (means + torch.exp(log_s) * noise).clamp(-1.0, 1.0)
            codes[:, t] = x
        else:
            gumbel = -torch.log(-torch.log(uniform((B, O), 1e-7)))
            idx = (torch.log_softmax(lg, dim=-1) + gumbel).argmax(-1)
            codes[:, t] = idx.to(torch.int32)
            x = idx.float()
    return codes, logits


class _DecodeArgs(ctypes.Structure):
    """Field for field the ``DecodeArgs`` struct of ``csrc/decode.cu``."""

    _fields_ = (
        [(n, ctypes.c_int64) for n in (
            "B", "T", "L", "C", "G", "S", "O", "CIN",
            "store_bf16", "scalar", "teacher", "normal", "has_c", "has_g", "seed",
        )]
        + [("dil", ctypes.c_int64 * _MAXL), ("ring_off", ctypes.c_int64 * _MAXL)]
        + [(n, ctypes.c_void_p) for n in (
            "w1", "b1", "wconv", "bconv", "wc", "wout", "bout", "wskip", "bskip",
            "wp1", "bp1", "wp2", "bp2", "c_up", "g_add", "teach",
            "ring", "h", "act", "skip", "y1", "bar", "codes", "logits", "stream",
        )]
    )


def _lib():
    from wavenet_autoencoders_tpu_torch.kernels import build

    lib = build.load("decode")
    lib.wae_decode.argtypes = [ctypes.POINTER(_DecodeArgs)]
    lib.wae_decode.restype = ctypes.c_int
    lib.wae_error_string.argtypes = [ctypes.c_int]
    lib.wae_error_string.restype = ctypes.c_char_p
    return lib


def _check(name, x, shape, dtype, dev):
    if x.device != dev:
        raise ValueError(f"{name} is on {x.device}, expected {dev}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(x.shape)}, expected {tuple(shape)}")
    if x.dtype != dtype:
        raise ValueError(f"{name} has dtype {x.dtype}, expected {dtype}")
    if not x.is_contiguous():
        raise ValueError(f"{name} is not contiguous")


def _decode_cuda(net, packed, T, seed, c_up, g_add, teach, teacher, dtype_str):
    global LAUNCHES
    store = _store_dtype(dtype_str)
    dev = packed["wconv"].device
    scalar = net.scalar_input
    L, B = net.n_layers, _batch(c_up, teach)
    C, G, S, O = net.residual_channels, net.gate_channels, net.skip_out_channels, net.out_channels
    if net.kernel_size != 3:
        raise ValueError("the decode kernel is specialized for kernel_size=3")
    if L > _MAXL:
        raise ValueError(f"the decode kernel takes at most {_MAXL} layers, got {L}")
    if teacher and teach is None:
        raise ValueError("teacher mode needs teach")
    cin = c_up.shape[-1] if c_up is not None else 0
    has_c = c_up is not None
    if has_c != ("wc" in packed):
        raise ValueError("c_up and the packed wc must come together")

    w = {k: v.to(store).contiguous() for k, v in packed.items() if k in _WEIGHTS}
    if scalar:
        w["w1"] = packed["w1"].float().contiguous()
    shapes = {
        "w1": (net.in_channels, C), "b1": (C,), "wconv": (L, 3, C, G), "bconv": (L, G),
        "wout": (L, G // 2, C), "bout": (L, C), "wskip": (L, G // 2, S), "bskip": (L, S),
        "wp1": (S, S), "bp1": (S,), "wp2": (S, O), "bp2": (O,),
    }
    if has_c:
        shapes["wc"] = (L, cin, G)
    args_t = {}
    for k, shp in shapes.items():
        x = w.get(k, packed[k])
        _check(k, x, shp, w[k].dtype if k in w else torch.float32, dev)
        args_t[k] = x
    if has_c:
        c_up = c_up.to(store).contiguous()
        _check("c_up", c_up, (B, T, cin), store, dev)
    if g_add is not None:
        g_add = g_add.float().contiguous()
        _check("g_add", g_add, (L, B, G), torch.float32, dev)
    if teacher:
        teach = teach.to(torch.float32 if scalar else torch.int32).contiguous()
        _check("teach", teach, (B, T), teach.dtype, dev)

    offs = _ring_offsets(net)
    ring = torch.zeros(offs[-1], B, C, dtype=store, device=dev)
    h = torch.empty(B, C, dtype=torch.float32, device=dev)
    act = torch.empty(B, G // 2, dtype=store, device=dev)
    skip = torch.empty(B, S, dtype=torch.float32, device=dev)
    y1 = torch.empty(B, S, dtype=store, device=dev)
    bar = torch.zeros(2, dtype=torch.int32, device=dev)
    codes = torch.empty(B, T, dtype=torch.float32 if scalar else torch.int32, device=dev)
    logits = torch.empty(B, T, O, dtype=torch.float32, device=dev)

    a = _DecodeArgs(
        B=B, T=T, L=L, C=C, G=G, S=S, O=O, CIN=cin,
        store_bf16=int(store == torch.bfloat16), scalar=int(scalar), teacher=int(teacher),
        normal=int(net.output_distribution == "Normal"), has_c=int(has_c),
        has_g=int(g_add is not None), seed=int(seed),
    )
    for l in range(L):
        a.dil[l] = net.dilation(l)
        a.ring_off[l] = offs[l]

    def ptr(x):
        return None if x is None else x.data_ptr()

    for k, x in args_t.items():
        setattr(a, k, ptr(x))
    a.c_up, a.g_add, a.teach = ptr(c_up), ptr(g_add), ptr(teach if teacher else None)
    a.ring, a.h, a.act, a.skip, a.y1, a.bar = map(ptr, (ring, h, act, skip, y1, bar))
    a.codes, a.logits = ptr(codes), ptr(logits)
    lib = _lib()
    with torch.cuda.device(dev):
        a.stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.wae_decode(ctypes.byref(a))
    if err != 0:
        raise RuntimeError(f"decode kernel launch failed: {lib.wae_error_string(err).decode()}")
    LAUNCHES += 1
    return codes, logits
