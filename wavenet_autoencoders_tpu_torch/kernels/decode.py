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

In bf16 storage (the main path) the kernel keeps every weight resident in
the grid's shared memory: :func:`block_plan` cuts the products into tiles of
16 output columns and gives them to blocks, and :func:`pack_block_weights`
packs each block's share once per call in the order the kernel's tensor-core
fragments read it. f32 storage streams the weights from L2.

Two TPU-only knobs of the JAX kernel have no counterpart: the batch pad to
a multiple of 8 and ``hbm_min_dilation`` (the rings always live in one
device-memory arena here).
"""
from __future__ import annotations

import ctypes
import functools
import math
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

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


# ---------------------------------------------------------------------------
# the bf16 kernel's block plan: which block holds which weight tile
# ---------------------------------------------------------------------------

#: Shared memory one block may use on sm_90 (227 KB), less the kernel's
#: static shared memory.
SMEM_LIMIT = 232448 - 1024
_RED_BYTES = 4096 * 4  # the kernel's partial sums (RED_FLOATS)
_CSTRIDE = 32  # counters 128 bytes apart (CSTRIDE)
U_GATE, U_OUT, U_SKIP, U_POST1, U_LOGITS = range(5)
_FLAT = ("wconv", "wc", "wout", "wskip", "wp1", "wp2")


def _pad32(n: int) -> int:
    return -(-n // 32) * 32


def fragment_order(nkb: int) -> tuple[np.ndarray, np.ndarray]:
    """Where the packed fragments of a (32 nkb) x 16 weight tile come from:
    element e of the packing is tile[kp[e], col[e]], in the order (k block
    kb, k step s, lane, register j, half). A lane (r, q) = (lane // 4,
    lane % 4) holds, for mma.sync m16n8k16's A operand, rows r + 8 (j % 2)
    and the logical k 2q + 8 (j // 2) + half of step s, which the packing
    places at physical k 32 kb + 8q + 4s + 2 (j // 2) + half: a lane's input
    fragments of both steps are then the 8 contiguous values at 32 kb + 8q."""
    kb, s, lane, j, lo = np.meshgrid(*(np.arange(n) for n in (nkb, 2, 32, 4, 2)), indexing="ij")
    kp = kb * 32 + 8 * (lane % 4) + 4 * s + 2 * (j // 2) + lo
    col = lane // 4 + 8 * (j % 2)
    return kp.reshape(-1), col.reshape(-1)


@dataclass(frozen=True)
class BlockPlan:
    """Where each weight tile of the bf16 kernel lives (``csrc/decode.cu``).

    ``units`` (n, 4) int32 rows (kind, layer, tile, offset of the tile's
    fragments in its block's share, in 16-byte words), each block's rows in
    chain order; ``blk`` (n_blocks, 4) int64 rows (first unit, end unit,
    share offset, share length, both in 16-byte words); ``index`` the flat
    source position (int32) of every packed element (``zero``: a zero). Blocks
    0..nst-1 each own one skip column tile in every layer; the rest hold
    the gate, out, post1 and logits tiles, and sample rows.
    """

    key: tuple
    n_blocks: int
    nst: int
    ngt: int
    nout: int
    npt: int
    nlt: int
    cp: int
    g2p: int
    sp: int
    cinp: int
    smem: int
    units: np.ndarray
    blk: np.ndarray
    index: np.ndarray
    zero: int
    shapes: tuple  # ((name, offset, shape), ...) of the flat source


def _tile_src(base, ld_k, K, Kp, cols, valid, zero):
    """(Kp, 16) flat source positions of rows k < K (ld_k apart) and the
    given columns of one weight matrix; padding reads the zero."""
    kk = np.arange(Kp)[:, None]
    idx = base + kk * ld_k + cols[None, :]
    return np.where((kk < K) & valid[None, :], idx, zero)


@functools.lru_cache(maxsize=4)
def block_plan(L: int, C: int, G: int, S: int, O: int, cin: int, n_blocks: int) -> BlockPlan:
    """Tiles of 16 output columns for every product of the bf16 kernel,
    given to ``n_blocks`` blocks (one per SM). The tiles of one stage go to
    different blocks, each to the block with the fewest bytes so far, so
    that a stage runs on as many blocks as it has tiles and the weights are
    balanced over the SMs; a gate tile goes to a block that holds none of
    the three stages before it, where there is one. Raises ValueError where the grid cannot take the
    weights (a block's share past ``SMEM_LIMIT``, or fewer blocks than a
    stage's tiles)."""
    G2 = G // 2
    cp, g2p, sp, cinp = _pad32(C), _pad32(G2), _pad32(S), _pad32(cin)
    ngt, nout, nst, npt, nlt = -(-G2 // 8), -(-C // 16), -(-S // 16), -(-S // 16), -(-O // 16)
    rest = n_blocks - nst
    if rest < max(ngt, nout, npt, nlt):
        raise ValueError(
            f"the decode kernel needs {nst} blocks for the skip tiles and {max(ngt, nout, npt, nlt)} for "
            f"the widest stage, the grid has {n_blocks}"
        )
    shapes, o = [], 0
    for name, shp in zip(_FLAT, ((L, 3, C, G), (L, cin, G), (L, G2, C), (L, G2, S), (S, S), (S, O))):
        if name == "wc" and cin == 0:
            continue
        shapes.append((name, o, shp))
        o += int(np.prod(shp))
    off = {n: b for n, b, _ in shapes}
    zero = o
    kp_of = {}

    def frag(src):
        nkb = src.shape[0] // 32
        if nkb not in kp_of:
            kp_of[nkb] = fragment_order(nkb)
        kp, col = kp_of[nkb]
        return src[kp, col]

    r16 = np.arange(16)
    units = [[] for _ in range(n_blocks)]  # per block: (kind, layer, tile, packed elements)
    load = [0] * n_blocks

    def place(kind, l, tiles, avoid=(), last=()):
        """Each tile to the least-loaded block; blocks holding a stage in
        ``avoid``, and the blocks in ``last``, come last."""
        busy = set(last) | {b for b in range(nst, n_blocks) if any((k, j) in avoid for k, j, _, _ in units[b])}
        order = sorted(range(nst, n_blocks), key=lambda b: (b in busy, load[b], b))[: len(tiles)]
        for t, (b, src) in enumerate(zip(order, tiles)):
            units[b].append((kind, l, t, src))
            load[b] += src.size * 2

    for j in range(nst):  # skip tile j, every layer
        n = 16 * j + r16
        src = np.concatenate([
            frag(_tile_src(off["wskip"] + l * G2 * S, S, G2, g2p, n, n < S, zero)) for l in range(L)])
        units[j].append((U_SKIP, 0, j, src))
        load[j] += src.size * 2
    for l in range(L):
        gates = []
        for t in range(ngt):
            p = 8 * t + r16 % 8
            n, ok = p + G2 * (r16 >= 8), p < G2
            # k segments [tap0 | tap1 | c | h], the kernel's input order
            segs = [_tile_src(off["wconv"] + j * C * G + l * 3 * C * G, G, C, cp, n, ok, zero) for j in range(2)]
            if cin:
                segs.append(_tile_src(off["wc"] + l * cin * G, G, cin, cinp, n, ok, zero))
            segs.append(_tile_src(off["wconv"] + 2 * C * G + l * 3 * C * G, G, C, cp, n, ok, zero))
            gates.append(frag(np.concatenate(segs)))
        # a gate tile's taps-and-c product runs while the three stages
        # before it on the chain do; on a block that holds one of them it
        # would wait for that tile instead (and the samplers at B <= 8,
        # the first non-skip blocks, run just before gate_0)
        place(U_GATE, l, gates, avoid={(U_OUT, l - 2), (U_GATE, l - 1), (U_OUT, l - 1)},
              last=range(nst, nst + 8) if l == 0 else ())
        place(U_OUT, l, [frag(_tile_src(off["wout"] + l * G2 * C, C, G2, g2p, 16 * t + r16, 16 * t + r16 < C, zero))
                         for t in range(nout)])
    place(U_POST1, 0, [frag(_tile_src(off["wp1"], S, S, sp, 16 * t + r16, 16 * t + r16 < S, zero))
                       for t in range(npt)])
    place(U_LOGITS, 0, [frag(_tile_src(off["wp2"], O, S, sp, 16 * t + r16, 16 * t + r16 < O, zero))
                        for t in range(nlt)])

    rows, blk, index, w = [], [], [], 0
    for b in range(n_blocks):
        u0, w0 = len(rows), w
        for kind, l, t, src in units[b]:
            rows.append((kind, l, t, (w - w0) // 8))
            index.append(src)
            w += src.size
        blk.append((u0, len(rows), w0 // 8, (w - w0) // 8))
    smem = _RED_BYTES + max(load)
    if smem > SMEM_LIMIT:
        raise ValueError(
            f"the decode kernel's resident weights need {max(load)} bytes of shared memory in one block "
            f"({sum(load)} bytes over {n_blocks} blocks) plus {_RED_BYTES} of partial sums, "
            f"above the {SMEM_LIMIT} bytes a block can have"
        )
    return BlockPlan(
        key=(L, C, G, S, O, cin, n_blocks), n_blocks=n_blocks, nst=nst, ngt=ngt, nout=nout, npt=npt, nlt=nlt,
        cp=cp, g2p=g2p, sp=sp, cinp=cinp, smem=smem,
        units=np.asarray(rows, np.int32).reshape(-1, 4), blk=np.asarray(blk, np.int64),
        index=np.concatenate(index).astype(np.int32), zero=zero, shapes=tuple(shapes),
    )


@functools.lru_cache(maxsize=2)
def _plan_tensors(key: tuple, dev: str) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(index, units, blk) of ``block_plan(*key)`` on device ``dev``."""
    plan = block_plan(*key)
    return tuple(torch.from_numpy(x).to(dev) for x in (plan.index, plan.units, plan.blk))


def pack_block_weights(packed: dict, plan: BlockPlan) -> torch.Tensor:
    """Every block's share of the weights in bf16, in block order and,
    within a block, in the order the kernel reads its fragments: one flat
    tensor. Raises ValueError where a weight's shape is not the plan's."""
    dev = packed["wconv"].device
    for n, _, shp in plan.shapes:
        if tuple(packed[n].shape) != shp:
            raise ValueError(f"{n} has shape {tuple(packed[n].shape)}, the block plan expects {shp}")
    src = torch.cat([packed[n].reshape(-1).to(torch.bfloat16) for n, _, _ in plan.shapes]
                    + [torch.zeros(1, dtype=torch.bfloat16, device=dev)])
    return torch.index_select(src, 0, _plan_tensors(plan.key, str(dev))[0])


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
    kernel's Philox draws; teacher-mode logits are comparable). The kernel's
    in-kernel stream stands in for the TPU's hardware generator
    (``pltpu.prng_random_bits`` in the JAX kernel), which no JAX key
    reproduces, so this sampler stays torch's own: only the seed is JAX's
    (``eval.synthesize.kernel_seed``)."""
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
        + [(n, ctypes.c_int64) for n in (
            "NB", "NST", "NGT", "NOT", "NPT", "NLT", "CP", "G2P", "SP", "CINP", "smem",
        )]
        + [(n, ctypes.c_void_p) for n in ("wbuf", "units", "blk", "hb", "ys", "cnt")]
    )


def _lib(defines: tuple[str, ...] = ()):
    """The kernel's library; ``defines`` picks a check or timing build of
    ``csrc/decode.cu`` (``WAE_JITTER``, ``WAE_STAMPS``)."""
    from wavenet_autoencoders_tpu_torch.kernels import build

    lib = build.load("decode", defines)
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

    tc = store == torch.bfloat16
    # the bf16 kernel reads w1 and the biases here and every other weight
    # from its packed share; the f32 kernel reads them all here
    shapes = {"w1": (net.in_channels, C), "b1": (C,), "bconv": (L, G), "bout": (L, C), "bskip": (L, S),
              "bp1": (S,), "bp2": (O,)}
    if not tc:
        shapes.update({"wconv": (L, 3, C, G), "wout": (L, G // 2, C), "wskip": (L, G // 2, S), "wp1": (S, S),
                       "wp2": (S, O)})
        if has_c:
            shapes["wc"] = (L, cin, G)
    w = {k: packed[k].to(store).contiguous() for k in shapes if k in _WEIGHTS}
    if scalar:
        w["w1"] = packed["w1"].float().contiguous()
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
    codes = torch.empty(B, T, dtype=torch.float32 if scalar else torch.int32, device=dev)
    logits = torch.empty(B, T, O, dtype=torch.float32, device=dev)
    h = torch.empty(B, C, dtype=torch.float32, device=dev)
    skip = torch.empty(B, S, dtype=torch.float32, device=dev)
    if tc:  # resident weights; rows padded to 32 columns, zeros in the pad
        n_sms = torch.cuda.get_device_properties(dev).multi_processor_count
        plan = block_plan(L, C, G, S, O, cin, n_sms)
        wbuf = pack_block_weights(packed, plan)
        _, units, blk = _plan_tensors(plan.key, str(dev))
        if plan.cinp != cin:
            c_up = F.pad(c_up, (0, plan.cinp - cin)).contiguous()
        ring = torch.zeros(offs[-1], B, plan.cp, dtype=store, device=dev)
        hb = torch.zeros(B, plan.cp, dtype=store, device=dev)
        act = torch.zeros(L, B, plan.g2p, dtype=store, device=dev)  # one per layer
        ys = torch.zeros(B, plan.sp, dtype=store, device=dev)
        y1 = torch.zeros(B, plan.sp, dtype=store, device=dev)
        cnt = torch.zeros((2 * L + 4) * _CSTRIDE, dtype=torch.int32, device=dev)
        bar = None
    else:
        ring = torch.zeros(offs[-1], B, C, dtype=store, device=dev)
        act = torch.empty(B, G // 2, dtype=store, device=dev)
        y1 = torch.empty(B, S, dtype=store, device=dev)
        bar = torch.zeros(2, dtype=torch.int32, device=dev)

    a = _DecodeArgs(
        B=B, T=T, L=L, C=C, G=G, S=S, O=O, CIN=cin,
        store_bf16=int(tc), scalar=int(scalar), teacher=int(teacher),
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
    if tc:
        a.NB, a.NST, a.NGT, a.NOT, a.NPT, a.NLT = (plan.n_blocks, plan.nst, plan.ngt, plan.nout, plan.npt,
                                                   plan.nlt)
        a.CP, a.G2P, a.SP, a.CINP, a.smem = plan.cp, plan.g2p, plan.sp, plan.cinp, plan.smem
        a.wbuf, a.units, a.blk, a.hb, a.ys, a.cnt = map(ptr, (wbuf, units, blk, hb, ys, cnt))
    lib = _lib()
    with torch.cuda.device(dev):
        a.stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.wae_decode(ctypes.byref(a))
    if err != 0:
        raise RuntimeError(f"decode kernel launch failed: {lib.wae_error_string(err).decode()}")
    LAUNCHES += 1
    return codes, logits
