"""Fused residual-GLU stack for training: the CUDA kernels of
``csrc/glu_stack.cu`` (K2 forward, K3 backward), their plain PyTorch
versions, and ``FusedGLUStack``, the ``torch.autograd.Function`` that joins
them.

Counterpart of ``wavenet_autoencoders_tpu/kernels/glu_stack.py`` (the
``fused_glu_stack`` custom VJP over ``_fwd_pallas`` and ``_bwd_pallas``).
The forward runs all L layers and returns the UNSCALED skip sum (the caller
applies sqrt(1/L)); it also keeps every layer's pre-activations ``ab`` in
the storage dtype. The backward is exact without an activation stash: the
residual update h' = (out(act) + h)·√½ is inverted layer by layer,
h = h'·√2 − out(act), with act derived from the STORED ab in both passes.

Rounding points (storage dtype S = the dtype of x, f32 or bf16;
accumulation f32): inputs of every product are rounded to S; ab is stored
in S; act = S(tanh(ab_s[:G/2])·sigmoid(ab_s[G/2:])); h and the skip sum
stay f32. One deliberate difference from the JAX kernel: the final residual
``hfin`` handed to the backward is kept in f32, where the JAX kernel stores
it in S. The inversion multiplies any error of h by √2 per layer (2^10 over
20 layers), so a bf16 ``hfin`` turns the first layers' conv-weight
gradients into noise.

Dispatch is on the device of ``x``: CPU tensors go to the plain versions,
CUDA tensors to the kernels, anything the kernels refuse raises. There is
no fallback.

The kernels read every product's operands as plain row-major matrices in
S: the wrapper packs the weights once per call (:func:`pack_weights`, the
gate columns permuted by :func:`gate_perm`) and allocates the bf16 (or
f32) operand buffers that the passes' epilogues write and reuse across
layers (hb, act; in the backward also dabs and gy), ~0.4 GB at B=40 x
T=5120 in bf16.
"""
from __future__ import annotations

import ctypes
import math

import torch
import torch.nn.functional as F

#: Calls of the CUDA forward (K2) and backward (K3) entry points; the plain
#: versions do not count. Set them to 0 before a run whose launches you want
#: to count.
LAUNCHES_FWD = 0
LAUNCHES_BWD = 0

RS = math.sqrt(0.5)
IRS = math.sqrt(2.0)
_MAXL = 64


def _rounder(store: torch.dtype):
    def q(t):
        return t.to(store).float()

    return q


def glu_stack_forward_reference(x, c, g_add, wconv, bconv, wc, wout, bout, wskip, bskip, dilations):
    """The plain PyTorch version of K2, same rounding points.

    x (B, T, C) in the storage dtype S; c (B, T, cin) or None; g_add
    (B, L, G) or None; stacked folded weights wconv (L, 3, C, G), bconv
    (L, G), wc (L, cin, G), wout (L, G/2, C), bout (L, C), wskip (L, G/2,
    Sk), bskip (L, Sk). Returns (skips (B, T, Sk) in S, hfin (B, T, C) f32,
    ab (B, L, T, G) in S). Differentiable (autograd) in f32.
    """
    S = x.dtype
    q = _rounder(S)
    B, T, _ = x.shape
    L, _, _, G = wconv.shape
    G2 = G // 2
    h = x.float()
    cq = None if c is None else q(c)
    skip = 0.0
    ab_all = torch.empty(B, L, T, G, dtype=S, device=x.device)
    for l, d in enumerate(dilations):
        hq = q(h)
        hp = F.pad(hq, (0, 0, 2 * d, 0))
        ab = (hp[:, :T] @ q(wconv[l, 0]) + hp[:, d : d + T] @ q(wconv[l, 1])
              + hq @ q(wconv[l, 2]) + bconv[l].float())
        if cq is not None:
            ab = ab + cq @ q(wc[l])
        if g_add is not None:
            ab = ab + g_add[:, l, None, :].float()
        ab_s = ab.to(S)
        ab_all[:, l] = ab_s.detach()
        abf = ab_s.float()
        act = q(torch.tanh(abf[..., :G2]) * torch.sigmoid(abf[..., G2:]))
        skip = skip + (act @ q(wskip[l]) + bskip[l].float())
        h = (act @ q(wout[l]) + bout[l].float() + h) * RS
    return skip.to(S), h, ab_all


def glu_stack_backward_reference(dskips, hfin, c, ab, wconv, wc, wout, bout, wskip, dilations, has_g):
    """The plain PyTorch version of K3: the explicit backward with the same
    reconstruction (not autograd), same rounding points.

    Returns (dx (B, T, C) in S, dc (B, T, cin) f32 or None, dgadd (B, L, G)
    f32 or None, dwconv, dbconv, dwc or None, dwout, dbout, dwskip, dbskip),
    the weight and bias gradients in f32.
    """
    S = ab.dtype
    q = _rounder(S)
    B, T, Sk = dskips.shape
    L, _, C, G = wconv.shape
    G2 = G // 2
    dev = hfin.device
    f32 = dict(dtype=torch.float32, device=dev)
    h = hfin.float().clone()
    dx = torch.zeros(B, T, C, **f32)
    dskip = q(dskips)
    cq = None if c is None else q(c)
    dwconv = torch.zeros(L, 3, C, G, **f32)
    dbconv = torch.zeros(L, G, **f32)
    dwout = torch.zeros(L, G2, C, **f32)
    dbout = torch.zeros(L, C, **f32)
    dwskip = torch.zeros(L, G2, Sk, **f32)
    dbskip = torch.zeros(L, Sk, **f32)
    dwc = None if c is None else torch.zeros(L, c.shape[-1], G, **f32)
    dgadd = torch.zeros(B, L, G, **f32) if has_g else None
    dc = None
    for l in reversed(range(L)):
        d = dilations[l]
        abf = ab[:, l].float()
        ta = torch.tanh(abf[..., :G2])
        sb = torch.sigmoid(abf[..., G2:])
        act = q(ta * sb)
        h = h * IRS - (act @ q(wout[l]) + bout[l].float())
        dres = dx * RS
        dres_s = q(dres)
        dact = dres_s @ q(wout[l]).T + dskip @ q(wskip[l]).T
        dab = torch.cat([dact * (sb * (1.0 - ta * ta)), dact * (ta * sb * (1.0 - sb))], dim=-1)
        dab_s = q(dab)
        dwout[l] = torch.einsum("btg,btc->gc", act, dres_s)
        dbout[l] = dres.sum((0, 1))
        dwskip[l] = torch.einsum("btg,bts->gs", act, dskip)
        dbskip[l] = dskip.sum((0, 1))
        dab_t = dab.sum(1)
        dbconv[l] = dab_t.sum(0)
        if has_g:
            dgadd[:, l] = dab_t
        hp = F.pad(q(h), (0, 0, 2 * d, 0))
        for j in range(3):
            dwconv[l, j] = torch.einsum("btc,btg->cg", hp[:, j * d : j * d + T], dab_s)
        if cq is not None:
            dwc[l] = torch.einsum("btj,btg->jg", cq, dab_s)
            dct = dab_s @ q(wc[l]).T
            dc = dct if dc is None else dc + dct
        # dx[t] = dres[t] + sum_j S(dab[t + (2-j)d]) @ wconv[l, j]^T, zero past T
        dabp = F.pad(dab_s, (0, 0, 0, 2 * d))
        dx = dres
        for j in range(3):
            sh = (2 - j) * d
            dx = dx + dabp[:, sh : sh + T] @ q(wconv[l, j]).T
    return dx.to(S), dc, dgadd, dwconv, dbconv, dwc, dwout, dbout, dwskip, dbskip


# ---------------------------------------------------------------------------
# the CUDA kernels
# ---------------------------------------------------------------------------


def gate_perm(G: int) -> torch.Tensor:
    """Column order of the packed gate weights: packed column 2i holds gate
    column i (the tanh half) and 2i+1 holds column G/2 + i (the sigmoid
    half), so that the two land in one thread's adjacent accumulators."""
    i = torch.arange(G // 2)
    return torch.stack([i, i + G // 2], 1).reshape(-1)


def pack_weights(wconv, wc, wout, wskip, store):
    """The weights in the layouts the kernels' B operands read (reduction
    index contiguous where the product's rows are the data rows), in the
    storage dtype ``store``:

    - ``wg`` (L, G, 3C+cin): the gate product, rows in :func:`gate_perm`
      order, row n = [wconv[l, 0][:, n] | wconv[l, 1][:, n] | wconv[l, 2][:, n] | wc[l][:, n]];
    - ``wo`` (L, C+S, G/2): [wout | wskip]^T, for the out and rebuild products;
    - ``wd`` (L, G/2, C+S): [wout | wskip], for the dact product;
    - ``wx`` (L, C+cin, 3G): row n < C = [wconv[l, 0][n] | wconv[l, 1][n] |
      wconv[l, 2][n]], row C + j = [0 | 0 | wc[l][j]], for the dx/dc product.
    """
    L, _, C, G = wconv.shape
    wk = wconv.reshape(L, 3 * C, G)
    wx = wconv.permute(0, 2, 1, 3).reshape(L, C, 3 * G)
    if wc is not None:
        wk = torch.cat([wk, wc.to(wk.dtype)], 1)
        wcx = torch.cat([torch.zeros(L, wc.shape[1], 2 * G, dtype=wc.dtype, device=wc.device), wc], -1)
        wx = torch.cat([wx, wcx.to(wx.dtype)], 1)
    wd = torch.cat([wout, wskip], -1)
    packed = {"wg": wk[:, :, gate_perm(G).to(wk.device)].transpose(1, 2), "wo": wd.transpose(1, 2), "wd": wd, "wx": wx}
    return {k: v.to(store).contiguous() for k, v in packed.items()}


def check_widths(C, G, Sk, cin):
    """The kernels read every operand row in 16-byte chunks (8 bf16 values)
    and write their outputs 8 columns at a time, so C, G/2, S and cin must be
    multiples of 8. The wrappers pad cin (:func:`pad_cin`); C, G/2 and S are
    not padded, since no preset has another width."""
    bad = {n: v for n, v in (("C", C), ("G/2", G // 2), ("S", Sk), ("cin", cin)) if v % 8}
    if bad:
        raise ValueError(f"glu_stack kernels need widths that are multiples of 8: {bad}")


def pad_cin(c, wc):
    """Zero-pad the conditioning's columns and ``wc``'s rows up to a
    multiple of 8 (cin = 39 in the ae and vocoder presets). The zero
    columns add nothing to any product, so the forward is unchanged and
    the padded rows of dwc and columns of dc are dropped after the
    backward (:func:`unpad_cin`). Returns (c, wc) as given when cin is a
    multiple of 8 or there is no conditioning."""
    if c is None or c.shape[-1] % 8 == 0:
        return c, wc
    pad = -c.shape[-1] % 8
    return F.pad(c, (0, pad)), F.pad(wc, (0, 0, 0, pad))


def unpad_cin(dc, dwc, cin):
    """dc (B, T, cin_padded) and dwc (L, cin_padded, G) cut back to cin."""
    if dc is None or dc.shape[-1] == cin:
        return dc, dwc
    return dc[..., :cin].contiguous(), dwc[:, :cin].contiguous()


class _GluArgs(ctypes.Structure):
    """Field for field the ``GluArgs`` struct of ``csrc/glu_stack.cu``."""

    _fields_ = (
        [(n, ctypes.c_int64) for n in (
            "B", "T", "L", "C", "G", "S", "CIN", "store_bf16", "has_c", "has_g",
        )]
        + [("dil", ctypes.c_int64 * _MAXL)]
        + [(n, ctypes.c_void_p) for n in (
            "x", "c", "g_add", "wg", "wo", "wd", "wx", "bconv", "bout", "bskip",
            "h", "skip", "skips", "ab", "hb", "act", "dskips", "dx", "dab", "dabs", "gy", "dc", "dgadd",
            "dwconv", "dbconv", "dwc", "dwout", "dbout", "dwskip", "dbskip", "work", "stream",
        )]
    )


def _lib():
    from wavenet_autoencoders_tpu_torch.kernels import build

    lib = build.load("glu_stack")
    for fn in (lib.wae_glu_forward, lib.wae_glu_backward):
        fn.argtypes = [ctypes.POINTER(_GluArgs)]
        fn.restype = ctypes.c_int
    lib.wae_glu_workspace_floats.argtypes = [ctypes.POINTER(_GluArgs)]
    lib.wae_glu_workspace_floats.restype = ctypes.c_int64
    lib.wae_glu_error_string.argtypes = [ctypes.c_int]
    lib.wae_glu_error_string.restype = ctypes.c_char_p
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


def _dims(x_shape, wconv, wskip, c, dilations):
    B, T, C = x_shape
    L, three, Cw, G = wconv.shape
    if three != 3 or Cw != C or G % 2:
        raise ValueError(f"wconv {tuple(wconv.shape)} does not fit x {tuple(x_shape)}")
    if len(dilations) != L or L > _MAXL:
        raise ValueError(f"{len(dilations)} dilations for {L} layers (at most {_MAXL})")
    if B * T > 65535 * 128:
        raise ValueError("B*T must be at most 65535*128 (row tiles on one grid axis)")
    cin = 0 if c is None else c.shape[-1]
    check_widths(C, G, wskip.shape[-1], cin)
    return B, T, C, L, G, wskip.shape[-1], cin


def _args(store, B, T, C, L, G, Sk, cin, has_g, dilations, stream):
    a = _GluArgs(B=B, T=T, L=L, C=C, G=G, S=Sk, CIN=cin, store_bf16=int(store == torch.bfloat16),
                 has_c=int(cin > 0), has_g=int(has_g))
    for l, d in enumerate(dilations):
        a.dil[l] = int(d)
    a.stream = stream
    return a


def _ptr(x):
    return None if x is None else x.data_ptr()


def _aligned(x):
    """x contiguous at a 16-byte aligned address (the kernels' loads are
    16-byte copies); a copy only where a view starts elsewhere."""
    x = x.contiguous()
    return x if x.data_ptr() % 16 == 0 else x.clone()


def _storage(x):
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"storage dtype must be float32 or bfloat16, got {x.dtype}")
    return x.dtype


def _packed_shapes(L, C, G, Sk, cin, store):
    return {"wg": ((L, G, 3 * C + cin), store), "wo": ((L, C + Sk, G // 2), store),
            "wd": ((L, G // 2, C + Sk), store), "wx": ((L, C + cin, 3 * G), store)}


def _forward_cuda(x, c, g_add, wconv, bconv, wc, wout, bout, wskip, bskip, dilations):
    global LAUNCHES_FWD
    store = _storage(x)
    dev = x.device
    B, T, C, L, G, Sk, cin = _dims(x.shape, wconv, wskip, c, dilations)
    G2 = G // 2
    f32 = dict(dtype=torch.float32, device=dev)
    t = {"x": _aligned(x), "bconv": bconv.float().contiguous(), "bout": bout.float().contiguous(),
         "bskip": bskip.float().contiguous(), **pack_weights(wconv, wc, wout, wskip, store)}
    shapes = {"x": ((B, T, C), store), "bconv": ((L, G), torch.float32), "bout": ((L, C), torch.float32),
              "bskip": ((L, Sk), torch.float32), **_packed_shapes(L, C, G, Sk, cin, store)}
    if c is not None:
        t["c"] = _aligned(c.to(store))
        shapes["c"] = ((B, T, cin), store)
    if g_add is not None:
        t["g_add"] = g_add.float().contiguous()
        shapes["g_add"] = ((B, L, G), torch.float32)
    for k, (shp, dt) in shapes.items():
        _check(k, t[k], shp, dt, dev)
    h = x.to(torch.float32, copy=True).contiguous()  # updated in place: never the caller's x
    skip = torch.empty(B, T, Sk, **f32)
    skips = torch.empty(B, T, Sk, dtype=store, device=dev)
    ab = torch.empty(B, L, T, G, dtype=store, device=dev)
    hb = torch.empty(B, T, C, dtype=store, device=dev)
    act = torch.empty(B, T, G2, dtype=store, device=dev)
    lib = _lib()
    with torch.cuda.device(dev):
        a = _args(store, B, T, C, L, G, Sk, cin, g_add is not None, dilations,
                  torch.cuda.current_stream(dev).cuda_stream)
        for k, v in t.items():
            setattr(a, k, _ptr(v))
        a.h, a.skip, a.skips, a.ab, a.hb, a.act = map(_ptr, (h, skip, skips, ab, hb, act))
        err = lib.wae_glu_forward(ctypes.byref(a))
    if err != 0:
        raise RuntimeError(f"glu_stack forward launch failed: {lib.wae_glu_error_string(err).decode()}")
    LAUNCHES_FWD += 1
    return skips, h, ab


def _backward_cuda(dskips, hfin, c, ab, wconv, wc, wout, bout, wskip, dilations, has_g):
    global LAUNCHES_BWD
    store = _storage(ab)
    dev = ab.device
    B, T, Sk = dskips.shape
    _, _, C, L, G, _, cin = _dims((B, T, hfin.shape[-1]), wconv, wskip, c, dilations)
    G2 = G // 2
    f32 = dict(dtype=torch.float32, device=dev)
    t = {"dskips": _aligned(dskips.to(store)), "ab": _aligned(ab), "bout": bout.float().contiguous(),
         **pack_weights(wconv, wc, wout, wskip, store)}
    shapes = {"dskips": ((B, T, Sk), store), "ab": ((B, L, T, G), store), "bout": ((L, C), torch.float32),
              **_packed_shapes(L, C, G, Sk, cin, store)}
    if c is not None:
        t["c"] = _aligned(c.to(store))
        shapes["c"] = ((B, T, cin), store)
    for k, (shp, dt) in shapes.items():
        _check(k, t[k], shp, dt, dev)
    _check("hfin", hfin, (B, T, C), torch.float32, dev)
    h = hfin.clone()  # rebuilt in place layer by layer
    out = {
        "dx": torch.zeros(B, T, C, **f32), "dab": torch.empty(B, T, G, **f32),
        "dwconv": torch.empty(L, 3, C, G, **f32), "dbconv": torch.empty(L, G, **f32),
        "dwout": torch.empty(L, G2, C, **f32), "dbout": torch.empty(L, C, **f32),
        "dwskip": torch.empty(L, G2, Sk, **f32), "dbskip": torch.empty(L, Sk, **f32),
        "dc": torch.empty(B, T, cin, **f32) if c is not None else None,
        "dwc": torch.empty(L, cin, G, **f32) if c is not None else None,
        "dgadd": torch.empty(B, L, G, **f32) if has_g else None,
    }
    # the operand buffers, reused across layers; gy = S(dx/sqrt 2) starts at 0
    bufs = {"hb": torch.empty(B, T, C, dtype=store, device=dev),
            "act": torch.empty(B, T, G2, dtype=store, device=dev),
            "dabs": torch.empty(B, T, G, dtype=store, device=dev),
            "gy": torch.zeros(B, T, C, dtype=store, device=dev)}
    lib = _lib()
    with torch.cuda.device(dev):
        a = _args(store, B, T, C, L, G, Sk, cin, has_g, dilations, torch.cuda.current_stream(dev).cuda_stream)
        # sized by the C side, which alone knows the passes' partial-sum layout
        work = torch.empty(lib.wae_glu_workspace_floats(ctypes.byref(a)), **f32)
        for d in (t, out, bufs):
            for k, v in d.items():
                setattr(a, k, _ptr(v))
        a.h, a.work = _ptr(h), _ptr(work)
        err = lib.wae_glu_backward(ctypes.byref(a))
    if err != 0:
        raise RuntimeError(f"glu_stack backward launch failed: {lib.wae_glu_error_string(err).decode()}")
    LAUNCHES_BWD += 1
    o = out
    return (o["dx"].to(store), o["dc"], o["dgadd"], o["dwconv"], o["dbconv"], o["dwc"], o["dwout"],
            o["dbout"], o["dwskip"], o["dbskip"])


def glu_stack_forward(x, c, g_add, wconv, bconv, wc, wout, bout, wskip, bskip, dilations):
    """K2 on a CUDA ``x``, its plain version on a CPU ``x``. Returns
    (skips in S, hfin f32, ab in S); see :func:`glu_stack_forward_reference`."""
    if x.device.type == "cpu":
        return glu_stack_forward_reference(x, c, g_add, wconv, bconv, wc, wout, bout, wskip, bskip, dilations)
    if x.device.type == "cuda":
        c, wc = pad_cin(c, wc)
        return _forward_cuda(x, c, g_add, wconv, bconv, wc, wout, bout, wskip, bskip, dilations)
    raise RuntimeError(f"no glu_stack forward for device {x.device}")


def glu_stack_backward(dskips, hfin, c, ab, wconv, wc, wout, bout, wskip, dilations, has_g):
    """K3 on CUDA tensors, its plain version on CPU ones; see
    :func:`glu_stack_backward_reference`."""
    if ab.device.type == "cpu":
        return glu_stack_backward_reference(dskips, hfin, c, ab, wconv, wc, wout, bout, wskip, dilations, has_g)
    if ab.device.type == "cuda":
        cin = None if c is None else c.shape[-1]
        c, wc = pad_cin(c, wc)
        dx, dc, dgadd, dwconv, dbconv, dwc, *rest = _backward_cuda(
            dskips, hfin, c, ab, wconv, wc, wout, bout, wskip, dilations, has_g)
        dc, dwc = unpad_cin(dc, dwc, cin)
        return (dx, dc, dgadd, dwconv, dbconv, dwc, *rest)
    raise RuntimeError(f"no glu_stack backward for device {ab.device}")


class FusedGLUStack(torch.autograd.Function):
    """``FusedGLUStack.apply(x, c, g_add, wconv, bconv, wc, wout, bout,
    wskip, bskip, dilations)`` -> the unscaled skip sum (B, T, Sk) in x's
    dtype. The backward is K3; weight gradients come back in the dtype of
    the weight passed in (bf16 weights get bf16 gradients, as in JAX)."""

    @staticmethod
    def forward(ctx, x, c, g_add, wconv, bconv, wc, wout, bout, wskip, bskip, dilations):
        skips, hfin, ab = glu_stack_forward(x, c, g_add, wconv, bconv, wc, wout, bout, wskip, bskip,
                                            tuple(dilations))
        ctx.save_for_backward(c, hfin, ab, wconv, wc, wout, bout, wskip)
        ctx.dilations = tuple(dilations)
        ctx.has_g = g_add is not None
        ctx.x_dtype = x.dtype
        return skips

    @staticmethod
    def backward(ctx, dskips):
        c, hfin, ab, wconv, wc, wout, bout, wskip = ctx.saved_tensors
        dx, dc, dgadd, dwconv, dbconv, dwc, dwout, dbout, dwskip, dbskip = glu_stack_backward(
            dskips.contiguous(), hfin, c, ab, wconv, wc, wout, bout, wskip, ctx.dilations, ctx.has_g
        )
        return (
            dx.to(ctx.x_dtype),
            None if c is None else dc.to(c.dtype),
            dgadd,
            dwconv.to(wconv.dtype), dbconv,
            None if wc is None else dwc.to(wc.dtype),
            dwout.to(wout.dtype), dbout,
            dwskip.to(wskip.dtype), dbskip,
            None,
        )
