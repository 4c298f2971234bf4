"""The conditioning upsampler's stretch-and-smooth chain: the CUDA kernels of
``csrc/upsample.cu``, their plain PyTorch version, and ``Upsample``, the
``torch.autograd.Function`` that joins them.

Not a port of a TPU kernel: the JAX package leaves the upsampler
(``wavenet_autoencoders_tpu/ops/upsample.py``) to XLA. The plain version is
the chain as ``ops/upsample.py`` wrote it: per scale a nearest-neighbour
stretch (``repeat_interleave``) and a one-channel ``F.conv2d`` over the
(B, 1, cin, T) "image" with kernel (freq_ks, 2s+1). On the card those
convolutions are tensor-core tiles almost wholly empty; the kernels run every
scale of a (b, channel) row in shared memory instead (the source's note).

The chain takes the folded smoothing weights ``ws`` (one (1, 1, freq_ks,
2s+1) tensor a scale) in the dtype of ``x`` (B, T0, cin), and returns
(B, T0·prod(scales) − 2·indent, cin) in that dtype: f32, or bf16 with f32
accumulation and each scale's output, and each gradient, rounded to bf16
where the plain version's autograd rounds it. The weight norm stays outside,
in autograd.

Dispatch is on the device of ``x``: CPU tensors take the plain version,
CUDA tensors the kernels, and what the kernels do not take raises
(:func:`check_supported`: freq_ks other than 1, a dtype other than f32 or
bf16, more than 8 scales or a scale above 8). There is no fallback.
"""
from __future__ import annotations

import ctypes
import math

import torch
import torch.nn.functional as F

#: Calls of the CUDA forward and backward entry points; the plain version
#: does not count. Set them to 0 before a run whose launches you want to
#: count.
LAUNCHES_FWD = 0
LAUNCHES_BWD = 0

MAX_SCALES = 8
MAX_SCALE = 8


def upsample_reference(x, ws, scales, freq_axis_kernel_size: int = 1, indent: int = 0):
    """The plain version: x (B, T0, C) -> (B, T0·prod(scales) − 2·indent, C),
    each scale a stretch and a one-channel 2-D conv with ``ws[k]`` (1, 1,
    freq_ks, 2s+1), in the dtype of x and the weights. Differentiable."""
    y = x.transpose(1, 2)[:, None]  # (B, 1, C, T)
    fpad = (freq_axis_kernel_size - 1) // 2
    for w, s in zip(ws, scales):
        y = F.conv2d(y.repeat_interleave(s, dim=3), w, padding=(fpad, s))
    out = y[:, 0].transpose(1, 2)  # (B, T, C)
    if indent > 0:
        out = out[:, indent:-indent, :]
    return out


def check_supported(x, ws, scales, freq_axis_kernel_size: int, indent: int = 0) -> None:
    """Raise ValueError where the kernels do not take the call: a
    frequency-axis kernel other than 1, a dtype other than f32 or bf16,
    weights of another dtype or shape than (1, 1, 1, 2s+1), more than
    ``MAX_SCALES`` scales, a scale outside 1..``MAX_SCALE``, or an output
    trimmed away."""
    if freq_axis_kernel_size != 1:
        raise ValueError(f"the upsample kernels take freq_axis_kernel_size 1, got {freq_axis_kernel_size}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"the upsample kernels take float32 or bfloat16, got {x.dtype}")
    if x.ndim != 3:
        raise ValueError(f"x must be (B, T0, cin), got {tuple(x.shape)}")
    scales = [int(s) for s in scales]
    if not 1 <= len(scales) <= MAX_SCALES or len(ws) != len(scales):
        raise ValueError(f"{len(scales)} scales and {len(ws)} weights (1 to {MAX_SCALES} scales)")
    for w, s in zip(ws, scales):
        if not 1 <= s <= MAX_SCALE:
            raise ValueError(f"the upsample kernels take scales 1..{MAX_SCALE}, got {s}")
        if w.dtype != x.dtype or tuple(w.shape) != (1, 1, 1, 2 * s + 1):
            raise ValueError(f"weight of scale {s} is {w.dtype} {tuple(w.shape)}, expected {x.dtype} "
                             f"(1, 1, 1, {2 * s + 1})")
    if _out_len(x.shape[1], scales, indent) < 1:
        raise ValueError(f"indent {indent} trims all of {x.shape[1] * math.prod(scales)} samples")


class _UpArgs(ctypes.Structure):
    """Field for field the ``UpArgs`` struct of ``csrc/upsample.cu``."""

    _fields_ = (
        [(n, ctypes.c_int64) for n in ("B", "T0", "cin", "K", "indent", "bf16")]
        + [("scale", ctypes.c_int64 * MAX_SCALES), ("x", ctypes.c_void_p), ("w", ctypes.c_void_p * MAX_SCALES),
           ("out", ctypes.c_void_p), ("dy", ctypes.c_void_p), ("dx", ctypes.c_void_p),
           ("dw", ctypes.c_void_p * MAX_SCALES), ("work", ctypes.c_void_p), ("stream", ctypes.c_void_p)]
    )


_LIB = []


def _lib():
    """The loaded library, its argument types set once."""
    if _LIB:
        return _LIB[0]
    from wavenet_autoencoders_tpu_torch.kernels import build

    lib = build.load("upsample")
    for fn in (lib.wae_up_forward, lib.wae_up_backward):
        fn.argtypes = [ctypes.POINTER(_UpArgs)]
        fn.restype = ctypes.c_int
    lib.wae_up_workspace_floats.argtypes = [ctypes.POINTER(_UpArgs)]
    lib.wae_up_workspace_floats.restype = ctypes.c_int64
    lib.wae_up_error_string.argtypes = [ctypes.c_int]
    lib.wae_up_error_string.restype = ctypes.c_char_p
    _LIB.append(lib)
    return lib


def _args(x, ws, scales, indent) -> _UpArgs:
    B, T0, cin = x.shape
    a = _UpArgs(B=B, T0=T0, cin=cin, K=len(scales), indent=indent, bf16=int(x.dtype == torch.bfloat16))
    for k, (w, s) in enumerate(zip(ws, scales)):
        a.scale[k] = int(s)
        a.w[k] = w.data_ptr()
    a.x = x.data_ptr()
    a.stream = torch.cuda.current_stream(x.device).cuda_stream
    return a


def _call(name, a) -> None:
    lib = _lib()
    err = getattr(lib, name)(ctypes.byref(a))
    if err != 0:
        raise RuntimeError(f"upsample kernel {name} failed: {lib.wae_up_error_string(err).decode()}")


def _out_len(T0, scales, indent) -> int:
    return T0 * math.prod(int(s) for s in scales) - 2 * indent


def _forward_cuda(x, ws, scales, indent):
    global LAUNCHES_FWD
    B, T0, cin = x.shape
    out = torch.empty(B, _out_len(T0, scales, indent), cin, dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        a = _args(x, ws, scales, indent)
        a.out = out.data_ptr()
        _call("wae_up_forward", a)
    LAUNCHES_FWD += 1
    return out


def _backward_cuda(dy, x, ws, scales, indent):
    global LAUNCHES_BWD
    dx = torch.empty_like(x)
    dws = [torch.empty_like(w) for w in ws]
    with torch.cuda.device(x.device):
        a = _args(x, ws, scales, indent)
        # sized by the C side, which alone knows the blocks' slots
        work = torch.empty(_lib().wae_up_workspace_floats(ctypes.byref(a)), dtype=torch.float32, device=x.device)
        a.dy, a.dx, a.work = dy.data_ptr(), dx.data_ptr(), work.data_ptr()
        for k, g in enumerate(dws):
            a.dw[k] = g.data_ptr()
        _call("wae_up_backward", a)
    LAUNCHES_BWD += 1
    return dx, dws


class Upsample(torch.autograd.Function):
    """``Upsample.apply(x, scales, indent, *ws)`` -> the chain's output
    (B, T, cin), contiguous, in x's dtype; the backward gives x's and each
    weight's gradient in their dtype. CUDA tensors only."""

    @staticmethod
    def forward(ctx, x, scales, indent, *ws):
        x = x.contiguous()
        ws = tuple(w.contiguous() for w in ws)
        ctx.save_for_backward(x, *ws)
        ctx.scales, ctx.indent = tuple(int(s) for s in scales), int(indent)
        return _forward_cuda(x, ws, ctx.scales, ctx.indent)

    @staticmethod
    def backward(ctx, dy):
        x, *ws = ctx.saved_tensors
        dx, dws = _backward_cuda(dy.to(x.dtype).contiguous(), x, ws, ctx.scales, ctx.indent)
        return (dx, None, None, *dws)


def upsample(x, ws, scales, freq_axis_kernel_size: int = 1, indent: int = 0):
    """The chain on x (B, T0, cin) with the folded weights ``ws``: the plain
    version on a CPU ``x``, the kernels on a CUDA one (or ValueError, see
    :func:`check_supported`)."""
    if x.device.type == "cpu":
        return upsample_reference(x, ws, scales, freq_axis_kernel_size, indent)
    if x.device.type == "cuda":
        check_supported(x, ws, scales, freq_axis_kernel_size, indent)
        return Upsample.apply(x, tuple(scales), indent, *ws)
    raise RuntimeError(f"no upsample kernels for device {x.device}")
