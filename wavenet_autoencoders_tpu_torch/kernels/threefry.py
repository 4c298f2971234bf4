"""JAX's threefry2x32 draws: the CUDA kernel of ``csrc/threefry.cu`` and its
plain PyTorch version.

Not a port of a TPU kernel: the JAX package draws its noise through XLA's
threefry (``jax.random``), with no Pallas call. The port makes the same
draws from the same keys (``utils/jax_random.py``), and this is the kernel
that makes them on the card: a dropout mask at svqwae's training shape is
52.4 M uniforms a layer, which the plain version computes in ~160
element-wise int64 passes.

Words are 32-bit. The plain version holds them in int64 tensors, masked to
[0, 2³²) after every add and shift (CUDA's uint32 support in torch is
partial); the kernel reads and writes them as int32 bit patterns, which
the wrappers convert from and to the plain version's int64 words. Keys are
``(nk, 2)`` word pairs. The entry points:

- :func:`threefry2x32` (a): threefry2x32 of given counter pairs under keys that
  broadcast against them (``split``, ``fold_in``);
- :func:`bits` (b): for each key, the 32-bit words of the counters
  ``offset .. offset + n`` (their (hi, lo) halves hashed, the two outputs
  xor'd), JAX's partitionable ``random_bits``;
- :func:`uniform` (c): (b) mapped to f32 as ``jax.random.uniform`` maps it,
  ``max(lo, (mantissa − 1)·span + lo)`` with the multiply-add rounded once;
- :func:`keep_mask` (d): (c) on [0, 1) compared with ``keep``, a bool
  tensor (``jax.random.bernoulli(key, keep, shape)``).

Dispatch is on the device of the keys: CPU tensors take the plain
versions, CUDA tensors the kernel, and a build or launch failure raises.
There is no fallback.
"""
from __future__ import annotations

import ctypes

import torch

#: Launches of the CUDA kernel (any entry point); the plain versions do not
#: count. Set it to 0 before a run whose launches you want to count.
LAUNCHES = 0

MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


# ---------------------------------------------------------------------------
# the plain versions (torch ops on int64 words)
# ---------------------------------------------------------------------------


def threefry2x32_reference(k0, k1, x0, x1) -> tuple[torch.Tensor, torch.Tensor]:
    """The Threefry-2x32 hash (20 rounds) of the count pairs (x0, x1) under
    the key words (k0, k1), all int64 words that broadcast together: JAX's
    ``threefry2x32_p``, elementwise (in place on new tensors)."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]).bitwise_and_(MASK)
    x1 = (x1 + ks[1]).bitwise_and_(MASK)
    if x0.shape != x1.shape:
        x0, x1 = (t.contiguous() for t in torch.broadcast_tensors(x0, x1))
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0.add_(x1).bitwise_and_(MASK)
            # x1 = rotl(x1, r) ^ x0
            high = x1 >> (32 - r)
            x1.bitwise_left_shift_(r).bitwise_and_(MASK).bitwise_or_(high).bitwise_xor_(x0)
        x0.add_(ks[(i + 1) % 3]).bitwise_and_(MASK)
        x1.add_(ks[(i + 2) % 3] + (i + 1)).bitwise_and_(MASK)
    return x0, x1


def iota_words(n: int, offset: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """The (hi, lo) words of the 64-bit counters offset .. offset + n."""
    idx = torch.arange(offset, offset + n, dtype=torch.int64, device=device)
    return idx >> 32, idx & MASK


def bits_reference(keys: torch.Tensor, n: int, offset: int = 0) -> torch.Tensor:
    """(nk, n) int64 words: the xor of threefry's outputs over the counters
    offset .. offset + n, under each of the (nk, 2) keys."""
    hi, lo = iota_words(n, offset, keys.device)
    y0, y1 = threefry2x32_reference(keys[:, :1], keys[:, 1:], hi[None], lo[None])
    return y0 ^ y1


def uniform_of_bits(bits: torch.Tensor, lo: float, span: float) -> torch.Tensor:
    """f32 ``max(lo, u·span + lo)`` for u = mantissa(bits) − 1, lo and span
    f32 values; the product and sum in float64, rounded once to f32 (exact
    for every lo and span the port draws with, as the fused multiply-add
    is)."""
    mant = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    return torch.clamp_min((mant.double() * span + lo).float(), lo)


def uniform_reference(keys: torch.Tensor, n: int, offset: int, lo: float, span: float) -> torch.Tensor:
    """(nk, n) f32: :func:`uniform_of_bits` of :func:`bits_reference`."""
    return uniform_of_bits(bits_reference(keys, n, offset), lo, span)


def keep_reference(keys: torch.Tensor, n: int, offset: int, keep: float) -> torch.Tensor:
    """(nk, n) bool: ``uniform(0, 1) < keep`` (keep an f32 value)."""
    return uniform_reference(keys, n, offset, 0.0, 1.0) < keep


# ---------------------------------------------------------------------------
# the kernel
# ---------------------------------------------------------------------------


_LIB = []


def _lib():
    """The loaded library, its argument types set once (a draw is called
    once a layer or a step, where the ctypes set-up would show)."""
    if _LIB:
        return _LIB[0]
    from wavenet_autoencoders_tpu_torch.kernels import build

    lib = build.load("threefry")
    p, i64, u64, f32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_uint64, ctypes.c_float
    lib.wae_threefry_hash.argtypes = [p, p, p, p, p, p, i64, p]
    lib.wae_threefry_bits.argtypes = [p, i64, i64, u64, p, p]
    lib.wae_threefry_uniform.argtypes = [p, i64, i64, u64, f32, f32, p, p]
    lib.wae_threefry_keep.argtypes = [p, i64, i64, u64, f32, p, p]
    for fn in (lib.wae_threefry_hash, lib.wae_threefry_bits, lib.wae_threefry_uniform, lib.wae_threefry_keep):
        fn.restype = ctypes.c_int
    lib.wae_threefry_error_string.argtypes = [ctypes.c_int]
    lib.wae_threefry_error_string.restype = ctypes.c_char_p
    _LIB.append(lib)
    return lib


def _words32(t: torch.Tensor) -> torch.Tensor:
    """int64 words -> contiguous int32 tensors of the same bits."""
    return (t & MASK).to(torch.int32).contiguous()


def _words64(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.int64) & MASK


def _launch(name: str, *args) -> None:
    global LAUNCHES
    lib = _lib()
    err = getattr(lib, name)(*args)
    if err != 0:
        raise RuntimeError(f"threefry kernel {name} failed: {lib.wae_threefry_error_string(err).decode()}")
    LAUNCHES += 1


def _stream(dev: torch.device) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def _keys(keys: torch.Tensor) -> torch.Tensor:
    if keys.ndim != 2 or keys.shape[1] != 2:
        raise ValueError(f"keys must be (nk, 2), got {tuple(keys.shape)}")
    return keys


def _cuda(t: torch.Tensor) -> bool:
    if t.device.type == "cpu":
        return False
    if t.device.type == "cuda":
        return True
    raise RuntimeError(f"no threefry kernel for device {t.device}")


def threefry2x32(k0, k1, x0, x1) -> tuple[torch.Tensor, torch.Tensor]:
    """Entry point (a): :func:`threefry2x32_reference` on CPU tensors, the kernel on
    CUDA ones (every argument broadcast to one shape first)."""
    if not _cuda(x0):
        return threefry2x32_reference(k0, k1, x0, x1)
    k0, k1, x0, x1 = (_words32(t) for t in torch.broadcast_tensors(k0, k1, x0, x1))
    y0, y1 = torch.empty_like(x0), torch.empty_like(x0)
    with torch.cuda.device(x0.device):
        _launch("wae_threefry_hash", *(t.data_ptr() for t in (k0, k1, x0, x1, y0, y1)), x0.numel(),
                _stream(x0.device))
    return _words64(y0), _words64(y1)


def bits(keys: torch.Tensor, n: int, offset: int = 0) -> torch.Tensor:
    """Entry point (b): (nk, n) int64 words; see :func:`bits_reference`."""
    keys = _keys(keys)
    if not _cuda(keys):
        return bits_reference(keys, n, offset)
    k = _words32(keys)
    out = torch.empty(k.shape[0], n, dtype=torch.int32, device=k.device)
    with torch.cuda.device(k.device):
        _launch("wae_threefry_bits", k.data_ptr(), k.shape[0], n, offset, out.data_ptr(), _stream(k.device))
    return _words64(out)


def uniform(keys: torch.Tensor, n: int, offset: int, lo: float, span: float) -> torch.Tensor:
    """Entry point (c): (nk, n) f32; see :func:`uniform_reference`."""
    keys = _keys(keys)
    if not _cuda(keys):
        return uniform_reference(keys, n, offset, lo, span)
    k = _words32(keys)
    out = torch.empty(k.shape[0], n, dtype=torch.float32, device=k.device)
    with torch.cuda.device(k.device):
        _launch("wae_threefry_uniform", k.data_ptr(), k.shape[0], n, offset, lo, span, out.data_ptr(),
                _stream(k.device))
    return out


def keep_mask(keys: torch.Tensor, n: int, offset: int, keep: float) -> torch.Tensor:
    """Entry point (d): (nk, n) bool; see :func:`keep_reference`."""
    keys = _keys(keys)
    if not _cuda(keys):
        return keep_reference(keys, n, offset, keep)
    k = _words32(keys)
    out = torch.empty(k.shape[0], n, dtype=torch.bool, device=k.device)
    with torch.cuda.device(k.device):
        _launch("wae_threefry_keep", k.data_ptr(), k.shape[0], n, offset, keep, out.data_ptr(), _stream(k.device))
    return out
