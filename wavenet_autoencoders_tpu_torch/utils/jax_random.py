"""JAX's default PRNG (threefry2x32) as torch ops on an explicit device.

The port draws its initial weights and its dead-code reseed candidates
from the keys the JAX package uses, so that ``build_model(cfg, device,
seed)`` holds the weights of ``build_model(cfg).init(PRNGKey(seed))`` in
the JAX package, and a train step draws the reseed candidates of the JAX
step. This module follows ``jax/_src/prng.py`` and ``jax/_src/random.py``
of JAX 0.9.0 with ``jax_threefry_partitionable`` True (its default since
JAX 0.5.0) and 64-bit types off:

- a key is a (2,) tensor of two 32-bit words, held as int64 and masked to
  32 bits after every add and shift (CUDA's uint32 support is partial); a
  tensor (..., 2) is a batch of keys, on which every function acts as
  ``jax.vmap`` of JAX's;
- ``split`` is the fold-like threefry over the (hi, lo) words of a 64-bit
  iota; ``fold_in`` hashes the pair (0, data); 32-bit random bits are the
  xor of the two threefry outputs over the same iota;
- ``uniform`` fills the mantissa with the top 23 bits, and computes
  ``max(lo, u·(hi − lo) + lo)`` with ``hi − lo`` rounded to f32 and the
  rest in float64, rounded once to f32 (XLA's CPU fuses the multiply-add);
- ``normal`` is ``√2·erf_inv(uniform(nextafter(−1, 0), 1))``, with XLA's
  f32 ``erf_inv`` (Giles' polynomial) evaluated as XLA evaluates it: the
  square and the results in f32, each multiply-add rounded once, the
  logarithm in float64 rounded to f32. It agrees with ``jax.random.normal``
  within 1e-6 relative (a last-bit difference of XLA's f32 ``log1p``);
- ``randint`` is JAX's two-draw ``higher·(2^16 mod span)² + lower`` in
  32-bit arithmetic, modulo the span.

Every function draws on the key's device. No function reads a key back to
the host.
"""
from __future__ import annotations

import math

import numpy as np
import torch

MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def PRNGKey(seed: int, device: str | torch.device = "cpu") -> torch.Tensor:  # noqa: N802 (JAX's name)
    """``jax.random.PRNGKey(seed)`` with 64-bit types off: (0, seed mod 2³²)."""
    return torch.tensor([0, int(seed) & MASK], dtype=torch.int64, device=device)


def threefry2x32(key: torch.Tensor, x0: torch.Tensor, x1: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The Threefry-2x32 hash (20 rounds) of the count pairs (x0, x1), of one
    shape, under ``key`` (..., 2), whose words broadcast against them: JAX's
    ``threefry2x32_p``, elementwise (in place on new tensors)."""
    k0, k1 = key[..., 0], key[..., 1]
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]).bitwise_and_(MASK)
    x1 = (x1 + ks[1]).bitwise_and_(MASK)
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0.add_(x1).bitwise_and_(MASK)
            # x1 = rotl(x1, r) ^ x0
            high = x1 >> (32 - r)
            x1.bitwise_left_shift_(r).bitwise_and_(MASK).bitwise_or_(high).bitwise_xor_(x0)
        x0.add_(ks[(i + 1) % 3]).bitwise_and_(MASK)
        x1.add_(ks[(i + 2) % 3] + (i + 1)).bitwise_and_(MASK)
    return x0, x1


def _iota_2x32(n: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    idx = torch.arange(n, dtype=torch.int64, device=device)
    return idx >> 32, idx & MASK


def _batched(key: torch.Tensor, ndim: int) -> torch.Tensor:
    """``key`` (..., 2) with ``ndim`` unit axes before the words, to
    broadcast against counts of ``ndim`` axes."""
    return key.reshape(*key.shape[:-1], *([1] * ndim), 2)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split(key, num)``: (..., num, 2) keys (``jax.vmap`` of it
    over a batch of keys (..., 2))."""
    y0, y1 = threefry2x32(_batched(key, 1), *_iota_2x32(num, key.device))
    return torch.stack([y0, y1], dim=-1)


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in(key, data)`` for 0 <= data < 2³²; ``data`` may
    be an int64 tensor of such words (not checked), which broadcasts
    against the batch of keys."""
    if not torch.is_tensor(data):
        if not 0 <= int(data) <= MASK:
            raise ValueError(f"fold_in data {data} is not a uint32")
        data = key.new_full(key.shape[:-1], int(data))  # a fill on the key's device, no copy from the host
    y0, y1 = threefry2x32(key, torch.zeros_like(data), data)
    return torch.stack([y0, y1], dim=-1)


def random_bits(key: torch.Tensor, shape) -> torch.Tensor:
    """``jax.random.bits(key, shape, uint32)`` as int64 words in [0, 2³²):
    (..., *shape) for keys (..., 2)."""
    shape = tuple(int(s) for s in shape)
    hi, lo = _iota_2x32(math.prod(shape), key.device)
    y0, y1 = threefry2x32(_batched(key, len(shape)), hi.reshape(shape), lo.reshape(shape))
    return y0 ^ y1


def _f32(x: float) -> float:
    return float(np.float32(x))


def uniform(key: torch.Tensor, shape, minval: float = 0.0, maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform(key, shape, float32, minval, maxval)``, bit for bit."""
    bits = random_bits(key, shape)
    mant = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    lo, hi = _f32(minval), _f32(maxval)
    span = _f32(np.float32(hi) - np.float32(lo))
    out = (mant.double() * span + lo).float()
    return torch.clamp_min(out, lo)


# XLA's f32 erf_inv (M. Giles, "Approximating the erfinv function"): the
# coefficients for w < 5 and for w >= 5, highest power first
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06, 0.00021858087,
               -0.00125372503, -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844, 0.00573950773,
               -0.0076224613, 0.00943887047, 1.00167406, 2.83297682)


def erf_inv(x: torch.Tensor) -> torch.Tensor:
    """XLA's f32 ``erf_inv`` of an f32 tensor: w = −log1p(−x²), then Giles'
    polynomial in w − 2.5 (w < 5) or √w − 3 (w ≥ 5), times x; ±inf at ±1."""
    xx = x * x
    w = (-torch.log1p(-xx.double())).float()
    lt = w < 5.0
    t = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0).double()
    p = torch.where(lt, _f32(_ERFINV_LT5[0]), _f32(_ERFINV_GE5[0])).double()
    for c_lt, c_ge in zip(_ERFINV_LT5[1:], _ERFINV_GE5[1:]):
        c = torch.where(lt, _f32(c_lt), _f32(c_ge))
        p = (p * t + c.double()).float().double()
    out = p.float() * x
    return torch.where(x.abs() == 1.0, x * math.inf, out)


def normal(key: torch.Tensor, shape) -> torch.Tensor:
    """``jax.random.normal(key, shape, float32)`` within 1e-6 relative."""
    lo = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
    return _f32(math.sqrt(2.0)) * erf_inv(uniform(key, shape, lo, 1.0))


def randint(key: torch.Tensor, shape, minval: int, maxval: int) -> torch.Tensor:
    """``jax.random.randint(key, shape, minval, maxval)`` (int32 range), bit
    for bit, as int64: (..., *shape) for keys (..., 2)."""
    minval, maxval = int(minval), int(maxval)
    if not -(2**31) <= minval <= maxval <= 2**31 - 1:
        raise ValueError(f"randint range [{minval}, {maxval}) is not an int32 range")
    keys = split(key)
    higher, lower = random_bits(keys[..., 0, :], shape), random_bits(keys[..., 1, :], shape)
    span = max(maxval - minval, 1)
    mult = ((2**16 % span) ** 2 & MASK) % span  # in uint32: 0 for spans above 2^16
    offset = ((higher % span) * mult + lower % span) & MASK
    return minval + offset % span
