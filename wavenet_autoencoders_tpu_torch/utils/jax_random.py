"""JAX's default PRNG (threefry2x32) on an explicit device.

The port draws from the keys the JAX package uses: its initial weights
(``build_model(cfg, device, seed)`` holds the weights of
``build_model(cfg).init(PRNGKey(seed))`` in the JAX package) and every draw
the JAX package makes after initialisation -- the train step's key chain
(``fold_in(PRNGKey(seed + 1), step)`` split by each model as its JAX
``forward`` splits it), dropout, time jitter, VQ-dropout, Gumbel noise,
the reseed candidates, the AR samplers, synthesis and the eval hooks. This
module follows ``jax/_src/prng.py`` and ``jax/_src/random.py`` of JAX 0.9.0
with ``jax_threefry_partitionable`` True (its default since JAX 0.5.0) and
64-bit types off:

- a key is a (2,) tensor of two 32-bit words, held as int64 in [0, 2³²); a
  tensor (..., 2) is a batch of keys, on which every function acts as
  ``jax.vmap`` of JAX's;
- ``split`` is the fold-like threefry over the (hi, lo) words of a 64-bit
  iota; ``fold_in`` hashes the pair (0, data); 32-bit random bits are the
  xor of the two threefry outputs over the same iota, element i's counter
  being its flat index;
- ``uniform`` fills the mantissa with the top 23 bits, and computes
  ``max(lo, u·(hi − lo) + lo)`` with ``hi − lo`` rounded to f32 and the
  multiply-add rounded once (XLA fuses it);
- ``bernoulli`` is ``uniform(key, shape) < f32(p)``;
- ``normal`` is ``√2·erf_inv(uniform(nextafter(−1, 0), 1))``, with XLA's
  f32 ``erf_inv`` (Giles' polynomial) evaluated as XLA evaluates it: the
  square and the results in f32, each multiply-add rounded once, the
  logarithm in float64 rounded to f32. It agrees with ``jax.random.normal``
  within 1e-6 relative (a last-bit difference of XLA's f32 ``log1p``);
- ``randint`` is JAX's two-draw ``higher·(2^16 mod span)² + lower`` in
  32-bit arithmetic, modulo the span.

The threefry evaluations go through ``kernels/threefry.py``: the CUDA
kernel for keys on the card, its plain torch-op version for keys on the
CPU. Every function draws on the key's device; none reads a key back to
the host.

Rows of a draw: JAX draws its noise over the global batch. With ``rows=(r0,
r1)`` the bits, uniforms, Bernoulli draws, normals and integers of rows
[r0, r1) of ``shape``'s first axis are drawn alone, equal to that slice of
the whole draw bit for bit, since element i's counter is its flat index:
rows [r0, r1) are counters [r0·rest, r1·rest), rest the product of the
other axes. A data rank draws the rows of its slice of the global batch.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from wavenet_autoencoders_tpu_torch.kernels import threefry as K

MASK = K.MASK


def PRNGKey(seed: int, device: str | torch.device = "cpu") -> torch.Tensor:  # noqa: N802 (JAX's name)
    """``jax.random.PRNGKey(seed)`` with 64-bit types off: (0, seed mod 2³²)."""
    return torch.tensor([0, int(seed) & MASK], dtype=torch.int64, device=device)


def threefry2x32(key: torch.Tensor, x0: torch.Tensor, x1: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The Threefry-2x32 hash (20 rounds) of the count pairs (x0, x1) under
    ``key`` (..., 2), whose words broadcast against them: JAX's
    ``threefry2x32_p``, elementwise."""
    return K.threefry2x32(key[..., 0], key[..., 1], x0, x1)


def _batched(key: torch.Tensor, ndim: int) -> torch.Tensor:
    """``key`` (..., 2) with ``ndim`` unit axes before the words, to
    broadcast against counts of ``ndim`` axes."""
    return key.reshape(*key.shape[:-1], *([1] * ndim), 2)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split(key, num)``: (..., num, 2) keys (``jax.vmap`` of it
    over a batch of keys (..., 2))."""
    y0, y1 = threefry2x32(_batched(key, 1), *K.iota_words(num, 0, key.device))
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


def _layout(key: torch.Tensor, shape, rows) -> tuple[torch.Tensor, int, int, tuple[int, ...]]:
    """(keys (nk, 2), counters a key, first counter, output shape) of a draw
    of ``shape`` (or of its rows [r0, r1)) under ``key`` (..., 2)."""
    shape = tuple(int(s) for s in shape)
    first, out = 0, shape
    if rows is not None:
        r0, r1 = (int(r) for r in rows)
        if not shape or not 0 <= r0 <= r1 <= shape[0]:
            raise ValueError(f"rows {rows} are not rows of a draw of shape {shape}")
        rest = math.prod(shape[1:])
        first, out = r0 * rest, (r1 - r0, *shape[1:])
    return key.reshape(-1, 2), math.prod(out), first, (*key.shape[:-1], *out)


def random_bits(key: torch.Tensor, shape, rows=None) -> torch.Tensor:
    """``jax.random.bits(key, shape, uint32)`` as int64 words in [0, 2³²):
    (..., *shape) for keys (..., 2); rows [r0, r1) of it with ``rows``."""
    keys, n, first, out = _layout(key, shape, rows)
    return K.bits(keys, n, first).reshape(out)


def _f32(x: float) -> float:
    return float(np.float32(x))


def uniform(key: torch.Tensor, shape, minval: float = 0.0, maxval: float = 1.0, rows=None) -> torch.Tensor:
    """``jax.random.uniform(key, shape, float32, minval, maxval)``, bit for
    bit; rows [r0, r1) of it with ``rows``."""
    lo, hi = _f32(minval), _f32(maxval)
    span = _f32(np.float32(hi) - np.float32(lo))
    keys, n, first, out = _layout(key, shape, rows)
    return K.uniform(keys, n, first, lo, span).reshape(out)


def bernoulli(key: torch.Tensor, p: float, shape, rows=None) -> torch.Tensor:
    """``jax.random.bernoulli(key, p, shape)`` for a Python float p (JAX
    converts it to f32): ``uniform(key, shape) < f32(p)``, a bool tensor;
    rows [r0, r1) of it with ``rows``."""
    keys, n, first, out = _layout(key, shape, rows)
    return K.keep_mask(keys, n, first, _f32(p)).reshape(out)


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


def normal(key: torch.Tensor, shape, rows=None) -> torch.Tensor:
    """``jax.random.normal(key, shape, float32)`` within 1e-6 relative;
    rows [r0, r1) of it with ``rows``."""
    lo = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
    return _f32(math.sqrt(2.0)) * erf_inv(uniform(key, shape, lo, 1.0, rows=rows))


def randint(key: torch.Tensor, shape, minval: int, maxval: int, rows=None) -> torch.Tensor:
    """``jax.random.randint(key, shape, minval, maxval)`` (int32 range), bit
    for bit, as int64: (..., *shape) for keys (..., 2); rows [r0, r1) of it
    with ``rows``."""
    keys = split(key)
    higher, lower = random_bits(keys[..., 0, :], shape, rows), random_bits(keys[..., 1, :], shape, rows)
    return randint_of_bits(higher, lower, minval, maxval)


def randint_of_bits(higher: torch.Tensor, lower: torch.Tensor, minval: int, maxval: int) -> torch.Tensor:
    """:func:`randint`'s map of its two draws of words, ``higher`` and
    ``lower``, into [minval, maxval): the words do not depend on the range,
    so a table of them drawn ahead serves any range (the train step's
    reseed candidates)."""
    minval, maxval = int(minval), int(maxval)
    if not -(2**31) <= minval <= maxval <= 2**31 - 1:
        raise ValueError(f"randint range [{minval}, {maxval}) is not an int32 range")
    span = max(maxval - minval, 1)
    mult = ((2**16 % span) ** 2 & MASK) % span  # in uint32: 0 for spans above 2^16
    offset = ((higher % span) * mult + lower % span) & MASK
    return minval + offset % span
