"""``utils/jax_random.py`` (JAX's threefry PRNG as torch ops) against
``jax.random`` on the CPU: keys, ``split``, ``fold_in``, the raw bits,
``uniform`` and ``randint`` bit for bit; ``normal`` within 1e-6 relative
(its stated tolerance: XLA's f32 ``log1p`` differs from a correctly rounded
one in the last bit of about 1 % of the values). Seeds 0, 1234 and
2**31 - 1; shapes with zero and odd sizes."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from wavenet_autoencoders_tpu_torch.utils import jax_random as jr  # noqa: E402

SEEDS = [0, 1234, 2**31 - 1]
SHAPES = [(0,), (1,), (7,), (3, 5), (2, 0, 3), (1001,)]


def _key(seed):
    return jax.random.PRNGKey(seed), jr.PRNGKey(seed)


def test_the_partitionable_threefry_is_the_one_followed():
    assert jax.config.jax_threefry_partitionable


@pytest.mark.parametrize("seed", SEEDS)
def test_keys_split_and_fold_in_bit_for_bit(seed):
    jk, tk = _key(seed)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk).astype(np.int64))
    for n in (1, 2, 3, 5, 24):
        np.testing.assert_array_equal(jr.split(tk, n).numpy(), np.asarray(jax.random.split(jk, n)))
    for data in (0, 1, 99, 0x5EED, 2**31, 2**32 - 1):
        np.testing.assert_array_equal(jr.fold_in(tk, data).numpy(), np.asarray(jax.random.fold_in(jk, data)))
    # a chain, as the train step folds in the step, 0x5EED and a slice
    jc, tc = jk, tk
    for data in (7, 0x5EED, 1):
        jc, tc = jax.random.fold_in(jc, data), jr.fold_in(tc, data)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    with pytest.raises(ValueError, match="uint32"):
        jr.fold_in(tk, -1)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_random_bits_bit_for_bit(seed, shape):
    jk, tk = _key(seed)
    got = jr.random_bits(tk, shape)
    assert got.shape == shape and got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), np.asarray(jax.random.bits(jk, shape, jnp.uint32)).astype(np.int64))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("lo,hi", [(0.0, 1.0), (-1.0, 1.0), (-1 / 256, 1 / 256), (-0.0625, 0.0625), (2.5, 7.0)])
def test_uniform_bit_for_bit(seed, lo, hi):
    jk, tk = _key(seed)
    for shape in SHAPES:
        want = np.asarray(jax.random.uniform(jk, shape, jnp.float32, lo, hi))
        got = jr.uniform(tk, shape, lo, hi).numpy()
        assert got.dtype == np.float32 and got.shape == shape
        np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("lo,hi", [(0, 256), (0, 10240), (0, 12345), (0, 2**16 + 3), (-3, 2**20), (5, 6), (7, 7),
                                   (0, 2**31 - 1)])
def test_randint_bit_for_bit(seed, lo, hi):
    jk, tk = _key(seed)
    for shape in SHAPES:
        want = np.asarray(jax.random.randint(jk, shape, lo, hi)).astype(np.int64)
        np.testing.assert_array_equal(jr.randint(tk, shape, lo, hi).numpy(), want)


@pytest.mark.parametrize("seed", SEEDS)
def test_normal_within_1e6_relative(seed):
    jk, tk = _key(seed)
    for shape in SHAPES + [(200_003,)]:
        want = np.asarray(jax.random.normal(jk, shape))
        got = jr.normal(tk, shape).numpy()
        assert got.dtype == np.float32 and got.shape == shape
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


def test_erf_inv_at_the_ends_and_the_tails():
    lo = np.nextafter(np.float32(-1.0), np.float32(0.0))
    x = np.array([-1.0, lo, -0.999999, -0.5, 0.0, 1e-30, 0.3, 0.99999, 1.0], np.float32)
    got = jr.erf_inv(torch.from_numpy(x)).numpy()
    want = np.asarray(jax.lax.erf_inv(jnp.asarray(x)))
    assert np.isneginf(got[0]) and np.isposinf(got[-1])
    np.testing.assert_allclose(got[1:-1], want[1:-1], rtol=1e-6, atol=0)


def test_a_batch_of_keys_is_jax_vmap():
    """Keys (..., 2) act as ``jax.vmap`` of each function over the batch, as
    the train step draws the reseed candidates of many steps at once."""
    jk, tk = _key(1235)
    steps = np.arange(7, 12)
    jkeys = jax.vmap(lambda s: jax.random.fold_in(jax.random.fold_in(jk, s), 0x5EED))(steps)
    tkeys = jr.fold_in(jr.fold_in(tk, torch.from_numpy(steps)), 0x5EED)
    np.testing.assert_array_equal(tkeys.numpy(), np.asarray(jkeys))
    want = np.asarray(jax.vmap(lambda k: jax.random.split(k, 3))(jkeys))
    np.testing.assert_array_equal(jr.split(tkeys, 3).numpy(), want)
    for shape in [(0,), (5,), (3, 4)]:
        np.testing.assert_array_equal(
            jr.random_bits(tkeys, shape).numpy(),
            np.asarray(jax.vmap(lambda k: jax.random.bits(k, shape, jnp.uint32))(jkeys)).astype(np.int64))
        np.testing.assert_array_equal(
            jr.randint(jr.fold_in(tkeys, 1), shape, 0, 12345).numpy(),
            np.asarray(jax.vmap(lambda k: jax.random.randint(jax.random.fold_in(k, 1), shape, 0, 12345))(jkeys)))
        want = np.asarray(jax.vmap(lambda k: jax.random.uniform(k, shape, jnp.float32, -0.5, 0.5))(jkeys))
        np.testing.assert_array_equal(jr.uniform(tkeys, shape, -0.5, 0.5).numpy().view(np.int32), want.view(np.int32))
