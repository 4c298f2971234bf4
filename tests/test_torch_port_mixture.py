"""The MoL / MoG losses of the scalar-input path against the JAX package on
the CPU: values and gradients with respect to the mixture parameters at
1e-4. The targets cover both edge bins (y = ±1, which the losses treat by
the left / right CDF alone), the mid-bin fallback (a narrow component whose
CDF difference underflows 1e-5), clamped log scales, and a masked tail.

With 65536 classes (the vocoder_raw preset) a bin is 3e-5 wide, so its CDF
difference is the difference of two sigmoids near equal: where it is just
above the 1e-5 fallback threshold, one ulp between the two frameworks'
f32 sigmoids becomes ~1e-2 relative in that element's gradient. That case
is compared in f64 (both packages), and in f32 only its loss value.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from wavenet_autoencoders_tpu.ops import losses as jlosses  # noqa: E402
from wavenet_autoencoders_tpu.ops import mixture as jmixture  # noqa: E402
from wavenet_autoencoders_tpu_torch.ops import losses, mixture  # noqa: E402

B, T, M = 2, 24, 10


def inputs(seed, C=3 * M):
    """Mixture parameters and targets in [-1, 1] with both edges, a
    component far narrower than a bin and log scales below the clamp."""
    rng = np.random.default_rng(seed)
    y_hat = rng.standard_normal((B, T, C)).astype(np.float32)
    y = rng.uniform(-1.0, 1.0, (B, T, 1)).astype(np.float32)
    y[0, :3, 0] = (-1.0, 1.0, 0.9995)
    y[1, :2, 0] = (-0.9995, 1.0)
    if C > 2:
        nr = C // 3
        y_hat[:, :, 2 * nr :] -= 3.0  # narrow components
        y_hat[0, 5, 2 * nr :] = -20.0  # below every clamp used here
        y_hat[0, 5, nr : 2 * nr] = y[0, 5, 0] + 0.3 / 65535  # inside one bin, CDF difference underflows
    mask = (np.arange(T)[None, :] < np.array([[T], [T - 7]])).astype(np.float32)
    return y_hat, y, mask


def grad_both(jfn, tfn, y_hat, *args):
    """(value, d value / d y_hat) of the JAX and the port function."""
    jv, jg = jax.value_and_grad(lambda a: jfn(a, *[jnp.asarray(x) for x in args]))(jnp.asarray(y_hat))
    t = torch.from_numpy(y_hat).requires_grad_(True)
    tv = tfn(t, *[torch.from_numpy(x) for x in args])
    tv.backward()
    return (float(jv), np.asarray(jg)), (float(tv), t.grad.numpy())


def close(jax_out, port_out):
    (jv, jg), (tv, tg) = jax_out, port_out
    assert np.isfinite(tv) and np.isfinite(tg).all()
    np.testing.assert_allclose(tv, jv, rtol=1e-4)
    np.testing.assert_allclose(tg, jg, atol=1e-4 * max(1.0, np.abs(jg).max()), rtol=0)


def test_mol_loss_and_gradient_match_jax_256_classes():
    y_hat, y, _ = inputs(0)
    close(*grad_both(
        lambda a, b: jmixture.discretized_mix_logistic_loss(a, b, 256, -7.0),
        lambda a, b: mixture.discretized_mix_logistic_loss(a, b, 256, -7.0),
        y_hat, y))


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_mol_loss_and_gradient_match_jax_65536_classes(dtype):
    y_hat, y, _ = inputs(0)
    with jax.enable_x64(dtype == np.float64):
        jax_out, port_out = grad_both(
            lambda a, b: jmixture.discretized_mix_logistic_loss(a, b, 65536, -16.0),
            lambda a, b: mixture.discretized_mix_logistic_loss(a, b, 65536, -16.0),
            y_hat.astype(dtype), y.astype(dtype))
    if dtype == np.float64:
        close(jax_out, port_out)
    else:
        np.testing.assert_allclose(port_out[0], jax_out[0], rtol=1e-4)


def test_mol_loss_unreduced_matches_jax():
    y_hat, y, _ = inputs(1)
    want = jmixture.discretized_mix_logistic_loss(jnp.asarray(y_hat), jnp.asarray(y), 65536, -16.0, reduce=False)
    got = mixture.discretized_mix_logistic_loss(torch.from_numpy(y_hat), torch.from_numpy(y), 65536, -16.0,
                                                reduce=False)
    assert got.shape == (B, T, 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=1e-5)


def test_mol_mid_bin_fallback_is_taken_and_matches_jax():
    """Where the bin's CDF difference is below 1e-5 the loss uses the
    density at the bin's centre; the narrow component at (0, 5) lands there."""
    y_hat, y, _ = inputs(2)
    sl = (slice(0, 1), slice(5, 6))
    a, b = y_hat[sl], y[sl]
    want = jmixture.discretized_mix_logistic_loss(jnp.asarray(a), jnp.asarray(b), 65536, -16.0)
    got = mixture.discretized_mix_logistic_loss(torch.from_numpy(a), torch.from_numpy(b), 65536, -16.0)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    # the fallback differs from log(max(cdf_delta, 1e-12)), which would be -log(1e-12) - ...
    assert float(got) < -np.log(1e-12) - 10.0


@pytest.mark.parametrize("C", [3 * M, 2], ids=["mixture", "single"])
def test_mog_loss_and_gradient_match_jax(C):
    y_hat, y, _ = inputs(3, C)
    close(*grad_both(
        lambda a, b: jmixture.mix_gaussian_loss(a, b, -7.0),
        lambda a, b: mixture.mix_gaussian_loss(a, b, -7.0),
        y_hat, y))


def test_log_sum_exp_matches_jax():
    x = np.random.default_rng(4).standard_normal((3, 5, 7)).astype(np.float32) * 30
    np.testing.assert_allclose(mixture.log_sum_exp(torch.from_numpy(x)).numpy(),
                               np.asarray(jmixture.log_sum_exp(jnp.asarray(x))), rtol=1e-6)


def test_masked_mol_loss_and_gradient_match_jax():
    y_hat, y, mask = inputs(5)
    close(*grad_both(
        lambda a, b, m: jlosses.masked_mol_loss(a, b, m, 65536, -16.0),
        lambda a, b, m: losses.masked_mol_loss(a, b, m, 65536, -16.0),
        y_hat, y, mask))


@pytest.mark.parametrize("C", [3 * M, 2], ids=["mixture", "single"])
def test_masked_mog_loss_and_gradient_match_jax(C):
    y_hat, y, mask = inputs(6, C)
    close(*grad_both(
        lambda a, b, m: jlosses.masked_mog_loss(a, b, m, -7.0),
        lambda a, b, m: losses.masked_mog_loss(a, b, m, -7.0),
        y_hat, y, mask[..., None]))


def test_masked_tail_gets_no_gradient():
    y_hat, y, mask = inputs(7)
    t = torch.from_numpy(y_hat).requires_grad_(True)
    losses.masked_mol_loss(t, torch.from_numpy(y), torch.from_numpy(mask), 65536, -16.0).backward()
    assert float(t.grad[1, T - 7 :].abs().max()) == 0.0
    assert float(t.grad[1, : T - 7].abs().max()) > 0.0
