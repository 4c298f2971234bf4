"""The port's training regularizers against the JAX package on the CPU: EMA
codebooks, usage and dead-code reseed, time jitter (both readings),
VQ-dropout and dropout in the residual GLU block, with the JAX package's
draws injected (``u``, ``start``, ``cand_idx``, the dropout masks: the same
``jax.random`` calls on the same keys); and the port's own draws held by
their distributions.

Tolerances: 1e-5 abs on f32 values (the EMA update, quantized codes,
losses, dropout outputs), 1e-5 relative on perplexity; indices, dead masks
and gathered (jittered) codes exactly equal. Distribution tests: a rate
within 5 standard errors of its probability.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _torch_port_util import nets, to_np  # noqa: E402
from wavenet_autoencoders_tpu.models import bottlenecks as jbn  # noqa: E402
from wavenet_autoencoders_tpu.ops import modules as jmod  # noqa: E402
from wavenet_autoencoders_tpu_torch.models import bottlenecks as bn  # noqa: E402
from wavenet_autoencoders_tpu_torch.ops import modules  # noqa: E402
from wavenet_autoencoders_tpu_torch.utils.params import load_jax_params  # noqa: E402

ATOL = 1e-5


def _rand(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("slices,K1", [(1, None), (2, None), (2, 4)], ids=["plain", "sliced", "sliced_K1"])
def test_vq_ema_apply_matches_jax(slices, K1):
    """Two training applications (the second from non-zero statistics),
    then one in eval mode: outputs and the updated state."""
    K, D = 8, 6
    jstate = jbn.vq_ema_init(jax.random.PRNGKey(0), K, D, num_slices=slices, K1=K1)
    port = bn.VQEMA(K, D, slices, K1)
    load_jax_params(port, {}, to_np(jstate))
    for i, train in enumerate((True, True, False)):
        z = _rand(10 + i, 3, 7, D)
        jq, jloss, jperp, jidx, jstate = jbn.vq_ema_apply(jstate, jnp.asarray(z), beta=0.3, decay=0.9, train=train)
        q, loss, perp, idx = bn.vq_ema_apply(port, _t(z), beta=0.3, decay=0.9, train=train)
        np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
        np.testing.assert_allclose(q.numpy(), np.asarray(jq), atol=ATOL)
        np.testing.assert_allclose(float(loss), float(jloss), atol=ATOL)
        np.testing.assert_allclose(float(perp), float(jperp), rtol=1e-5)
        for name in ("codebooks", "cluster_size", "ema_w"):
            for j, want in enumerate(jstate[name]):
                np.testing.assert_allclose(getattr(port, name)[j].numpy(), np.asarray(want), atol=ATOL,
                                           err_msg=f"step {i} {name}.{j}")


def test_vq_ema_gradient_reaches_only_the_encoder_side():
    """EMA codebooks get no gradient; the commit loss pulls z toward q."""
    port = bn.VQEMA(8, 4)
    z = _t(_rand(1, 2, 5, 4)).requires_grad_()
    q, loss, _, _ = bn.vq_ema_apply(port, z, train=True)
    (loss + q.sum()).backward()
    assert all(not b.requires_grad for b in port.buffers())
    want = 0.25 * 2 * (z.detach() - q.detach()) / z.numel() + 1.0
    np.testing.assert_allclose(z.grad.numpy(), want.numpy(), atol=ATOL)


@pytest.mark.parametrize("active", [True, False])
def test_update_usage_and_reseed_slice_match_jax(active):
    K, D, N = 8, 4, 30
    rng = np.random.default_rng(2)
    usage = rng.uniform(0, 2.0 / K, K).astype(np.float32)
    counts = rng.dirichlet(np.ones(K)).astype(np.float32)
    cb, z = _rand(3, K, D), _rand(4, N, D)
    key = jax.random.PRNGKey(7)
    ju = jbn.update_usage(jnp.asarray(usage), jnp.asarray(counts), 0.9)
    u = bn.update_usage(_t(usage), _t(counts), 0.9)
    np.testing.assert_allclose(u.numpy(), np.asarray(ju), atol=1e-7)
    jcb, ju2, jdead = jbn.reseed_slice(key, jnp.asarray(cb), ju, jnp.asarray(z), 0.9, jnp.bool_(active))
    cand = _t(jax.random.randint(key, (K,), 0, N))
    cb2, u2, dead = bn.reseed_slice(_t(cb), u, _t(z), 0.9, active, cand_idx=cand)
    np.testing.assert_array_equal(dead.numpy(), np.asarray(jdead))
    assert dead.any() == active
    np.testing.assert_array_equal(cb2.numpy(), np.asarray(jcb))
    np.testing.assert_allclose(u2.numpy(), np.asarray(ju2), atol=1e-7)


@pytest.mark.parametrize("per_side", [True, False], ids=["per_side", "chorowski"])
def test_time_jitter_matches_jax(per_side):
    z = _rand(5, 3, 40, 6)
    key = jax.random.PRNGKey(11)
    want = jbn.time_jitter(key, jnp.asarray(z), 0.2, per_side=per_side)
    u = _t(jax.random.uniform(key, (3, 40)))
    got = bn.time_jitter(_t(z), 0.2, per_side=per_side, u=u)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert not np.array_equal(got.numpy(), z)


@pytest.mark.parametrize("drop_dim", [0, 2, 5])
def test_vq_dropout_matches_jax(drop_dim):
    z = _rand(6, 4, 9, 6)
    key = jax.random.PRNGKey(13)
    want = np.asarray(jbn.vq_dropout(key, jnp.asarray(z), drop_dim))
    start = _t(jax.random.randint(key, (4, 1), 0, 6 - drop_dim + 1)) if drop_dim else None
    got = bn.vq_dropout(_t(z), drop_dim, start=start).numpy()
    np.testing.assert_array_equal(got == 0, want == 0)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


@pytest.mark.parametrize("dropout", [0.05, 0.5])
def test_residual_glu_dropout_matches_jax(dropout):
    jp = jmod.residual_glu_init(jax.random.PRNGKey(1), 8, 12, 3, skip_out_channels=7, cin_channels=5,
                                gin_channels=6)
    p = modules.ResidualGLU(8, 12, 3, skip_out_channels=7, cin_channels=5, gin_channels=6)
    load_jax_params(p, to_np(jp))
    x, c, g = _rand(1, 2, 13, 8), _rand(2, 2, 13, 5), _rand(3, 2, 6)
    key = jax.random.PRNGKey(17)
    jo, js = jmod.residual_glu_apply(jp, x, c, g, dilation=2, dropout=dropout, rng=key)
    mask = _t(jax.random.bernoulli(key, 1.0 - dropout, x.shape))
    o, s = modules.residual_glu_apply(p, _t(x), _t(c), _t(g), dilation=2, dropout=dropout, mask=mask)
    np.testing.assert_allclose(o.detach().numpy(), np.asarray(jo), atol=ATOL)
    np.testing.assert_allclose(s.detach().numpy(), np.asarray(js), atol=ATOL)
    o0, _ = modules.residual_glu_apply(p, _t(x), _t(c), _t(g), dilation=2)
    assert not np.allclose(o0.detach().numpy(), o.detach().numpy(), atol=1e-3)


def test_wavenet_draws_one_dropout_mask_per_layer_like_jax():
    """The unfused stack's dropout: the JAX forward splits its key once per
    layer; the port takes those masks, and a fused-stack net with dropout
    takes the unfused stack (the JAX rule), so it gives the same output."""
    jnet, params, net = nets(seed=2, dropout=0.1)
    B, T = 2, 24
    x = np.random.default_rng(0).integers(0, 256, (B, T)).astype(np.int32)
    c, g = _rand(1, B, T, 5), np.array([1, 3], np.int32)
    key = jax.random.PRNGKey(5)
    want = jnet.apply(params, jnp.asarray(x), jnp.asarray(c), jnp.asarray(g), rng=key, train=True)
    masks, rng = [], key
    for _ in range(jnet.layers):
        rng, sub = jax.random.split(rng)
        masks.append(_t(jax.random.bernoulli(sub, 0.9, (B, T, 8))))
    with torch.no_grad():
        got = net.apply(_t(x).long(), _t(c), _t(g), train=True, dropout_masks=masks)
        net.fused_stack = True
        fused = net.apply(_t(x).long(), _t(c), _t(g), train=True, dropout_masks=masks)
        plain = net.apply(_t(x).long(), _t(c), _t(g), train=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
    np.testing.assert_array_equal(fused.numpy(), got.numpy())
    np.testing.assert_allclose(plain.numpy(), np.asarray(jnet.apply(params, jnp.asarray(x), jnp.asarray(c),
                                                                    jnp.asarray(g))), atol=1e-4)


def test_dropout_without_noise_source_raises():
    p = modules.ResidualGLU(8, 12, 3)
    with pytest.raises(ValueError, match="Generator"):
        modules.residual_glu_apply(p, torch.zeros(1, 4, 8), dropout=0.1)


@pytest.mark.parametrize("p_drop", [0.05, 0.3])
def test_port_dropout_draws_keep_rate_and_scale(p_drop, monkeypatch):
    """The port's own masks: keep rate within 5 standard errors of 1 - p,
    kept values scaled by exactly 1/(1 - p) (a residual GLU with identity
    taps reads its dropped input back)."""
    n = 200_000
    x = torch.ones(1, n, 1)
    p = modules.ResidualGLU(1, 2, 1, skip_out_channels=1)
    seen = {}

    def conv(params, h, dilation=1, dtype=None):
        seen["h"] = h
        return torch.zeros(*h.shape[:2], 2)

    monkeypatch.setattr(modules, "causal_conv1d_apply", conv)
    modules.residual_glu_apply(p, x, dropout=p_drop, generator=torch.Generator().manual_seed(3))
    h = seen["h"].flatten()
    kept = h != 0
    rate = kept.float().mean().item()
    se = np.sqrt(p_drop * (1 - p_drop) / n)
    assert abs(rate - (1 - p_drop)) < 5 * se, (rate, se)
    np.testing.assert_allclose(h[kept].numpy(), 1.0 / (1 - p_drop), rtol=1e-6)


@pytest.mark.parametrize("per_side", [True, False], ids=["per_side", "chorowski"])
def test_port_time_jitter_draws_shift_at_the_rate(per_side):
    """Each frame moves with probability 2p (per side) or p (Chorowski), left
    and right equally often."""
    prob, B, T = 0.12, 64, 400
    z = torch.arange(T, dtype=torch.float32)[None, :, None].expand(B, T, 1).contiguous()
    out = bn.time_jitter(z, prob, per_side=per_side, generator=torch.Generator().manual_seed(1))
    shift = (out - z)[:, 1:-1, 0].flatten()
    n = shift.numel()
    total = 2 * prob if per_side else prob
    for rate, want in (((shift != 0).float().mean().item(), total),
                       ((shift < 0).float().mean().item(), total / 2)):
        assert abs(rate - want) < 5 * np.sqrt(want * (1 - want) / n), (rate, want)


def test_port_vq_dropout_draws_every_start_uniformly():
    D, drop, B = 8, 3, 20000
    z = torch.ones(B, 1, D)
    out = bn.vq_dropout(z, drop, generator=torch.Generator().manual_seed(2))[:, 0]
    zero = out == 0
    assert (zero.sum(1) == drop).all()
    starts = zero.float().argmax(1)
    freq = torch.bincount(starts, minlength=D - drop + 1).float() / B
    want = 1.0 / (D - drop + 1)
    assert (freq - want).abs().max() < 5 * np.sqrt(want * (1 - want) / B)
    np.testing.assert_allclose(out[~zero].numpy(), D / (D - drop))
