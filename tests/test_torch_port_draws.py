"""The port's own draws against the JAX package's, stream by stream, on the
CPU: each stochastic function of the port draws from a JAX key
(``utils.jax_random``, the plain version of the threefry kernel) through
the splits of its JAX counterpart, with the same distribution call, and
gives the JAX function's result from the same key and the same numpy
inputs.

Held bit for bit: every draw (bits, uniforms, Bernoulli masks, integers)
and whatever is computed from it without a transcendental function: the
VQ-dropout and time-jitter outputs, the dropped-out input of a residual
GLU block, the Gumbel and mixture picks, the mu-law samples (one-hot),
the teacher-forced decode's samples. Held within 1e-6 relative: the
normals and the MoG samples (XLA's f32 ``log1p`` in ``erf_inv``, as
``tests/test_torch_port_init_draw.py`` holds ``normal``), and the values
that pass through ``log``, ``exp`` or ``softmax`` after the draw (the
Gumbel-softmax codes, the MoL samples, 1e-6 abs on samples in [-1, 1]):
XLA's f32 ``log`` is not torch's, 14 % of 2M uniforms in [0, 1) differ in
the last bit (measured on the CPU, numpy inputs), so no float that
passes through one can be held bit for bit. The residual block's outputs
(convolutions) are held at ``tests/test_torch_port_regularizers.py``'s
1e-5.

Also held here: the key reuse of the JAX package's VQWAE forward (the time
jitter and the decoder's first dropout layer draw from one key), mirrored;
and a draw of rows of a shape, equal to that slice of the whole draw, at
counters above 2³².
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax._src import prng as jprng  # noqa: E402

from _torch_port_util import models, nets, to_np  # noqa: E402
from wavenet_autoencoders_tpu.models import bottlenecks as jbn  # noqa: E402
from wavenet_autoencoders_tpu.ops import mixture as jmix  # noqa: E402
from wavenet_autoencoders_tpu.ops import modules as jmod  # noqa: E402
from wavenet_autoencoders_tpu_torch.models import bottlenecks as bn  # noqa: E402
from wavenet_autoencoders_tpu_torch.ops import mixture as mix  # noqa: E402
from wavenet_autoencoders_tpu_torch.ops import modules  # noqa: E402
from wavenet_autoencoders_tpu_torch.utils import jax_random as jr  # noqa: E402
from wavenet_autoencoders_tpu_torch.utils.params import load_jax_params  # noqa: E402

ATOL = 1e-5
KEYS = (0, 7, 2**31 + 5)


def _rand(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _keys(seed):
    return jax.random.PRNGKey(seed), jr.PRNGKey(seed)


@pytest.mark.parametrize("seed", KEYS)
@pytest.mark.parametrize("drop_dim", [2, 5])
def test_vq_dropout_draws_jax_start(seed, drop_dim):
    z = _rand(6, 5, 9, 6)
    jkey, key = _keys(seed)
    want = np.asarray(jbn.vq_dropout(jkey, jnp.asarray(z), drop_dim))
    got = bn.vq_dropout(_t(z), drop_dim, key=key).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("gated", [False, True], ids=["prob", "f32_gate"])
@pytest.mark.parametrize("per_side", [True, False], ids=["per_side", "chorowski"])
def test_time_jitter_draws_jax_uniforms(per_side, gated):
    """prob 0.12, or as JAX's train step gates it (``time_jitter_start``:
    prob times an f32 gate, in f32)."""
    z = _rand(5, 3, 60, 6)
    for seed in KEYS:
        jkey, key = _keys(seed)
        jprob = jnp.float32(0.12) * jnp.float32(1.0) if gated else 0.12
        prob = np.float32(0.12) * np.float32(1.0) if gated else 0.12
        want = np.asarray(jbn.time_jitter(jkey, jnp.asarray(z), jprob, per_side=per_side))
        got = bn.time_jitter(_t(z), prob, per_side=per_side, key=key).numpy()
        np.testing.assert_array_equal(got, want)
        assert not np.array_equal(got, z)


def test_time_jitter_thresholds_follow_jax_arithmetic():
    """1 − p is computed in float64 for a Python prob and in f32 for the
    gated one, where the two roundings differ."""
    for prob in (0.12, 0.1, 0.37, 0.021):
        for per_side in (True, False):
            lo, hi = bn._jitter_bounds(prob, per_side)
            p = prob if per_side else prob / 2.0
            assert (lo, hi) == (float(jnp.float32(p)), float(jnp.asarray(1.0 - p, jnp.float32)))
            p32 = jnp.float32(prob) * jnp.float32(1.0)
            p32 = p32 if per_side else p32 / 2.0
            assert bn._jitter_bounds(np.float32(prob) * np.float32(1.0), per_side) == (float(p32), float(1.0 - p32))


@pytest.mark.parametrize("seed", KEYS)
@pytest.mark.parametrize("dropout", [0.05, 0.5])
def test_residual_glu_dropout_draws_jax_mask(seed, dropout, monkeypatch):
    """The mask is ``bernoulli(key, 1 − dropout, x.shape)``; the conv input
    x·mask/keep equals JAX's bit for bit (both packages' conv inputs
    captured), the block's outputs within 1e-5."""
    jp = jmod.residual_glu_init(jax.random.PRNGKey(1), 8, 12, 3, skip_out_channels=7, cin_channels=5,
                                gin_channels=6)
    p = modules.ResidualGLU(8, 12, 3, skip_out_channels=7, cin_channels=5, gin_channels=6, key=jr.PRNGKey(1))
    load_jax_params(p, to_np(jp))
    x, c, g = _rand(1, 3, 13, 8), _rand(2, 3, 13, 5), _rand(3, 3, 6)
    jkey, key = _keys(seed)
    np.testing.assert_array_equal(jr.bernoulli(key, 1.0 - dropout, x.shape).numpy(),
                                  np.asarray(jax.random.bernoulli(jkey, 1.0 - dropout, x.shape)))
    seen = {}
    jconv, conv = jmod.causal_conv1d_apply, modules.causal_conv1d_apply
    monkeypatch.setattr(jmod, "causal_conv1d_apply", lambda pr, h, **kw: seen.setdefault("jax", h) is h
                        and jconv(pr, h, **kw))
    monkeypatch.setattr(modules, "causal_conv1d_apply", lambda pr, h, **kw: seen.setdefault("port", h) is h
                        and conv(pr, h, **kw))
    jo, js = jmod.residual_glu_apply(jp, x, c, g, dilation=2, dropout=dropout, rng=jkey)
    o, s = modules.residual_glu_apply(p, _t(x), _t(c), _t(g), dilation=2, dropout=dropout, key=key)
    np.testing.assert_array_equal(seen["port"].detach().numpy(), np.asarray(seen["jax"]))
    assert (seen["port"] == 0).any()
    np.testing.assert_allclose(o.detach().numpy(), np.asarray(jo), atol=ATOL)
    np.testing.assert_allclose(s.detach().numpy(), np.asarray(js), atol=ATOL)


@pytest.mark.parametrize("hard", [False, True])
def test_gumbel_apply_draws_jax_uniforms(hard):
    """Per slice ``key, sk = split(key)`` and ``uniform(sk, (B, T, k),
    1e-10, 1)``: the picks equal JAX's, the codes within 1e-6."""
    D, k, slices = 8, 6, 2
    jparams = jbn.gumbel_init(jax.random.PRNGKey(3), D, k, slices)
    p = bn.Gumbel(D, k, slices, key=jr.PRNGKey(3))
    load_jax_params(p, to_np(jparams))
    z = _rand(4, 3, 11, D)
    for seed in KEYS:
        jkey, key = _keys(seed)
        jq, _, jperp, jidx = jbn.gumbel_apply(jparams, jnp.asarray(z), jkey, tau=0.5, hard=hard, train=True)
        with torch.no_grad():
            q, _, perp, idx = bn.gumbel_apply(p, _t(z), tau=0.5, hard=hard, train=True, key=key)
        np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
        np.testing.assert_allclose(q.numpy(), np.asarray(jq), rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(float(perp), float(jperp), rtol=1e-6)


def test_mulaw_sample_output_is_jax_categorical():
    """``categorical(key, log(max(probs, 1e-12)))`` on (B, 256) logits: the
    same one-hot samples, over many keys."""
    jnet, _, net = nets(seed=2)
    logits = _rand(9, 16, 256) * 3.0
    hits = 0
    for seed in range(24):
        jkey, key = _keys(seed)
        want = np.asarray(jnet.sample_output(jkey, jnp.asarray(logits)))
        got = net.sample_output(_t(logits), key).numpy()
        np.testing.assert_array_equal(got, want, err_msg=f"key {seed}")
        hits += int((got.argmax(-1) != logits.argmax(-1)).any())
    assert hits > 0  # the samples are draws, not the argmax


@pytest.mark.parametrize("dist,C", [("Logistic", 30), ("Normal", 30), ("Normal", 2)],
                         ids=["mol", "mog", "one_gaussian"])
def test_mixture_samplers_draw_jax_noise(dist, C):
    """``k1, k2 = split(key)``; the mixture pick by Gumbel-max over
    ``uniform(k1, ·, 1e-5, 1 − 1e-5)``, then ``uniform(k2, …)`` (MoL) or
    ``normal(k2, ·)`` (MoG): the picks equal JAX's, the samples within 1e-6
    (log, exp, erf_inv after the draw)."""
    y = _rand(8, 3, 40, C) * 2.0
    jf, f = ((jmix.sample_from_discretized_mix_logistic, mix.sample_from_discretized_mix_logistic)
             if dist == "Logistic" else (jmix.sample_from_mix_gaussian, mix.sample_from_mix_gaussian))
    for seed in KEYS:
        jkey, key = _keys(seed)
        want = np.asarray(jf(jkey, jnp.asarray(y), log_scale_min=-9.0))
        got = f(_t(y), key, log_scale_min=-9.0).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
        assert np.abs(got).max() > 0.1
        if C > 2:  # the pick: the same draw of k1, the same mixture component
            M = C // 3
            u = jax.random.uniform(jax.random.split(jkey)[0], (3, 40, M), minval=1e-5, maxval=1.0 - 1e-5)
            pick = np.asarray(jnp.argmax(jnp.asarray(y[..., :M]) - jnp.log(-jnp.log(u)), axis=-1))
            means, _ = mix._pick(_t(y), M, jr.split(key)[0])
            np.testing.assert_array_equal(means.numpy(), np.take_along_axis(y[..., M:2 * M], pick[..., None], -1)[..., 0])


@pytest.mark.parametrize("scalar", [False, True], ids=["mulaw", "mol"])
def test_teacher_forced_decode_draws_jax_samples(scalar):
    """``WaveNet.decode`` fed the same history (teacher mode) splits its key
    once a step and samples as JAX's ``decode``: mu-law samples bit for bit,
    MoL samples within 1e-6."""
    kw = dict(out_channels=30, scalar_input=True) if scalar else {}
    jnet, params, net = nets(seed=4, **kw)
    rng = np.random.default_rng(3)
    B, T = 2, 24
    c, g = rng.standard_normal((B, T, 5)).astype(np.float32), np.array([1, 3], np.int32)
    if scalar:
        teach = rng.uniform(-1, 1, (B, T, 1)).astype(np.float32)
    else:
        teach = np.eye(256, dtype=np.float32)[rng.integers(0, 256, (B, T))]
    jkey, key = _keys(11)
    want = np.asarray(jnet.decode(params, jkey, T, c=jnp.asarray(c), g=jnp.asarray(g),
                                  test_inputs=jnp.asarray(teach), log_scale_min=-9.0))
    got = net.decode(T, c=_t(c), g=_t(g), test_inputs=_t(teach), key=key, log_scale_min=-9.0).numpy()
    if scalar:
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    else:
        np.testing.assert_array_equal(got, want)
        assert len(np.unique(got.argmax(-1))) > 4


def test_wavenet_apply_draws_one_dropout_mask_per_layer_from_its_key(monkeypatch):
    """``apply(train=True, key=k)``: one ``split`` a layer, its mask
    ``bernoulli(sub, 1 − dropout, (B, T, residual))``, as JAX's apply: the
    masks the port draws equal JAX's bit for bit, and its output JAX's
    within 1e-4 (tests/test_torch_port_wavenet.py's bound)."""
    jnet, params, net = nets(seed=2, dropout=0.1)
    B, T = 2, 24
    x = np.random.default_rng(0).integers(0, 256, (B, T)).astype(np.int32)
    c, g = _rand(1, B, T, 5), np.array([1, 3], np.int32)
    jkey, key = _keys(5)
    want = jnet.apply(params, jnp.asarray(x), jnp.asarray(c), jnp.asarray(g), rng=jkey, train=True)
    masks, rng = [], jkey
    for _ in range(jnet.layers):
        rng, sub = jax.random.split(rng)
        masks.append(np.asarray(jax.random.bernoulli(sub, 0.9, (B, T, 8))))
    drawn = []
    _spy(monkeypatch, jr, "bernoulli", None, drawn)
    with torch.no_grad():
        got = net.apply(_t(x).long(), _t(c), _t(g), train=True, key=key)
    assert len(drawn) == len(masks)
    for i, (mask, want_mask) in enumerate(zip(drawn, masks)):
        np.testing.assert_array_equal(mask, want_mask, err_msg=f"layer {i}")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


def _spy(monkeypatch, module, name, arg, store):
    """Record the key argument ``arg`` (or the first positional one) of
    ``module.name`` on each call, or with ``arg`` None what it returns."""
    fn = getattr(module, name)

    def spy(*a, **kw):
        out = fn(*a, **kw)
        store.append(np.asarray(out if arg is None else kw[arg] if arg in kw else a[0]))
        return out

    monkeypatch.setattr(module, name, spy)


def test_vqwae_forward_reuses_the_jitter_key_for_the_first_dropout_layer(monkeypatch):
    """JAX's ``_post_vq`` draws the jitter from ``split(rng)[1]`` of a local
    copy, and the decoder's first dropout split is ``split(rng)[1]`` of the
    same key: the jitter's uniforms and layer 0's mask come from one key.
    The port mirrors it: with VQ-dropout, jitter and dropout on, the keys
    each package hands to VQ-dropout, the jitter and every dropout layer are
    the same, and the reuse holds in both."""
    import dataclasses

    import wavenet_autoencoders_tpu.models.wavenet as jwn
    import wavenet_autoencoders_tpu_torch.models.wavenet as wn

    _, jmodel, params, state, _, model = models(seed=1)
    over = dict(use_time_jitter=True, time_jitter_prob=0.2, vq_drop=True, drop_dim=2)
    jmodel = dataclasses.replace(jmodel, **over, wavenet=dataclasses.replace(jmodel.wavenet, dropout=0.1))
    for k, v in over.items():
        setattr(model, k, v)
    model.wavenet.dropout = 0.1
    rng = np.random.default_rng(2)
    B, T = 2, 32
    x = rng.integers(0, 32, (B, T)).astype(np.int32)
    c = rng.standard_normal((B, T, 39)).astype(np.float32)  # 4x down, 4x up
    g = np.array([1, 5], np.int32)
    jkeys, keys = {"drop": [], "jitter": [], "layers": []}, {"drop": [], "jitter": [], "layers": []}
    for store, mods, arg in ((jkeys, (jbn, jbn, jwn), "rng"), (keys, (bn, bn, wn), "key")):
        for name, mod, fn in zip(store, mods, ("vq_dropout", "time_jitter", "residual_glu_apply")):
            _spy(monkeypatch, mod, fn, arg, store[name])
    jkey, key = _keys(9)
    jy, _, _, _ = jmodel.forward(params, state, jkey, jnp.asarray(x), jnp.asarray(c), jnp.asarray(g), train=True)
    with torch.no_grad():
        y, _, _ = model.forward(_t(x).long(), _t(c), _t(g), train=True, key=key)
    assert [len(v) for v in keys.values()] == [len(v) for v in jkeys.values()] == [1, 1, 4]
    for name in jkeys:
        for got, want in zip(keys[name], jkeys[name]):
            np.testing.assert_array_equal(got, want.astype(np.int64), err_msg=name)
    for store in (keys, jkeys):
        np.testing.assert_array_equal(store["jitter"][0], store["layers"][0])
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=1e-4)


def test_a_row_range_is_the_slice_of_the_whole_draw():
    """Rows [r0, r1) of a draw alone equal those rows of the whole draw,
    and JAX's, for every draw function."""
    jkey, key = _keys(21)
    shape, rows = (7, 5, 3), (2, 5)
    sl = slice(*rows)
    np.testing.assert_array_equal(jr.random_bits(key, shape, rows).numpy(),
                                  np.asarray(jax.random.bits(jkey, shape))[sl])
    np.testing.assert_array_equal(jr.uniform(key, shape, -1.0, 2.0, rows).numpy(),
                                  np.asarray(jax.random.uniform(jkey, shape, minval=-1.0, maxval=2.0))[sl])
    np.testing.assert_array_equal(jr.bernoulli(key, 0.3, shape, rows).numpy(),
                                  np.asarray(jax.random.bernoulli(jkey, 0.3, shape))[sl])
    np.testing.assert_array_equal(jr.randint(key, shape, 0, 9, rows).numpy(),
                                  np.asarray(jax.random.randint(jkey, shape, 0, 9))[sl])
    np.testing.assert_array_equal(jr.normal(key, shape, rows).numpy(), jr.normal(key, shape).numpy()[sl])
    for bad in ((3, 2), (0, 8)):
        with pytest.raises(ValueError, match="not rows"):
            jr.uniform(key, shape, rows=bad)


def test_a_row_range_above_2_to_the_32_counts_from_its_flat_index():
    """A draw of (2²⁰ + 3, 2¹² + 1) holds more than 2³² elements; its last
    rows are counters past 2³², hashed as their (hi, lo) words: the port's
    rows equal JAX's threefry of those counters, and the uniforms their
    map."""
    jkey, key = _keys(4)
    shape = (2**20 + 3, 2**12 + 1)
    r0 = shape[0] - 2
    first = r0 * shape[1]
    assert first > 2**32
    idx = np.arange(first, first + 2 * shape[1], dtype=np.uint64)
    hi, lo = (idx >> np.uint64(32)).astype(np.uint32), (idx & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    k = np.asarray(jkey, np.uint32)
    y0, y1 = jprng.threefry2x32_p.bind(jnp.uint32(k[0]), jnp.uint32(k[1]), jnp.asarray(hi), jnp.asarray(lo))
    want = (np.asarray(y0) ^ np.asarray(y1)).reshape(2, shape[1])
    got = jr.random_bits(key, shape, rows=(r0, shape[0]))
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
    u = jr.uniform(key, shape, rows=(r0, shape[0])).numpy()
    np.testing.assert_array_equal(u, ((want >> 9) | 0x3F800000).view(np.float32) - np.float32(1.0))


def test_kernel_seed_is_jax_randint():
    """K1's seed: ``randint(key, (), 0, 2³¹ − 1)`` read to the host, as the
    JAX package's ``decode_pallas`` draws it."""
    from wavenet_autoencoders_tpu_torch.eval.synthesize import kernel_seed

    for seed in (0, 1, 1234, 2**32 - 1):
        jkey, key = _keys(seed)
        assert kernel_seed(key) == int(jax.random.randint(jkey, (), 0, 2**31 - 1))
    sub = jr.split(jr.PRNGKey(3))[1]
    assert kernel_seed(sub) == int(jax.random.randint(jax.random.split(jax.random.PRNGKey(3))[1], (), 0, 2**31 - 1))
