"""The port's ops, encoder and bottlenecks against the JAX package's, on the
same weights and inputs (made with numpy from a seed), in f32 on the CPU.

Tolerances: 1e-5 abs on convs, the GLU cell, the upsampler, the encoder
and the VQ outputs (f32, another summation order on the same CPU); VQ
indices must be equal.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _torch_port_util import to_np  # noqa: E402
from wavenet_autoencoders_tpu.models import bottlenecks as jbn  # noqa: E402
from wavenet_autoencoders_tpu.ops import conv as jconv  # noqa: E402
from wavenet_autoencoders_tpu.ops import modules as jmod  # noqa: E402
from wavenet_autoencoders_tpu.ops import upsample as jup  # noqa: E402
from wavenet_autoencoders_tpu_torch.models import bottlenecks as bn  # noqa: E402
from wavenet_autoencoders_tpu_torch.ops import conv, modules, upsample  # noqa: E402
from wavenet_autoencoders_tpu_torch.utils import jax_random as jr  # noqa: E402
from wavenet_autoencoders_tpu_torch.utils.params import load_jax_params  # noqa: E402

ATOL = 1e-5


def _rand(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _port(module, jparams):
    load_jax_params(module, to_np(jparams))
    return module


def _close(a, b, atol=ATOL):
    np.testing.assert_allclose(np.asarray(a.detach() if hasattr(a, "detach") else a), np.asarray(b), atol=atol)


@pytest.mark.parametrize(
    "padding,stride,dilation",
    [("SAME", 1, 1), ("VALID", 1, 1), ("CAUSAL", 1, 1), ([(2, 1)], 1, 1),
     ("SAME", 2, 1), ("CAUSAL", 1, 4), ("VALID", 2, 1)],
)
@pytest.mark.parametrize("weight_norm", [True, False])
def test_conv1d_matches_jax(padding, stride, dilation, weight_norm):
    key = jax.random.PRNGKey(0)
    if weight_norm:
        jp = jconv.conv1d_init(key, 4, 6, 3)
        p = _port(conv.WNConv1d(4, 6, 3, key=jr.PRNGKey(0)), jp)
    else:
        jp = jconv.plain_conv1d_init(key, 4, 6, 3)
        p = _port(conv.Conv1d(4, 6, 3, key=jr.PRNGKey(0)), jp)
    x = _rand(1, 2, 17, 4)
    want = jconv.conv1d_apply(jp, x, stride=stride, dilation=dilation, padding=padding)
    got = conv.conv1d_apply(p, torch.from_numpy(x), stride=stride, dilation=dilation, padding=padding)
    _close(got, want)


def test_linear_and_receptive_field_match_jax():
    jp = jconv.linear_init(jax.random.PRNGKey(2), 5, 3)
    p = _port(conv.Linear(5, 3, key=jr.PRNGKey(2)), jp)
    x = _rand(3, 4, 5)
    _close(conv.linear_apply(p, torch.from_numpy(x)), jconv.linear_apply(jp, x))
    assert conv.receptive_field_size(20, 2, 3) == jconv.receptive_field_size(20, 2, 3)


def _glu(seed=0, cin=5, gin=6):
    jp = jmod.residual_glu_init(jax.random.PRNGKey(seed), 8, 12, 3, skip_out_channels=7,
                                cin_channels=cin, gin_channels=gin)
    p = _port(modules.ResidualGLU(8, 12, 3, skip_out_channels=7, cin_channels=cin, gin_channels=gin,
                                   key=jr.PRNGKey(seed)), jp)
    return jp, p


@pytest.mark.parametrize("dilation", [1, 4])
def test_residual_glu_apply_matches_jax(dilation):
    jp, p = _glu()
    x, c, g = _rand(1, 2, 13, 8), _rand(2, 2, 13, 5), _rand(3, 2, 6)
    jo, js = jmod.residual_glu_apply(jp, x, c, g, dilation=dilation)
    o, s = modules.residual_glu_apply(p, *map(torch.from_numpy, (x, c, g)), dilation=dilation)
    _close(o, jo)
    _close(s, js)


def test_residual_glu_step_matches_jax():
    jp, p = _glu(seed=1)
    d, T = 2, 9
    xs, cs, g = _rand(4, T, 2, 8), _rand(5, T, 2, 5), _rand(6, 2, 6)
    jbuf = jnp.zeros((2, jmod.glu_buffer_len(3, d), 8))
    buf = torch.zeros(2, modules.glu_buffer_len(3, d), 8)
    for t in range(T):
        jo, js, jbuf = jmod.residual_glu_step(jp, xs[t], jbuf, jnp.int32(t), cs[t], g, dilation=d)
        o, s, buf = modules.residual_glu_step(
            p, torch.from_numpy(xs[t]), buf, t, torch.from_numpy(cs[t]), torch.from_numpy(g), dilation=d
        )
        _close(o, jo)
        _close(s, js)
        _close(buf, jbuf)


@pytest.mark.parametrize("cin_pad", [0, 1])
def test_conv_in_upsample_matches_jax(cin_pad):
    scales = (2, 3)
    jp = jup.conv_in_upsample_init(jax.random.PRNGKey(3), 4, cin_pad, scales)
    p = _port(upsample.ConvInUpsample(4, cin_pad, scales, key=jr.PRNGKey(3)), jp)
    c = _rand(7, 2, 6, 4)
    want = jup.conv_in_upsample_apply(jp, c, scales)
    got = upsample.conv_in_upsample_apply(p, torch.from_numpy(c), scales)
    assert got.shape == want.shape == (2, (6 - 2 * cin_pad) * 6, 4)
    _close(got, want)


def test_upsample_network_with_cin_pad_trim_matches_jax():
    scales = (2, 2)
    jp = jup.upsample_network_init(None, scales, 3)
    p = _port(upsample.UpsampleNetwork(scales, 3, key=jr.PRNGKey(0)), jp)
    # perturb the smoothing weights so the test is not of the constant init
    for i, cv in enumerate(p.convs):
        v = _rand(10 + i, *cv.v.shape)
        cv.v.data = torch.from_numpy(v)
        jp["convs"][i]["v"] = jnp.asarray(v)
    c = _rand(8, 2, 5, 4)
    _close(upsample.upsample_network_apply(p, torch.from_numpy(c), scales, 3, cin_pad=1),
           jup.upsample_network_apply(jp, c, scales, 3, cin_pad=1))


def test_instance_norm_and_adain_match_jax():
    z, s = _rand(9, 2, 11, 6), 3.0 * _rand(10, 2, 7, 6) + 1.0
    _close(bn.instance_norm(torch.from_numpy(z)), jbn.instance_norm(z))
    _close(bn.adain(torch.from_numpy(z), torch.from_numpy(s)), jbn.adain(z, s))


@pytest.mark.parametrize("K1", [None, 5])
def test_sliced_vq_matches_jax(K1):
    jp = jbn.sliced_vq_init(jax.random.PRNGKey(4), 8, 6, num_slices=2, K1=K1)
    p = _port(bn.SlicedVQ(8, 6, 2, K1, key=jr.PRNGKey(4)), jp)
    z = 0.1 * _rand(11, 2, 9, 6)
    jq, jl, jperp, jidx = jbn.sliced_vq_apply(jp, z, beta=0.25, commit_scale=0.5)
    q, l, perp, idx = bn.sliced_vq_apply(p, torch.from_numpy(z), beta=0.25, commit_scale=0.5)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    _close(q, jq)
    _close(l, jl)
    _close(perp, jperp, atol=1e-4)


def test_vq_matches_jax():
    jp = jbn.vq_init(jax.random.PRNGKey(5), 8, 4)
    p = _port(bn.VQ(8, 4, key=jr.PRNGKey(5)), jp)
    z = 0.1 * _rand(12, 3, 7, 4)
    jq, jl, jperp, jidx = jbn.vq_apply(jp, z, beta=0.3)
    q, l, perp, idx = bn.vq_apply(p, torch.from_numpy(z), beta=0.3)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    _close(q, jq)
    _close(l, jl)
    _close(perp, jperp, atol=1e-4)


def test_vq_straight_through_gradient():
    p = bn.VQ(8, 4, key=jr.PRNGKey(0))
    z = torch.from_numpy(0.1 * _rand(13, 2, 5, 4)).requires_grad_()
    q, *_ = bn.vq_apply(p, z)
    q.sum().backward()
    np.testing.assert_array_equal(z.grad.numpy(), np.ones_like(z.grad.numpy()))


@pytest.mark.parametrize("downsample", [1, 4])
def test_encoder_matches_jax(downsample):
    from wavenet_autoencoders_tpu.models.encoder import Encoder as JEncoder
    from wavenet_autoencoders_tpu_torch.models.encoder import Encoder

    jenc = JEncoder(c_in=7, hid=12, c_out=5, downsample=downsample)
    jp = jenc.init(jax.random.PRNGKey(6))
    enc = _port(Encoder(c_in=7, hid=12, c_out=5, downsample=downsample, key=jr.PRNGKey(6)), jp)
    x = _rand(14, 2, 24, 7)
    got = enc.apply(torch.from_numpy(x))
    assert got.shape == (2, 24 // downsample, 5)
    _close(got, jenc.apply(jp, x))


def test_inv_mulaw_and_inv_preemphasis_match_jax():
    from wavenet_autoencoders_tpu import dsp as jdsp
    from wavenet_autoencoders_tpu_torch import dsp

    codes = np.random.default_rng(15).integers(0, 256, 400)
    np.testing.assert_allclose(dsp.inv_mulaw_quantize(codes, 255), jdsp.inv_mulaw_quantize(codes, 255), atol=1e-6)
    assert dsp.inv_mulaw_quantize(127, 255) == jdsp.inv_mulaw_quantize(127, 255)
    y = _rand(16, 300)
    np.testing.assert_allclose(dsp.inv_mulaw(y / 4, 255), jdsp.inv_mulaw(y / 4, 255), atol=1e-6)
    np.testing.assert_allclose(dsp.inv_preemphasis(y, 0.85), jdsp.inv_preemphasis(y, 0.85), atol=1e-6)


@pytest.mark.parametrize("dist", ["Logistic", "Normal"])
def test_mixture_samplers_follow_a_pinned_mixture(dist):
    from wavenet_autoencoders_tpu_torch.ops import mixture

    M = 4
    y = torch.zeros(3, 50, 3 * M)
    y[..., :M] = torch.tensor([0.0, 9.0, 0.0, 0.0])  # mixture 1 dominates
    y[..., M : 2 * M] = torch.tensor([-0.9, 0.25, 0.9, 0.0])
    y[..., 2 * M :] = -12.0
    f = mixture.sample_from_discretized_mix_logistic if dist == "Logistic" else mixture.sample_from_mix_gaussian
    x = f(y, jr.PRNGKey(0))
    assert x.shape == (3, 50)
    assert (x - 0.25).abs().max() < 1e-3
