"""The port's WaveNet against the JAX package's on the same weights, and the
port's plain AR decode against its own teacher-forced forward.

Tolerances: 1e-4 abs on logits vs JAX (f32 on the CPU; the JAX package's
own batch-vs-step tolerance is 2e-4); 2e-4 for the port's step path vs its
batch forward, as in tests/test_wavenet.py.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from _torch_port_util import nets  # noqa: E402
from wavenet_autoencoders_tpu_torch.models.wavenet import fold_weight_norm  # noqa: E402


def _inputs(net_kw, B=2, T=20, seed=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, 256, (B, T)).astype(np.int32)
    c = rng.standard_normal((B, T, 5)).astype(np.float32)
    g = np.array([1, 3], np.int32)[:B]
    xs = rng.uniform(-1, 1, (B, T, 1)).astype(np.float32)
    return ids, c, g, xs


CASES = {
    "mulaw_onehot": dict(),
    "scalar_mol": dict(out_channels=30, scalar_input=True),
    "no_conditioning": dict(cin_channels=-1, gin_channels=-1, use_speaker_embedding=False),
    "upsampled": dict(upsample_conditional_features=True, upsample_scales=(2, 2)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_apply_logits_match_jax(case):
    kw = CASES[case]
    jnet, params, net = nets(seed=1, **kw)
    ids, c, g, xs = _inputs(kw)
    T = ids.shape[1]
    if kw.get("upsample_conditional_features"):
        c = c[:, : T // 4]
    if kw.get("cin_channels", 5) < 0:
        c, g = None, None
    if kw.get("scalar_input"):
        jx, x = xs, torch.from_numpy(xs)
    else:
        jx, x = jax.nn.one_hot(ids, 256), F.one_hot(torch.from_numpy(ids).long(), 256).float()
    t = (lambda a: None if a is None else torch.from_numpy(a))
    want = jnet.apply(params, jx, c, None if g is None else jnp.asarray(g))
    with torch.no_grad():
        got = net.apply(x, t(c), t(g))
    assert got.shape == (2, T, net.out_channels)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


def test_integer_code_path_matches_jax_and_one_hot():
    jnet, params, net = nets(seed=2)
    ids, c, g, _ = _inputs({})
    want = jnet.apply(params, jnp.asarray(ids), c, jnp.asarray(g), upsampled=True)
    with torch.no_grad():
        got = net.apply(torch.from_numpy(ids), torch.from_numpy(c), torch.from_numpy(g), upsampled=True)
        onehot = net.apply(F.one_hot(torch.from_numpy(ids).long(), 256).float(),
                           torch.from_numpy(c), torch.from_numpy(g), upsampled=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
    np.testing.assert_allclose(got.numpy(), onehot.numpy(), atol=1e-5)


@pytest.mark.parametrize("scalar", [False, True])
def test_plain_decode_with_test_inputs_equals_apply(scalar):
    kw = dict(out_channels=30, scalar_input=True) if scalar else {}
    _, _, net = nets(seed=3, **kw)
    ids, c, g, xs = _inputs(kw, T=24)
    x = torch.from_numpy(xs) if scalar else F.one_hot(torch.from_numpy(ids).long(), 256).float()
    c, g = torch.from_numpy(c), torch.from_numpy(g)
    with torch.no_grad():
        want = net.apply(x, c, g, upsampled=True)
        got = net.decode(24, c=c, g=g, test_inputs=x, upsampled=True, softmax=False, quantize=False) \
            if not scalar else None
        # step path (the decode loop's body) captures raw logits for both families
        bufs = net.init_buffers(2)
        g_feat = net._global_features(g)
        steps = []
        for t in range(24):
            lg, bufs = net.step(x[:, t], bufs, t, c[:, t], g_feat)
            steps.append(lg)
    np.testing.assert_allclose(torch.stack(steps, 1).numpy(), want.numpy(), atol=2e-4)
    if got is not None:
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=2e-4)


@pytest.mark.parametrize("scalar", [False, True])
def test_free_running_decode_shapes_range_and_seed(scalar):
    kw = dict(out_channels=30, scalar_input=True) if scalar else {}
    _, _, net = nets(seed=4, **kw)
    _, c, g, _ = _inputs(kw, T=12)

    def run(seed):
        gen = torch.Generator().manual_seed(seed)
        return net.decode(12, c=torch.from_numpy(c), g=torch.from_numpy(g), generator=gen, upsampled=True)

    y1, y2 = run(5), run(5)
    assert torch.equal(y1, y2)
    if scalar:
        assert y1.shape == (2, 12, 1) and (y1.abs() <= 1).all()
    else:
        assert y1.shape == (2, 12, 256) and torch.equal(y1.sum(-1), torch.ones(2, 12))


def test_fold_weight_norm_preserves_function():
    _, _, net = nets(seed=5)
    ids, c, g, _ = _inputs({})
    args = (torch.from_numpy(ids), torch.from_numpy(c), torch.from_numpy(g))
    with torch.no_grad():
        before = net.apply(*args, upsampled=True)
        fold_weight_norm(net)
        after = net.apply(*args, upsampled=True)
    assert not any(n.endswith(".v") for n, _ in net.named_parameters())
    np.testing.assert_allclose(after.numpy(), before.numpy(), atol=1e-5)


def test_fused_stack_apply_matches_jax():
    """On CPU tensors ``fused_stack`` runs the plain versions of K2/K3, and
    the logits equal the JAX package's fused apply (Pallas in interpret mode)
    on the same weights."""
    jnet, params, net = nets(seed=6, fused_stack=True)
    ids, c, g, _ = _inputs({})
    want = jnet.apply(params, jnp.asarray(ids), c, jnp.asarray(g), upsampled=True)
    with torch.no_grad():
        got = net.apply(torch.from_numpy(ids), torch.from_numpy(c), torch.from_numpy(g), upsampled=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
