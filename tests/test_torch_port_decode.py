"""K1, the fused AR decode: the port's plain version (what
``wavenet_decode`` runs for CPU tensors) against the JAX Pallas kernel in
interpret mode, against the port's own batch forward, and its sampling
rules. The CUDA kernel itself is held against this plain version on the
card by chip_smoke.py.

Tolerances: 2e-4 abs on teacher-mode logits in f32, as in
tests/test_decode_kernel.py:53; 5e-2 for bf16 storage against f32 (bf16
keeps 8 mantissa bits; the tiny nets' logits are O(1)).
"""
import ctypes
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from _torch_port_util import nets  # noqa: E402
from wavenet_autoencoders_tpu.kernels.decode import (  # noqa: E402
    pack_decode_weights as jpack,
    precompute_g_add as jgadd,
    wavenet_decode_pallas,
)
from wavenet_autoencoders_tpu_torch.kernels import decode as K  # noqa: E402


def _teacher_case(scalar, seed=0, T=20):
    kw = dict(layers=6, stacks=2)  # dilations 1,2,4 twice: T=20 > 2*4 wraps every ring
    if scalar:
        kw.update(out_channels=30, scalar_input=True)
    jnet, params, net = nets(seed=seed, **kw)
    rng = np.random.default_rng(seed)
    B = 2
    c = rng.standard_normal((B, T, 5)).astype(np.float32)
    g = np.array([1, 3], np.int32)
    if scalar:
        teach = rng.uniform(-1, 1, (B, T)).astype(np.float32)
    else:
        teach = rng.integers(0, 256, (B, T)).astype(np.int32)
    return jnet, params, net, c, g, teach


@pytest.mark.parametrize("scalar", [False, True])
def test_plain_k1_teacher_logits_match_jax_pallas_interpret(scalar):
    jnet, params, net, c, g, teach = _teacher_case(scalar)
    T = c.shape[1]
    _, want = wavenet_decode_pallas(
        jnet, jpack(jnet, params), T, seed=0, c_up=c, g_add=jgadd(jnet, params, jnp.asarray(g)),
        teach=teach, teacher=True, interpret=True,
    )
    packed = K.pack_decode_weights(net)
    g_add = K.precompute_g_add(net, torch.from_numpy(g))
    _, got = K.wavenet_decode(net, packed, T, 0, c_up=torch.from_numpy(c), g_add=g_add,
                              teach=torch.from_numpy(teach), teacher=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4)


@pytest.mark.parametrize("scalar", [False, True])
@pytest.mark.parametrize("dtype_str", ["float32", "bfloat16"])
def test_plain_k1_teacher_logits_match_port_apply(scalar, dtype_str):
    _, _, net, c, g, teach = _teacher_case(scalar, seed=1, T=24)
    c, g, teach = map(torch.from_numpy, (c, g, teach))
    with torch.no_grad():
        x = teach[..., None] if scalar else teach
        want = net.apply(x, c, g, upsampled=True)
    _, got = K.wavenet_decode(net, K.pack_decode_weights(net), 24, 0, c, K.precompute_g_add(net, g),
                              teach, True, dtype_str)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=2e-4 if dtype_str == "float32" else 5e-2)


@pytest.mark.parametrize("dtype_str", ["float32", "bfloat16"])
def test_sampled_logits_match_apply_on_fed_back_codes(dtype_str):
    """In sampling mode each sampled code is the next step's input: the
    logits must be apply's on the codes shifted by one step, 127 first."""
    _, _, net, c, g, _ = _teacher_case(False, seed=7, T=24)
    c, g = torch.from_numpy(c), torch.from_numpy(g)
    codes, got = K.wavenet_decode(net, K.pack_decode_weights(net), 24, 3, c, K.precompute_g_add(net, g),
                                  dtype_str=dtype_str)
    fed = torch.cat([torch.full((2, 1), 127, dtype=codes.dtype), codes[:, :-1]], dim=1)
    with torch.no_grad():
        want = net.apply(fed, c, g, upsampled=True)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=2e-4 if dtype_str == "float32" else 5e-2)


def test_gumbel_argmax_follows_softmax():
    """65536 draws from 8 live classes: each frequency within 1e-2 of its
    softmax probability (5.4 standard errors at the largest p, 0.34). Noise
    of the wrong sign moves a frequency by 0.11, no noise by 0.66."""
    _, _, net = nets(seed=8, gin_channels=-1, use_speaker_embedding=False, layers=2, stacks=1)
    packed = _zeroed(net)
    live = torch.tensor([5, 37, 70, 101, 140, 171, 200, 251])
    logits = torch.arange(8, dtype=torch.float32) * 0.4
    packed["bp2"].fill_(-30.0)
    packed["bp2"][live] = logits
    codes, _ = K.wavenet_decode(net, packed, 1024, 5, c_up=torch.zeros(64, 1024, 5))
    counts = torch.bincount(codes.flatten().long(), minlength=256)
    assert counts[live].sum() == codes.numel()
    np.testing.assert_allclose(counts[live].numpy() / codes.numel(), torch.softmax(logits, 0).numpy(), atol=1e-2)


def _zeroed(net):
    return {k: torch.zeros_like(v) for k, v in K.pack_decode_weights(net).items()}


def test_spiked_bias_samples_class_42():
    _, _, net = nets(seed=2, cin_channels=-1, gin_channels=-1, use_speaker_embedding=False)
    packed = _zeroed(net)
    packed["bp2"][42] = 30.0
    codes, _ = K.wavenet_decode(net, packed, 20, 0)
    assert codes.dtype == torch.int32
    assert (codes == 42).float().mean() > 0.95


@pytest.mark.parametrize("dist", ["Logistic", "Normal"])
def test_scalar_sampler_follows_pinned_mixture(dist):
    _, _, net = nets(seed=3, out_channels=30, scalar_input=True, output_distribution=dist,
                     cin_channels=-1, gin_channels=-1, use_speaker_embedding=False)
    packed = _zeroed(net)
    packed["bp2"][10:20] = 0.5    # means
    packed["bp2"][20:30] = -10.0  # log scales
    samples, _ = K.wavenet_decode(net, packed, 16, 11)
    assert samples.dtype == torch.float32
    np.testing.assert_allclose(samples.numpy(), 0.5, atol=1e-2)


@pytest.mark.parametrize("scalar", [False, True])
def test_same_seed_same_codes_other_seed_other_codes(scalar):
    kw = dict(out_channels=30, scalar_input=True) if scalar else {}
    _, _, net = nets(seed=4, gin_channels=-1, use_speaker_embedding=False, **kw)
    c = torch.from_numpy(np.random.default_rng(4).standard_normal((2, 16, 5)).astype(np.float32))
    packed = K.pack_decode_weights(net)
    a, b, other = (K.wavenet_decode(net, packed, 16, s, c_up=c)[0] for s in (7, 7, 8))
    assert torch.equal(a, b)
    assert not torch.equal(a, other)
    if scalar:
        assert (a.abs() <= 1).all()
    else:
        assert ((a >= 0) & (a < 256)).all()


def test_cpu_tensors_take_the_plain_version(monkeypatch):
    _, _, net = nets(seed=5, cin_channels=-1, gin_channels=-1, use_speaker_embedding=False)

    def refuse(*a, **k):
        raise AssertionError("the CUDA path was taken for CPU tensors")

    monkeypatch.setattr(K, "_decode_cuda", refuse)
    before = K.LAUNCHES
    codes, logits = K.wavenet_decode(net, K.pack_decode_weights(net), 6, 0)
    assert codes.shape == (1, 6) and logits.shape == (1, 6, 256)
    assert K.LAUNCHES == before  # the plain version does not count


def test_decode_kernel_method_runs_the_plain_version_on_cpu():
    _, _, net = nets(seed=6, upsample_conditional_features=True, upsample_scales=(2, 2))
    lat = torch.from_numpy(np.random.default_rng(6).standard_normal((2, 3, 5)).astype(np.float32))
    codes, logits = net.decode_kernel(12, c=lat, g=torch.tensor([0, 2]), seed=1, dtype_str="float32")
    assert codes.shape == (2, 12) and logits.shape == (2, 12, 256)


def test_args_struct_mirrors_the_cuda_source():
    """The ctypes struct must list the C struct's fields in order, all 8
    bytes wide (so neither side pads)."""
    src = (Path(K.__file__).resolve().parent.parent / "csrc" / "decode.cu").read_text()
    body = re.search(r"struct DecodeArgs \{(.*?)\};", src, re.S).group(1)
    names = []
    for decl in body.split(";"):
        decl = re.sub(r"\b(const|int64_t|void|float|unsigned|int)\b|\*", " ", decl)
        names += [re.sub(r"\[.*\]", "", n).strip() for n in decl.split(",") if n.strip()]
    assert names == [f[0] for f in K._DecodeArgs._fields_]
    assert ctypes.sizeof(K._DecodeArgs) == 8 * (len(names) - 2 + 2 * K._MAXL)
