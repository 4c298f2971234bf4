"""The conditioning upsampler's chain (``kernels/upsample.py``) on the CPU:
its plain version, which the port's CPU path takes, against the JAX
package's upsampler, and the checks that send a call the CUDA kernels do
not take to an error. The kernels themselves run on the card only
(``chip_smoke.py`` phase 18 holds them against the plain version).

The scale sets and ``cin_pad`` are the presets': svqwae 4,4,8,5; inae
4,4,4,5; ae 2,4,4,5; vocoder_raw 4,4,4,4 with cin_pad 2, through
``ConvInUpsample`` (the presets' ``upsample_net``) and through
``UpsampleNetwork`` with the cin_pad trim. Smoothing weights, inputs and the
output's probe are numpy normals from a seed, loaded into both packages.
Tolerances: f32 1e-4, max abs error relative to the JAX value's max abs
(another summation order); bf16 2e-2 on the output and 5e-2 on the
gradients (chip_smoke phase 5's bf16 bounds: both round every scale's
output to bf16, in other orders, and a flipped rounding propagates).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _torch_port_util import to_np  # noqa: E402
from wavenet_autoencoders_tpu.ops import upsample as jup  # noqa: E402
from wavenet_autoencoders_tpu_torch.kernels import upsample as K  # noqa: E402
from wavenet_autoencoders_tpu_torch.ops import upsample  # noqa: E402
from wavenet_autoencoders_tpu_torch.utils import jax_random as jr  # noqa: E402
from wavenet_autoencoders_tpu_torch.utils.params import load_jax_params  # noqa: E402

PRESETS = {"svqwae": ((4, 4, 8, 5), 0), "inae": ((4, 4, 4, 5), 0), "ae": ((2, 4, 4, 5), 0),
           "vocoder_raw": ((4, 4, 4, 4), 2)}
TOL = {"float32": (1e-4, 1e-4), "bfloat16": (2e-2, 5e-2)}
B, T0, CIN = 2, 6, 3


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _case(net, scales, cin_pad, seed=0):
    """JAX params with perturbed smoothing weights, the port module holding
    them, the input and the output probe (numpy)."""
    rng = np.random.default_rng(seed)
    if net == "conv_in":
        jp = jup.conv_in_upsample_init(jax.random.PRNGKey(seed), CIN, cin_pad, scales)
        mod = upsample.ConvInUpsample(CIN, cin_pad, scales, key=jr.PRNGKey(seed))
        convs = jp["upsample"]["convs"]
        t_out = (T0 - 2 * cin_pad) * int(np.prod(scales))
    else:
        jp = jup.upsample_network_init(None, scales)
        mod = upsample.UpsampleNetwork(scales, key=jr.PRNGKey(seed))
        convs = jp["convs"]
        t_out = T0 * int(np.prod(scales)) - 2 * cin_pad * int(np.prod(scales))
    for cv in convs:  # away from the constant init, so that a wrong tap shows
        cv["v"] = jnp.asarray(rng.uniform(0.2, 1.0, cv["v"].shape).astype(np.float32))
        cv["g"] = jnp.asarray(np.float32(rng.uniform(0.5, 1.5)))
    load_jax_params(mod, to_np(jp))
    c = rng.standard_normal((B, T0, CIN)).astype(np.float32)
    probe = rng.standard_normal((B, t_out, CIN)).astype(np.float32)
    return jp, mod, c, probe


def _jax(net, jp, c, probe, scales, cin_pad, dtype):
    def f(params, x):
        if net == "conv_in":
            out = jup.conv_in_upsample_apply(params, x, scales, 1, dtype=dtype)
        else:
            out = jup.upsample_network_apply(params, x, scales, 1, cin_pad=cin_pad, dtype=dtype)
        return jnp.sum(out.astype(jnp.float32) * probe), out

    (_, out), (gp, gc) = jax.value_and_grad(f, argnums=(0, 1), has_aux=True)(jp, jnp.asarray(c))
    convs = gp["upsample"]["convs"] if net == "conv_in" else gp["convs"]
    return np.asarray(out.astype(jnp.float32)), np.asarray(gc), [(np.asarray(v["g"]), np.asarray(v["v"])) for v in convs]


def _port(net, mod, c, probe, scales, cin_pad, dtype):
    x = torch.from_numpy(c).requires_grad_(True)
    if net == "conv_in":
        out = upsample.conv_in_upsample_apply(mod, x, scales, 1, dtype=dtype)
        convs = mod.upsample.convs
    else:
        out = upsample.upsample_network_apply(mod, x, scales, 1, cin_pad=cin_pad, dtype=dtype)
        convs = mod.convs
    (out.float() * torch.from_numpy(probe)).sum().backward()
    return (out.detach().float().numpy(), x.grad.numpy(),
            [(cv.g.grad.numpy(), cv.v.grad.numpy()) for cv in convs])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("net", ["conv_in", "upsample"])
@pytest.mark.parametrize("preset", sorted(PRESETS))
def test_plain_chain_matches_jax(preset, net, dtype):
    """Forward, and the gradients of the conditioning and of each scale's
    g and v, through the port's CPU path (the plain version) against the
    JAX package's upsampler."""
    scales, cin_pad = PRESETS[preset]
    jp, mod, c, probe = _case(net, scales, cin_pad)
    jdt = None if dtype == "float32" else jnp.bfloat16
    tdt = None if dtype == "float32" else torch.bfloat16
    launches = K.LAUNCHES_FWD, K.LAUNCHES_BWD
    want, want_dc, want_w = _jax(net, jp, c, probe, scales, cin_pad, jdt)
    got, got_dc, got_w = _port(net, mod, c, probe, scales, cin_pad, tdt)
    assert (K.LAUNCHES_FWD, K.LAUNCHES_BWD) == launches  # the plain version counts no launch
    assert got.shape == want.shape
    tol_f, tol_b = TOL[dtype]
    errs = {"out": _rel(got, want), "dc": _rel(got_dc, want_dc)}
    for k, ((gg, gv), (wg, wv)) in enumerate(zip(got_w, want_w)):
        errs[f"g{k}"], errs[f"v{k}"] = _rel(gg, wg), _rel(gv, wv)
    bad = {k: e for k, e in errs.items() if not e <= (tol_f if k == "out" else tol_b)}
    assert not bad, f"{preset} {net} {dtype}: {bad}"


def _weights(scales, dtype=torch.float32, fsk=1):
    return [torch.full((1, 1, fsk, 2 * s + 1), 0.1, dtype=dtype) for s in scales]


def test_check_supported_takes_every_preset():
    for scales, cin_pad in PRESETS.values():
        x = torch.zeros(B, T0, 64)
        for dtype in (torch.float32, torch.bfloat16):
            K.check_supported(x.to(dtype), _weights(scales, dtype), scales, 1, cin_pad * int(np.prod(scales)))


@pytest.mark.parametrize("bad", ["freq_ks_3", "float16", "weight_dtype", "weight_shape", "scale_9", "scale_17",
                                 "nine_scales", "trimmed_away"])
def test_check_supported_refuses(bad):
    """What the CUDA path refuses, as ``upsample`` checks it before any
    launch: checked here on CPU tensors."""
    scales, fsk, x, indent = [4, 4, 8, 5], 1, torch.zeros(B, T0, 4), 0
    ws = _weights(scales)
    if bad == "freq_ks_3":
        fsk, ws = 3, _weights(scales, fsk=3)
    elif bad == "float16":
        x, ws = x.half(), _weights(scales, torch.float16)
    elif bad == "weight_dtype":
        x = x.bfloat16()
    elif bad == "weight_shape":
        ws[2] = torch.zeros(1, 1, 1, 9)
    elif bad == "scale_9":  # one above the presets' largest, 8
        scales, ws = [4, 9], _weights([4, 9])
    elif bad == "scale_17":
        scales, ws = [17], _weights([17])
    elif bad == "nine_scales":
        scales, ws = [2] * 9, _weights([2] * 9)
    else:
        indent = T0 * 640 // 2
    with pytest.raises(ValueError):
        K.check_supported(x, ws, scales, fsk, indent)


def test_dispatch_by_device():
    """CPU tensors take the plain version; a device with no kernel raises,
    with no fallback."""
    scales = (2, 3)
    x = torch.randn(B, T0, 4)
    ws = [w * (1 + k) for k, w in enumerate(_weights(scales))]
    torch.testing.assert_close(K.upsample(x, ws, scales), K.upsample_reference(x, ws, scales), rtol=0, atol=0)
    with pytest.raises(RuntimeError, match="no upsample kernels"):
        K.upsample(x.to("meta"), [w.to("meta") for w in ws], scales)


def test_counters_reach_the_tracer_and_the_graph():
    """The launch counters are levels of the tracer's records and counters
    a graphed step's replay adds to."""
    from wavenet_autoencoders_tpu_torch import kernels
    from wavenet_autoencoders_tpu_torch.utils import spans

    assert {"kernels.upsample.LAUNCHES_FWD", "kernels.upsample.LAUNCHES_BWD"} <= set(kernels.COUNTERS)
    spans.enable()
    try:
        levels = spans.records()["levels"]
    finally:
        spans.reset()
    assert levels["kernels.upsample.LAUNCHES_FWD"] == K.LAUNCHES_FWD
    assert levels["kernels.upsample.LAUNCHES_BWD"] == K.LAUNCHES_BWD
