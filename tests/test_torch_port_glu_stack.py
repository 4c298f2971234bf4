"""The plain versions of K2/K3 (``kernels/glu_stack.py``) against the JAX
package's ``fused_glu_stack`` (Pallas in interpret mode, as
tests/test_glu_stack.py runs it) and against autograd, on the CPU.

Inputs are made with numpy from a seed and loaded into both packages.
Tolerances: forward atol 2e-5 / rtol 1e-4 and gradients atol 5e-5 / rtol
5e-4 in f32, the JAX package's own (tests/test_glu_stack.py:66,84). The
L=20 tests measure error as max |got - true| / max |true|, against the true
gradient from float64 autograd of the plain forward: 1e-3 in f32 (the
backward inverts the residual update, which multiplies any error of h by
sqrt 2 per layer, 2^10 over 20 layers) and 1e-2 in bf16 storage (the
port keeps the final residual in f32; the JAX kernel, which stores it in
bf16, is off by ~3x the gradient itself in dwconv[0] there).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _torch_port_util import nets  # noqa: E402
from wavenet_autoencoders_tpu.kernels.glu_stack import fused_glu_stack  # noqa: E402
from wavenet_autoencoders_tpu_torch.kernels.glu_stack import (  # noqa: E402
    FusedGLUStack,
    glu_stack_forward,
    glu_stack_forward_reference,
)

NAMES = ("x", "c", "g_add", "wconv", "bconv", "wc", "wout", "bout", "wskip", "bskip")
DILS4 = (1, 2, 4, 8)
DILS20 = tuple(2 ** (i % 10) for i in range(20))
FWD_TOL = dict(atol=2e-5, rtol=1e-4)
GRAD_TOL = dict(atol=5e-5, rtol=5e-4)


def make_inputs(seed, B=2, T=64, C=8, G=16, S=8, cin=4, L=4, cond=True):
    """numpy inputs of the stack in NAMES order (c and g_add None without
    ``cond``), 0.3-std normals as in tests/test_glu_stack.py."""
    rng = np.random.default_rng(seed)

    def mk(*shape):
        return (0.3 * rng.standard_normal(shape)).astype(np.float32)

    vals = [mk(B, T, C), mk(B, T, cin), mk(B, L, G), mk(L, 3, C, G), mk(L, G), mk(L, cin, G),
            mk(L, G // 2, C), mk(L, C), mk(L, G // 2, S), mk(L, S)]
    if not cond:
        vals[1] = vals[2] = vals[5] = None
    probe = rng.standard_normal((B, T, S)).astype(np.float32)
    return vals, probe


def jax_fwd_grads(vals, probe, dils):
    """JAX fused_glu_stack (interpret mode): forward, and the custom-VJP
    gradients of sum(skips * probe) w.r.t. every input that is not None."""
    live = [i for i, v in enumerate(vals) if v is not None]

    def loss(*xs):
        full = list(vals)
        for i, x in zip(live, xs):
            full[i] = x
        return jnp.sum(fused_glu_stack(*full, dils, True) * probe)

    args = [jnp.asarray(vals[i]) for i in live]
    full = [None if v is None else jnp.asarray(v) for v in vals]
    out = np.asarray(fused_glu_stack(*full, dils, True))
    grads = jax.grad(loss, argnums=tuple(range(len(live))))(*args)
    return out, {NAMES[i]: np.asarray(g) for i, g in zip(live, grads)}


def port_fwd_grads(vals, probe, dils, dtype=torch.float32):
    """FusedGLUStack on CPU tensors (the plain K2/K3): forward and the
    gradients of sum(skips * probe)."""
    leaves = [None if v is None else torch.tensor(v).to(dtype if i in (0, 1, 3, 5, 6, 8) else torch.float32)
              .requires_grad_(True) for i, v in enumerate(vals)]
    out = FusedGLUStack.apply(*leaves, dils)
    (out.float() * torch.from_numpy(probe)).sum().backward()
    return out.detach().float().numpy(), {n: t.grad.float().numpy() for n, t in zip(NAMES, leaves) if t is not None}


def true_grads(vals, probe, dils, dtype=torch.float64):
    """Autograd of the plain forward in ``dtype`` (float64: the true
    gradient)."""
    leaves = [None if v is None else torch.tensor(v, dtype=dtype, requires_grad=True) for v in vals]
    skips, _, _ = glu_stack_forward_reference(*leaves, dils)
    (skips * torch.from_numpy(probe).to(dtype)).sum().backward()
    return {n: t.grad.numpy() for n, t in zip(NAMES, leaves) if t is not None}


def rel(a, b):
    return float(np.abs(a - b).max() / np.abs(b).max())


def test_forward_and_gradients_match_jax_f32():
    vals, probe = make_inputs(0)
    out, grads = port_fwd_grads(vals, probe, DILS4)
    jout, jgrads = jax_fwd_grads(vals, probe, DILS4)
    np.testing.assert_allclose(out, jout, **FWD_TOL)
    assert set(grads) == set(NAMES)
    for n in NAMES:
        np.testing.assert_allclose(grads[n], jgrads[n], **GRAD_TOL, err_msg=n)


def test_gradients_match_autograd_of_the_plain_forward_f32():
    vals, probe = make_inputs(1)
    _, grads = port_fwd_grads(vals, probe, DILS4)
    want = true_grads(vals, probe, DILS4, dtype=torch.float32)
    for n in NAMES:
        np.testing.assert_allclose(grads[n], want[n], **GRAD_TOL, err_msg=n)


@pytest.mark.parametrize("case", ["no_cond_L1", "no_cond_L4", "untiled_B3_T37_G12"])
def test_branches_and_untiled_shapes_match_jax(case):
    """c=None / g_add=None at L=1 and L=4, and B=3, T=37, G=12, shapes no
    tile of the CUDA kernel divides."""
    if case == "no_cond_L1":
        vals, probe = make_inputs(2, L=1, cond=False)
        dils = (1,)
    elif case == "no_cond_L4":
        vals, probe = make_inputs(3, cond=False)
        dils = DILS4
    else:
        vals, probe = make_inputs(4, B=3, T=37, G=12)
        dils = DILS4
    out, grads = port_fwd_grads(vals, probe, dils)
    jout, jgrads = jax_fwd_grads(vals, probe, dils)
    np.testing.assert_allclose(out, jout, **FWD_TOL)
    assert set(grads) == set(jgrads)
    for n in grads:
        np.testing.assert_allclose(grads[n], jgrads[n], **GRAD_TOL, err_msg=n)


def test_l20_f32_gradients_within_1e3_of_the_true_gradient():
    vals, probe = make_inputs(5, B=1, T=32, L=20, G=16, C=8, S=8)
    _, grads = port_fwd_grads(vals, probe, DILS20)
    want = true_grads(vals, probe, DILS20)
    errs = {n: rel(grads[n], want[n]) for n in NAMES}
    assert max(errs.values()) < 1e-3, errs


def test_l20_bf16_gradients_within_1e2_of_the_true_gradient():
    """bf16 storage: every gradient, dwconv[0] included, against the true
    f32 gradient on the bf16-rounded inputs (the JAX kernel, with its bf16
    final residual, reads ~3 here for dwconv[0])."""
    vals, probe = make_inputs(6, B=1, T=32, L=20, G=16, C=8, S=8)
    rounded = [torch.tensor(v).to(torch.bfloat16).float().numpy() if i in (0, 1, 3, 5, 6, 8) else v
               for i, v in enumerate(vals)]
    out, grads = port_fwd_grads(vals, probe, DILS20, dtype=torch.bfloat16)
    want = true_grads(rounded, probe, DILS20, dtype=torch.float32)
    assert np.isfinite(out).all()
    errs = {n: rel(grads[n], want[n]) for n in NAMES}
    errs["dwconv[0]"] = rel(grads["wconv"][0], want["wconv"][0])
    assert max(errs.values()) < 1e-2, errs


def test_dispatch_runs_the_plain_version_on_cpu_tensors():
    vals, _ = make_inputs(7)
    args = [None if v is None else torch.tensor(v) for v in vals]
    got = glu_stack_forward(*args, DILS4)
    want = glu_stack_forward_reference(*args, DILS4)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_wavenet_apply_fused_matches_unfused_outputs_and_gradients():
    """Model level, f32: WaveNet.apply through FusedGLUStack against the
    plain per-layer path on the same weights (tolerances of
    tests/test_glu_stack.py:129-173)."""
    _, _, net = nets(seed=7)
    _, _, fused = nets(seed=7, fused_stack=True)
    rng = np.random.default_rng(7)
    ids = torch.from_numpy(rng.integers(0, 256, (2, 40)))
    c = torch.from_numpy(rng.standard_normal((2, 40, 5)).astype(np.float32))
    g = torch.tensor([1, 3])
    ys = []
    for m in (net, fused):
        y = m.apply(ids, c, g, upsampled=True, train=True)
        (y.float() ** 2).mean().backward()
        ys.append(y.detach())
    np.testing.assert_allclose(ys[1].numpy(), ys[0].numpy(), atol=5e-5, rtol=1e-4)
    grads = dict(fused.named_parameters())
    for name, p in net.named_parameters():
        # autograd leaves None where nothing flows (the upsampler on upsampled
        # conditioning, the last layer's out conv); K3 returns zeros there
        want = torch.zeros_like(p) if p.grad is None else p.grad
        got = grads[name].grad
        got = torch.zeros_like(p) if got is None else got
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-4, rtol=2e-3, err_msg=name)
