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
import ctypes
import json
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _torch_port_util import nets  # noqa: E402
from wavenet_autoencoders_tpu.kernels.glu_stack import fused_glu_stack  # noqa: E402
from wavenet_autoencoders_tpu_torch.kernels import glu_stack as glu_stack_mod  # noqa: E402
from wavenet_autoencoders_tpu_torch.kernels.glu_stack import (  # noqa: E402
    DX_WG_WIDTHS,
    GATE_WG_WIDTHS,
    FusedGLUStack,
    check_widths,
    dx_route,
    gate_perm,
    gate_route,
    glu_stack_backward_reference,
    glu_stack_forward,
    glu_stack_forward_reference,
    pack_weights,
    pad_cin,
    unpad_cin,
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


# ---------------------------------------------------------------------------
# the CUDA kernels' weight layouts, emulated in plain f32 on the CPU
# ---------------------------------------------------------------------------


def torch_inputs(seed, **kw):
    vals, probe = make_inputs(seed, **kw)
    return [None if v is None else torch.tensor(v) for v in vals], torch.tensor(probe)


def unpack_weights(packed, C):
    """Inverse of ``pack_weights``: (wconv, wc or None, wout, wskip), each
    taken from every packed tensor that holds it, which must agree."""
    wg, wo, wd, wx = packed["wg"], packed["wo"], packed["wd"], packed["wx"]
    L, G, K = wg.shape
    cin = K - 3 * C
    wk = torch.empty(L, K, G, dtype=wg.dtype, device=wg.device)
    wk[:, :, gate_perm(G).to(wg.device)] = wg.transpose(1, 2)
    wconv = wk[:, : 3 * C].reshape(L, 3, C, G)
    wc = wk[:, 3 * C :] if cin else None
    wout, wskip = wd[..., :C], wd[..., C:]
    same = [torch.equal(wo, wd.transpose(1, 2)),
            torch.equal(wx[:, :C].reshape(L, C, 3, G).permute(0, 2, 1, 3), wconv)]
    if cin:
        same += [torch.equal(wx[:, C:, 2 * G :], wc), not wx[:, C:, : 2 * G].any()]
    if not all(same):
        raise ValueError("packed weights disagree with each other")
    return wconv, wc, wout, wskip


@pytest.mark.parametrize("cond", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_weight_packing_inverts_exactly(cond, dtype):
    (_, c, _, wconv, _, wc, wout, _, wskip, _), _ = torch_inputs(8, C=16, G=24, S=8, cin=8, cond=cond)
    G = wconv.shape[-1]
    perm = gate_perm(G)
    assert sorted(perm.tolist()) == list(range(G))
    assert perm[0::2].tolist() == list(range(G // 2)) and perm[1::2].tolist() == list(range(G // 2, G))
    packed = pack_weights(wconv, wc, wout, wskip, dtype)
    assert all(v.dtype == dtype and v.is_contiguous() for v in packed.values())
    back = unpack_weights(packed, wconv.shape[2])
    for got, want in zip(back, (wconv, wc, wout, wskip)):
        if want is None:
            assert got is None
        else:
            assert torch.equal(got, want.to(dtype))


def packed_forward(x, c, g_add, packed, bconv, bout, bskip, dils):
    """K2's products as the CUDA kernel runs them: one gate product over
    [h[t-2d] | h[t-d] | h[t] | c] against the packed, column-permuted ``wg``,
    whose columns 2i, 2i+1 are the gate pair (i, G/2+i), then one out/skip
    product against ``wo``. Returns (ab, act) of every layer, skips, hfin."""
    wg, wo = packed["wg"], packed["wo"]
    B, T, C = x.shape
    G2 = wg.shape[1] // 2
    h, skip, abs_, acts = x, 0.0, [], []
    for l, d in enumerate(dils):
        hp = torch.nn.functional.pad(h, (0, 0, 2 * d, 0))
        a = torch.cat([hp[:, :T], hp[:, d : d + T], h] + ([] if c is None else [c]), -1)
        y = a @ wg[l].T
        bias = bconv[l] if g_add is None else bconv[l] + g_add[:, l, None, :]
        ga, gb = y[..., 0::2] + bias[..., :G2], y[..., 1::2] + bias[..., G2:]
        act = torch.tanh(ga) * torch.sigmoid(gb)
        abs_.append(torch.cat([ga, gb], -1))
        acts.append(act)
        y = act @ wo[l].T
        skip = skip + y[..., C:] + bskip[l]
        h = (y[..., :C] + bout[l] + h) * (0.5 ** 0.5)
    return torch.stack(abs_, 1), torch.stack(acts, 1), skip, h


@pytest.mark.parametrize("cond", [True, False])
def test_gate_product_on_packed_weights_matches_the_plain_forward(cond):
    (x, c, g_add, wconv, bconv, wc, wout, bout, wskip, bskip), _ = torch_inputs(
        9, B=2, T=40, C=16, G=24, S=8, cin=8, cond=cond)
    packed = pack_weights(wconv, wc, wout, wskip, torch.float32)
    ab, act, skips, hfin = packed_forward(x, c, g_add, packed, bconv, bout, bskip, DILS4)
    p_skips, p_hfin, p_ab = glu_stack_forward_reference(x, c, g_add, wconv, bconv, wc, wout, bout, wskip,
                                                         bskip, DILS4)
    G2 = ab.shape[-1] // 2
    p_act = torch.tanh(p_ab[..., :G2]) * torch.sigmoid(p_ab[..., G2:])
    for got, want in ((ab, p_ab), (act, p_act), (skips, p_skips), (hfin, p_hfin)):
        assert rel(got.numpy(), want.numpy()) < 1e-6


@pytest.mark.parametrize("cond", [True, False])
def test_backward_products_on_packed_weights_match_the_plain_backward(cond):
    """K3's rebuild, dact and dx/dc products against ``wo``, ``wd`` and
    ``wx`` equal the plain backward's products on the unpacked weights."""
    (_, c, _, wconv, _, wc, wout, _, wskip, _), _ = torch_inputs(10, C=16, G=24, S=8, cin=8, cond=cond)
    packed = pack_weights(wconv, wc, wout, wskip, torch.float32)
    rng = np.random.default_rng(10)
    B, T, C, G, d, l = 2, 40, 16, 24, 4, 2
    act, gy, dskip, dab = (torch.from_numpy(rng.standard_normal((B, T, n)).astype(np.float32))
                           for n in (G // 2, C, 8, G))
    assert rel((act @ packed["wo"][l][:C].T).numpy(), (act @ wout[l]).numpy()) < 1e-6
    got = torch.cat([gy, dskip], -1) @ packed["wd"][l].T
    assert rel(got.numpy(), (gy @ wout[l].T + dskip @ wskip[l].T).numpy()) < 1e-6
    dabp = torch.nn.functional.pad(dab, (0, 0, 0, 2 * d))
    taps = [dabp[:, (2 - j) * d : (2 - j) * d + T] for j in range(3)]
    got = torch.cat(taps, -1) @ packed["wx"][l].T
    want = sum(taps[j] @ wconv[l, j].T for j in range(3))
    assert rel(got[..., :C].numpy(), want.numpy()) < 1e-6
    if cond:
        assert rel(got[..., C:].numpy(), (dab @ wc[l].T).numpy()) < 1e-6
    else:
        assert got.shape[-1] == C


@pytest.mark.parametrize("bad", ["C", "G/2", "S", "cin", "none"])
@pytest.mark.parametrize("off", [4, 2])
def test_width_check_refuses_what_the_kernels_cannot_take(bad, off):
    dims = {"C": 32, "G/2": 24, "S": 16, "cin": 8}
    if bad != "none":
        dims[bad] += off
    args = (dims["C"], 2 * dims["G/2"], dims["S"], dims["cin"])
    if bad == "none":
        check_widths(*args)
    else:
        with pytest.raises(ValueError, match="multiples of 8"):
            check_widths(*args)


@pytest.mark.parametrize("cin", [39, 5, 8])
def test_cin_padding_matches_the_unpadded_plain_version(cin):
    """What the kernels' wrappers do for a cin that is not a multiple of 8
    (39 in the ae and vocoder presets): zero columns of c and zero rows of
    wc leave the forward exactly as it was, and the cut-back dc and dwc equal
    the unpadded backward's."""
    vals, probe = make_inputs(11, C=16, G=32, S=16, cin=cin)
    t = dict(zip(NAMES, (torch.from_numpy(v) for v in vals)))
    c, wc = pad_cin(t["c"], t["wc"])
    assert c.shape[-1] == wc.shape[1] == -(-cin // 8) * 8
    assert (c is t["c"]) == (cin % 8 == 0)
    assert float(c[..., cin:].abs().sum()) == 0.0 and float(wc[:, cin:].abs().sum()) == 0.0
    rest = [t[k] for k in ("wconv", "bconv")]
    tail = [t[k] for k in ("wout", "bout", "wskip", "bskip")]
    want = glu_stack_forward_reference(t["x"], t["c"], t["g_add"], *rest, t["wc"], *tail, DILS4)
    got = glu_stack_forward_reference(t["x"], c, t["g_add"], *rest, wc, *tail, DILS4)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    dskips = torch.from_numpy(probe)
    bw = (t["wconv"], t["wc"], t["wout"], t["bout"], t["wskip"], DILS4, True)
    want = glu_stack_backward_reference(dskips, want[1], t["c"], want[2], *bw)
    got = list(glu_stack_backward_reference(dskips, got[1], c, got[2], t["wconv"], wc, *bw[2:]))
    assert got[1].shape[-1] == got[5].shape[1] == c.shape[-1]
    got[1], got[5] = unpad_cin(got[1], got[5], cin)
    for name, a, b in zip(("dx", "dc", "dgadd", "dwconv", "dbconv", "dwc"), got, want):
        assert a.shape == b.shape, name
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6, rtol=1e-6, err_msg=name)


# ---------------------------------------------------------------------------
# K2's gate pass on the TMA + wgmma kernel: the route, the counter, and the
# kernel's decomposition of the product, emulated on the CPU
# ---------------------------------------------------------------------------

PRESETS = sorted(p.stem for p in (Path(glu_stack_mod.__file__).resolve().parent.parent / "presets").glob("*.json"))


def preset_widths(name):
    """(C, G, S, cin) that a preset's fused stack hands the kernels, cin
    padded to a multiple of 8 as the wrappers pad it (0 without c)."""
    hp = json.loads((Path(glu_stack_mod.__file__).resolve().parent.parent / "presets" / f"{name}.json").read_text())
    cin = max(hp.get("cin_channels", 0), 0)
    return hp["residual_channels"], hp["gate_channels"], hp["skip_out_channels"], -(-cin // 8) * 8


@pytest.mark.parametrize("preset", PRESETS)
def test_gate_route_by_preset_and_storage(preset):
    """bf16 storage takes the TMA + wgmma gate kernel at every preset's
    widths; f32 storage keeps gemm_pipe (wgmma has no full-precision f32
    product)."""
    C, G, S, cin = preset_widths(preset)
    check_widths(C, G, S, cin)
    assert G in GATE_WG_WIDTHS
    assert gate_route(C, G, S, cin, torch.bfloat16) == "tma_wgmma"
    assert gate_route(C, G, S, cin, torch.float32) == "gemm_pipe"
    assert gate_route(C, G, S, 0, torch.bfloat16) == "tma_wgmma"  # no conditioning


@pytest.mark.parametrize("G", [240, 272, 376, 512])
def test_gate_route_keeps_gemm_pipe_for_widths_the_kernel_is_not_built_for(G):
    assert gate_route(256, G, 256, 64, torch.bfloat16) == "gemm_pipe"
    assert gate_route(256, 368, 256, 60, torch.bfloat16) == "gemm_pipe"  # cin not a multiple of 8


def test_gate_launch_counter_is_a_graph_counter_and_a_tracer_level():
    """A graph replay counts the gate kernel's layer launches (a counter of
    kernels.COUNTERS) and the tracer's records carry the counter as a
    level."""
    from wavenet_autoencoders_tpu_torch import kernels
    from wavenet_autoencoders_tpu_torch.utils import spans

    assert "kernels.glu_stack.LAUNCHES_GATE_WG" in kernels.COUNTERS
    before = glu_stack_mod.LAUNCHES_GATE_WG
    try:
        glu_stack_mod.LAUNCHES_GATE_WG = 20
        spans.enable()
        spans.disable()
        assert spans.records()["levels"]["kernels.glu_stack.LAUNCHES_GATE_WG"] == 20
    finally:
        glu_stack_mod.LAUNCHES_GATE_WG = before
        spans.reset()


def test_gate_kernel_counts_no_launch_on_the_plain_version():
    vals, _ = make_inputs(7)
    args = [None if v is None else torch.tensor(v).to(torch.bfloat16 if i in (0, 1) else torch.float32)
            for i, v in enumerate(vals)]
    before = glu_stack_mod.LAUNCHES_GATE_WG
    glu_stack_forward(*args, DILS4)
    assert glu_stack_mod.LAUNCHES_GATE_WG == before


def test_args_struct_mirrors_the_cuda_source():
    """The ctypes struct lists GluArgs's fields in order, all 8 bytes wide."""
    src = (Path(glu_stack_mod.__file__).resolve().parent.parent / "csrc" / "glu_stack.cu").read_text()
    body = re.search(r"struct GluArgs \{(.*?)\};", src, re.S).group(1)
    body = re.sub(r"//[^\n]*", "", body)
    names = []
    for decl in body.split(";"):
        decl = re.sub(r"\b(const|int64_t|void|float|unsigned|int)\b|\*", " ", decl)
        names += [re.sub(r"\[.*\]", "", n).strip() for n in decl.split(",") if n.strip()]
    assert names == [f[0] for f in glu_stack_mod._GluArgs._fields_]
    assert ctypes.sizeof(glu_stack_mod._GluArgs) == 8 * (len(names) - 1 + glu_stack_mod._MAXL)


def tma_box(x, col, t, b, rows=128, width=64):
    """A TMA box of a (B, T, W) array at (col, t, b): ``rows`` x ``width``,
    zeros wherever it leaves the array (the kernel's tensor maps)."""
    B, T, W = x.shape
    out = torch.zeros(rows, width, dtype=x.dtype)
    r0, r1 = max(t, 0), min(t + rows, T)
    c1 = min(col + width, W)
    if r0 < r1 and col < c1:
        out[r0 - t : r1 - t, : c1 - col] = x[b, r0:r1, col:c1]
    return out


def gate_tile_emulated(hb, c, wg_l, bconv_l, g_add_l, d, b, t0, C, cin):
    """One 128-row tile of the TMA gate kernel, emulated: the producer's
    k-stages (three taps of ceil(C/64) boxes of hb at t0 - 2d, t0 - d, t0,
    then ceil(cin/64) boxes of c; each against the weight stage at packed
    column j C + col, or 3 C + col, zero past K), the products of both halves
    of the packed gate columns, then the epilogue's pair mapping: half h's
    column 8 j + 2 q + e is gate pair h G/4 + 4 j + q, tanh side for e = 0.
    Returns ab (128, G) at the original columns, f32, before rounding."""
    G, K = wg_l.shape
    NH = G // 2
    wpad = torch.nn.functional.pad(wg_l, (0, 64))  # columns past K read as zeros
    acc = torch.zeros(128, G, dtype=torch.float64)
    kbc = -(-C // 64)
    stages = [(hb, j, kb * 64, j * C + kb * 64) for j in range(3) for kb in range(kbc)]
    stages += [(c, None, kb * 64, 3 * C + kb * 64) for kb in range(-(-cin // 64))]
    for src, j, col, k0 in stages:
        a = tma_box(src, col, t0 - (2 - j) * d if j is not None else t0, b).double()
        for h in range(2):
            acc[:, h * NH : (h + 1) * NH] += a @ wpad[h * NH : (h + 1) * NH, k0 : k0 + 64].double().T
    ab = torch.zeros(128, G, dtype=torch.float64)
    n = torch.arange(NH)
    for h in range(2):
        i = h * NH // 2 + 4 * (n // 8) + (n % 8) // 2  # gate pair of accumulator column n
        tanh_side = (n % 2) == 0
        ab[:, i[tanh_side]] = acc[:, h * NH + n[tanh_side]]
        ab[:, NH + i[~tanh_side]] = acc[:, h * NH + n[~tanh_side]]
    bias = bconv_l.double() + (0.0 if g_add_l is None else g_add_l.double())
    return ab + bias


@pytest.mark.parametrize("widths", [(256, 368, 64), (128, 256, 80), (256, 368, 40), (136, 256, 0)],
                         ids=["svqwae", "vocoder_raw", "cin40", "C136_nocond"])
def test_gate_kernel_decomposition_matches_the_plain_gate_product(widths):
    """The TMA gate kernel's tiles (k-stages of zero-filled boxes, both halves
    of the packed columns, the pair mapping of its epilogue) give the plain
    forward's layer-0 ab, at T not a multiple of 128 (a ragged last tile)
    and a dilation whose taps leave the batch row in the first tile."""
    C, G, cin = widths
    B, T, d = 2, 300, 128
    rng = np.random.default_rng(21)

    def mk(*shape):
        return torch.from_numpy((0.3 * rng.standard_normal(shape)).astype(np.float32))

    x, wconv, bconv = mk(B, T, C), mk(1, 3, C, G), mk(1, G)
    c, wc, g_add = (mk(B, T, cin), mk(1, cin, G), mk(B, 1, G)) if cin else (None, None, None)
    wout, bout, wskip, bskip = mk(1, G // 2, C), mk(1, C), mk(1, G // 2, 8), mk(1, 8)
    _, _, p_ab = glu_stack_forward_reference(x, c, g_add, wconv, bconv, wc, wout, bout, wskip, bskip, (d,))
    wg = pack_weights(wconv, wc, wout, wskip, torch.float32)["wg"][0]
    for b in range(B):
        for t0 in range(0, T, 128):
            got = gate_tile_emulated(x, c, wg, bconv[0], None if g_add is None else g_add[b, 0], d, b, t0, C, cin)
            rows = min(128, T - t0)
            assert rel(got[:rows].numpy(), p_ab[b, 0, t0 : t0 + rows].double().numpy()) < 1e-6


# ---------------------------------------------------------------------------
# K3's dx pass on the TMA + wgmma kernel: the route, the counter, and the
# kernel's decomposition of the product and its epilogue, emulated on the CPU
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("preset", PRESETS)
def test_dx_route_by_preset_and_storage(preset):
    """bf16 storage takes the TMA + wgmma dx kernel at every preset's widths;
    f32 storage keeps gemm_pipe (wgmma has no full-precision f32 product)."""
    C, G, S, cin = preset_widths(preset)
    check_widths(C, G, S, cin)
    assert (C, cin) in DX_WG_WIDTHS
    assert dx_route(C, G, S, cin, torch.bfloat16) == "tma_wgmma"
    assert dx_route(C, G, S, cin, torch.float32) == "gemm_pipe"
    # no conditioning: built for the residual width of 256
    assert dx_route(C, G, S, 0, torch.bfloat16) == ("tma_wgmma" if (C, 0) in DX_WG_WIDTHS else "gemm_pipe")


@pytest.mark.parametrize("C,cin", [(256, 32), (256, 72), (128, 64), (192, 64), (128, 0), (256, 60)])
def test_dx_route_keeps_gemm_pipe_for_widths_the_kernel_is_not_built_for(C, cin):
    assert (C, cin) not in DX_WG_WIDTHS
    assert dx_route(C, 368, 256, cin, torch.bfloat16) == "gemm_pipe"


def test_dx_launch_counter_is_a_graph_counter_and_a_tracer_level():
    """A graph replay counts the dx kernel's layer launches (a counter of
    kernels.COUNTERS) and the tracer's records carry the counter as a
    level."""
    from wavenet_autoencoders_tpu_torch import kernels
    from wavenet_autoencoders_tpu_torch.utils import spans

    assert "kernels.glu_stack.LAUNCHES_DX_WG" in kernels.COUNTERS
    before = glu_stack_mod.LAUNCHES_DX_WG
    try:
        glu_stack_mod.LAUNCHES_DX_WG = 20
        spans.enable()
        spans.disable()
        assert spans.records()["levels"]["kernels.glu_stack.LAUNCHES_DX_WG"] == 20
        assert kernels.launches()["kernels.glu_stack.LAUNCHES_DX_WG"] == 20
    finally:
        glu_stack_mod.LAUNCHES_DX_WG = before
        spans.reset()


def test_dx_kernel_counts_no_launch_on_the_plain_version():
    vals, probe = make_inputs(12)
    args = [None if v is None else torch.tensor(v).to(torch.bfloat16 if i in (0, 1) else torch.float32)
            for i, v in enumerate(vals)]
    _, hfin, ab = glu_stack_forward(*args, DILS4)
    before = glu_stack_mod.LAUNCHES_DX_WG
    glu_stack_mod.glu_stack_backward(torch.tensor(probe).to(torch.bfloat16), hfin, args[1], ab, args[3], args[5],
                                     args[6], args[7], args[8], DILS4, True)
    assert glu_stack_mod.LAUNCHES_DX_WG == before


def dx_tile_emulated(dabs, wx_l, d, b, t0, C, cin):
    """One 128-row tile of the TMA dx kernel's products, emulated: the
    producer's k-stages (tap j = 0, 1, 2 of dabs, boxes at t0 + (2 - j) d,
    ceil(G/64) of them a tap, zeros past T and past G), each against the
    weight stage read from wx as (C + cin, 3, G) with the tap a dimension
    of its own (zeros past G there too): the C dx rows on every k-stage,
    the cin dc rows only on the unshifted tap's. Returns the dx and dc
    products (128, C) and (128, cin), f64."""
    N, G3 = wx_l.shape
    G = G3 // 3
    w = torch.nn.functional.pad(wx_l.reshape(N, 3, G), (0, 64)).double()  # past G: zeros
    px = torch.zeros(128, C, dtype=torch.float64)
    pc = torch.zeros(128, cin, dtype=torch.float64)
    for j in range(3):
        for col in range(0, G, 64):
            a = tma_box(dabs, col, t0 + (2 - j) * d, b).double()
            px += a @ w[:C, j, col : col + 64].T
            if j == 2 and cin:
                pc += a @ w[C:, j, col : col + 64].T
    return px, pc


@pytest.mark.parametrize("widths", [(256, 368, 64), (256, 368, 40), (256, 368, 128), (128, 256, 80)],
                         ids=["svqwae", "cin40", "cin128", "vocoder_raw"])
def test_dx_kernel_decomposition_matches_the_plain_backward(widths):
    """The TMA dx kernel's tiles (zero-filled boxes of future rows, the
    weight stage with its tap a dimension of its own, dc products on the
    unshifted tap alone) and its epilogue (dx = dx/sqrt 2 + v, gy = dx/sqrt
    2, dc written at the walk's first layer and accumulated after) give the
    plain backward's dx, gy and dc over two layers, at T not a multiple of
    128 (a ragged last tile) and 2d >= 128 (the t + 2d box leaves the batch
    row in the last tiles)."""
    C, G, cin = widths
    B, T, dils = 2, 300, (80, 70)
    rng = np.random.default_rng(23)

    def mk(*shape):
        return torch.from_numpy((0.3 * rng.standard_normal(shape)).astype(np.float32))

    wconv, wc = mk(2, 3, C, G), mk(2, cin, G)
    wx = pack_weights(wconv, wc, mk(2, G // 2, C), mk(2, G // 2, 8), torch.float32)["wx"]
    dabs = [mk(B, T, G), mk(B, T, G)]
    # the plain backward's dx and dc lines (glu_stack_backward_reference), in
    # the walk's order l = 1, 0; dx starts at 0
    dx, dc, want = torch.zeros(B, T, C, dtype=torch.float64), None, {}
    for l in (1, 0):
        d, dab = dils[l], dabs[l].double()
        dabp = torch.nn.functional.pad(dab, (0, 0, 0, 2 * d))
        dx = dx * RS_ + sum(dabp[:, sh : sh + T] @ wconv[l, j].double().T
                            for j, sh in enumerate((2 * d, d, 0)))
        dct = dab @ wc[l].double().T
        dc = dct if dc is None else dc + dct
        want[l] = (dx.clone(), dx * RS_, dc.clone())
    # the kernel: a tile at a time, the epilogue on the tile's valid rows;
    # dx starts at 0 and dc uninitialised, as the backward allocates them
    gx, gc = torch.zeros(B, T, C, dtype=torch.float64), 1e3 * mk(B, T, cin).double()
    for l in (1, 0):
        for b in range(B):
            for t0 in range(0, T, 128):
                px, pc = dx_tile_emulated(dabs[l], wx[l], dils[l], b, t0, C, cin)
                rows = min(128, T - t0)
                gx[b, t0 : t0 + rows] = gx[b, t0 : t0 + rows] * RS_ + px[:rows]
                gc[b, t0 : t0 + rows] = pc[:rows] if l == 1 else gc[b, t0 : t0 + rows] + pc[:rows]
        for got, ref in zip((gx, gx * RS_, gc), want[l]):
            assert rel(got.numpy(), ref.numpy()) < 1e-9


RS_ = 0.5 ** 0.5
