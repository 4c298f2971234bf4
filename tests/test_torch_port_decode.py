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
import math
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


# ---------------------------------------------------------------------------
# the bf16 kernel's block plan and packing (csrc/decode.cu, decode_tc_kernel)
# ---------------------------------------------------------------------------

# (L, C, G, S, O, cin): svqwae, a vqwae-like G=256, the test nets (cin=5,
# zero-padded to 32), a scalar-input net without local conditioning
PLAN_DIMS = {
    "svqwae": (20, 256, 368, 256, 256, 64),
    "vqwae": (20, 256, 256, 256, 256, 64),
    "test_net_cin5": (4, 8, 12, 8, 256, 5),
    "scalar_no_c": (4, 8, 12, 8, 30, 0),
}


def _random_packed(L, C, G, S, O, cin, seed=0):
    """Random weights already rounded to bf16, so the bf16 packing holds them
    exactly."""
    g = torch.Generator().manual_seed(seed)
    shapes = {"wconv": (L, 3, C, G), "wout": (L, G // 2, C), "wskip": (L, G // 2, S), "wp1": (S, S), "wp2": (S, O)}
    if cin:
        shapes["wc"] = (L, cin, G)
    return {k: torch.randn(shp, generator=g).to(torch.bfloat16).float() for k, shp in shapes.items()}


def _unpack_block_weights(buf, plan):
    """The inverse of K.pack_block_weights: the weight tensors of
    pack_decode_weights (wconv, wc, wout, wskip, wp1, wp2) rebuilt from the
    packed shares."""
    flat = torch.zeros(plan.zero + 1)
    flat[torch.from_numpy(plan.index)] = buf.float()
    return {n: flat[o : o + int(np.prod(shp))].reshape(shp) for n, o, shp in plan.shapes}


def _unit_tiles(buf, plan):
    """{(kind, layer, tile): (Kp, 16) weight tile} read back from the packed
    shares through K.fragment_order (a skip unit gives one tile per layer):
    column r of a gate tile is gate column 8 tile + r (r < 8) or G/2 + 8 tile
    + r - 8; of any other tile, column 16 tile + r; row k is the physical k
    of the kernel's input row (segments padded to 32; a gate tile's are
    [tap0 | tap1 | c | h])."""
    out = {}
    L = plan.key[0]
    for b0, b1, w0, _ in plan.blk:
        for kind, l, t, woff in plan.units[b0:b1]:
            start = (w0 + woff) * 8
            if kind == K.U_GATE:
                kps = [3 * plan.cp + plan.cinp]
            elif kind in (K.U_OUT, K.U_SKIP):
                kps = [plan.g2p] * (L if kind == K.U_SKIP else 1)
            else:
                kps = [plan.sp]
            for i, kp in enumerate(kps):
                kidx, col = K.fragment_order(kp // 32)
                tile = torch.zeros(kp, 16)
                tile[torch.from_numpy(kidx), torch.from_numpy(col)] = buf[start : start + 16 * kp].float()
                out[(int(kind), int(l) + i, int(t))] = tile
                start += 16 * kp
    return out


@pytest.mark.parametrize("name", list(PLAN_DIMS))
def test_block_packing_inverts_to_the_packed_weights(name):
    """Every weight lands in some block's share, and unpacking the shares
    gives back pack_decode_weights' tensors exactly (bf16-valued weights)."""
    dims = PLAN_DIMS[name]
    packed = _random_packed(*dims)
    plan = K.block_plan(*dims, 132)
    buf = K.pack_block_weights(packed, plan)
    assert buf.dtype == torch.bfloat16 and buf.numel() == 8 * int(plan.blk[:, 3].sum())
    back = _unpack_block_weights(buf, plan)
    assert set(back) == set(packed)
    for k, v in packed.items():
        assert torch.equal(back[k], v), k
    # the padding reads zeros only: as many nonzeros as weights (randn has no zeros)
    assert int((buf != 0).sum()) == sum(v.numel() for v in packed.values()) + _dup_count(plan)


def _dup_count(plan):
    """Packed elements beyond one per weight (none: each weight is in one tile)."""
    idx = plan.index[plan.index != plan.zero]
    return idx.size - np.unique(idx).size


@pytest.mark.parametrize("name", ["svqwae", "test_net_cin5"])
def test_block_plan_spreads_each_stage_over_distinct_blocks(name):
    plan = K.block_plan(*PLAN_DIMS[name], 132)
    u = plan.units
    owner = np.repeat(np.arange(plan.n_blocks), plan.blk[:, 1] - plan.blk[:, 0])
    for kind in (K.U_GATE, K.U_OUT, K.U_POST1, K.U_LOGITS):
        for l in np.unique(u[u[:, 0] == kind, 1]):
            sel = (u[:, 0] == kind) & (u[:, 1] == l)
            n = {K.U_GATE: plan.ngt, K.U_OUT: plan.nout, K.U_POST1: plan.npt, K.U_LOGITS: plan.nlt}[kind]
            assert sorted(u[sel, 2]) == list(range(n))
            assert len(set(owner[sel])) == n  # one tile per block in a stage
    # skip blocks hold one skip tile each and nothing else; units in chain order
    assert list(u[: plan.nst, 0]) == [K.U_SKIP] * plan.nst and set(owner[: plan.nst]) == set(range(plan.nst))
    pos = np.where(u[:, 0] == K.U_GATE, 2 * u[:, 1], np.where(u[:, 0] == K.U_OUT, 2 * u[:, 1] + 1, 100 + u[:, 0]))
    for b0, b1, _, _ in plan.blk:
        assert list(pos[b0:b1]) == sorted(pos[b0:b1])
        # no gate tile right behind one of the three stages before it on the chain
        gates = pos[b0:b1][u[b0:b1, 0] == K.U_GATE]
        assert not set(gates) & {p + d for p in pos[b0:b1] for d in (1, 2, 3)}


@pytest.mark.parametrize("n_blocks", [20, 40])
def test_block_plan_raises_where_the_grid_cannot_hold_the_weights(n_blocks):
    """20 blocks are fewer than svqwae's 16 skip tiles plus 23 gate tiles; 40
    blocks would need ~600 KB of shared memory each. The message gives the
    sizes."""
    with pytest.raises(ValueError, match="blocks|bytes"):
        K.block_plan(*PLAN_DIMS["svqwae"], n_blocks)


def _emulate_block_products(net, packed, T, c_up, g_add, teach):
    """Teacher-mode logits computed as the bf16 kernel computes them, in
    f32: every product from the packed per-block tiles (unit_tiles), inputs
    laid out in the kernel's padded physical k order, the kernel's
    epilogues per tile. ``packed``'s tile weights must be bf16-valued."""
    L, B = net.n_layers, teach.shape[0]
    C, G, S, O = net.residual_channels, net.gate_channels, net.skip_out_channels, net.out_channels
    G2, cin = G // 2, 0 if c_up is None else c_up.shape[-1]
    plan = K.block_plan(L, C, G, S, O, cin, 132)
    tiles = _unit_tiles(K.pack_block_weights(packed, plan), plan)

    def pad(x, n):
        return torch.nn.functional.pad(x, (0, n - x.shape[-1]))

    offs = K._ring_offsets(net)
    ring = torch.zeros(offs[-1], B, plan.cp)
    logits = torch.empty(B, T, O)
    r8 = torch.arange(8)
    for t in range(T):
        x = teach[:, t].float()
        if net.scalar_input:
            h = x[:, None] * packed["w1"][0] + packed["b1"]
        else:
            h = packed["w1"][x.long().clamp(max=O - 1)] * (x < O)[:, None] + packed["b1"]
        skip = torch.zeros(B, S)
        for l in range(L):
            d = net.dilation(l)
            s0, s1 = offs[l] + t % (2 * d), offs[l] + (t + d) % (2 * d)
            X = torch.cat([ring[s0], ring[s1]] + ([pad(c_up[:, t], plan.cinp)] if cin else []) + [pad(h, plan.cp)], -1)
            act = torch.zeros(B, plan.g2p)
            for tile in range(plan.ngt):
                ab = X @ tiles[(K.U_GATE, l, tile)]
                p = 8 * tile + r8
                ok = p < G2
                p = p[ok]
                xa = ab[:, :8][:, ok] + packed["bconv"][l, p]
                xb = ab[:, 8:][:, ok] + packed["bconv"][l, G2 + p]
                if g_add is not None:
                    xa, xb = xa + g_add[l][:, p], xb + g_add[l][:, G2 + p]
                act[:, p] = torch.tanh(xa) * torch.sigmoid(xb)
            out = torch.cat([act @ tiles[(K.U_OUT, l, j)] for j in range(plan.nout)], -1)[:, :C]
            sk = torch.cat([act @ tiles[(K.U_SKIP, l, j)] for j in range(plan.nst)], -1)[:, :S]
            skip = skip + sk + packed["bskip"][l]
            ring[s0, :, :C] = h
            h = (out + packed["bout"][l] + h) * math.sqrt(0.5)
        ys = pad(torch.relu(skip * math.sqrt(1.0 / L)), plan.sp)
        y1 = torch.cat([ys @ tiles[(K.U_POST1, 0, j)] for j in range(plan.npt)], -1)[:, :S]
        y1 = pad(torch.relu(y1 + packed["bp1"]), plan.sp)
        lg = torch.cat([y1 @ tiles[(K.U_LOGITS, 0, j)] for j in range(plan.nlt)], -1)[:, :O]
        logits[:, t] = lg + packed["bp2"]
    return logits


@pytest.mark.parametrize("case", ["mulaw", "scalar", "mulaw_no_c_no_g"])
def test_emulated_block_products_match_the_plain_teacher_logits(case):
    """The packed per-block layout (gate pairs interleaved, K segments padded
    to 32, k permuted within each 32) computes the plain version's
    teacher-mode logits: f32 on bf16-valued tile weights, 1e-5 (only the
    summation order differs)."""
    if case == "mulaw_no_c_no_g":
        _, _, net = nets(seed=9, cin_channels=-1, gin_channels=-1, use_speaker_embedding=False, layers=6, stacks=2)
        rng = np.random.default_rng(9)
        c = g_add = None
        teach = torch.from_numpy(rng.integers(0, 256, (3, 20)).astype(np.int32))
    else:
        _, _, net, c, g, teach = _teacher_case(case == "scalar", seed=10)
        c, teach = torch.from_numpy(c), torch.from_numpy(teach)
        g_add = K.precompute_g_add(net, torch.from_numpy(g))
    packed = {k: v.to(torch.bfloat16).float() if k in K._FLAT else v for k, v in K.pack_decode_weights(net).items()}
    T = teach.shape[1]
    _, want = K.wavenet_decode_reference(net, packed, T, 0, c, g_add, teach, True, "float32")
    got = _emulate_block_products(net, packed, T, c, g_add, teach)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5)


def test_block_packing_raises_on_a_weight_of_another_shape():
    dims = PLAN_DIMS["test_net_cin5"]
    packed = _random_packed(*dims)
    packed["wout"] = packed["wout"][:, :-1]
    with pytest.raises(ValueError, match="wout has shape"):
        K.pack_block_weights(packed, K.block_plan(*dims, 132))


def test_check_and_timing_builds_are_libraries_of_their_own():
    """The WAE_JITTER / WAE_STAMPS builds of decode.cu never take the plain
    build's place, and k1_stages.py reads the stamp layout decode.cu
    writes."""
    from wavenet_autoencoders_tpu_torch.kernels import build

    paths = {d: build._lib_path("decode", d) for d in ((), ("WAE_JITTER",), ("WAE_STAMPS",))}
    assert len(set(paths.values())) == 3
    assert paths[()].name.startswith("libdecode-") and "+WAE_JITTER" in paths[("WAE_JITTER",)].name
    src = (Path(K.__file__).resolve().parent.parent / "csrc" / "decode.cu").read_text()
    for hook in ("WAE_JITTER", "WAE_STAMPS"):
        assert len(re.findall(rf"^#ifdef {hook}$", src, re.M)) == 1
    script = (Path(__file__).resolve().parent.parent / "k1_stages.py").read_text()
    want = {n: re.search(rf"#define {n} (\d+)", src).group(1) for n in ("STAMP_STEPS", "STAMP_U")}
    assert re.search(r"^STEPS, MAXU = (\d+), (\d+)", script, re.M).groups() == (want["STAMP_STEPS"], want["STAMP_U"])
