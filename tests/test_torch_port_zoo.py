"""The rest of the model zoo against the JAX package on the CPU, at tiny
widths (4 layers, widths 8-32), with the same JAX weights in both packages:
every family's training forward and ``encode``, three f32 train steps,
``batch_wavegen``, npz checkpoints in both directions, and the CLI's
``train`` -> ``infer`` -> ``synthesize`` for IN-WAE.

The Gumbel-softmax families draw their training noise from different
random streams in the two packages, so the tests hand the port the JAX
draws (``uniforms=``), reproduced from the JAX keys; in eval mode the
argmax path is deterministic and is compared directly.

Tolerances (f32): forward outputs 1e-4 abs, aux loss and perplexity 1e-5
relative, ``encode`` 1e-4 abs; train steps as tests/test_torch_port_train.py
(loss and grad norm 1e-5 relative, live parameters 2e-5 abs, Adam moments
1e-4 of the largest, EMA shadow 1e-6 abs); waveforms from the pinned
output bias exactly equal.
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _torch_port_util import to_np  # noqa: E402
from wavenet_autoencoders_tpu.config import load_preset as jpreset  # noqa: E402
from wavenet_autoencoders_tpu.models.zoo import build_model as jbuild  # noqa: E402
from wavenet_autoencoders_tpu.train import init_state as jinit  # noqa: E402
from wavenet_autoencoders_tpu.train import load_checkpoint as jload  # noqa: E402
from wavenet_autoencoders_tpu.train import make_train_step as jmake  # noqa: E402
from wavenet_autoencoders_tpu_torch.config import available_presets, load_preset  # noqa: E402
from wavenet_autoencoders_tpu_torch.models import build_model  # noqa: E402
from wavenet_autoencoders_tpu_torch.train.checkpoint import save_checkpoint  # noqa: E402
from wavenet_autoencoders_tpu_torch.train.step import init_state, make_train_step  # noqa: E402
from wavenet_autoencoders_tpu_torch.utils.params import (  # noqa: E402
    _flatten_tree,
    flatten_params,
    load_flat_params,
    load_jax_params,
)

TINY = (
    "layers=4,stacks=2,residual_channels=16,gate_channels=32,skip_out_channels=16,"
    "encoder_hid=16,cin_channels=8,gin_channels=4,n_speakers=8,K=8,num_slices=4,"
    "max_time_steps=128,hop_size=4,compute_dtype=float32"
)
MULAW = "out_channels=32,quantize_channels=32"
# 256 MoL bins, not the preset's 65536: at 65536 a bin's CDF difference is a
# near-cancelling difference of two sigmoids, whose one-ulp differences
# between the frameworks move single gradient elements by ~1e-2 relative
# (tests/test_torch_port_mixture.py holds that case in f64)
RAW = "gin_channels=-1,out_channels=30,quantize_channels=256"
# name: (preset, overrides, feature frames for T=32 samples, feature dim)
FAMILIES = {
    "wvae": ("wvae", MULAW, 16, 39),
    "ae": ("ae", MULAW, 8, 39),
    "inae": ("inae", MULAW, 16, 39),
    "inae1": ("inae", MULAW + ",name=inae1", 16, 39),
    "new_inae": ("new_inae", MULAW, 16, 39),
    "catae": ("catae", MULAW, 32, 39),
    "catae_hard": ("catae", MULAW + ",hard=true", 32, 39),
    "vocoder": ("vocoder", MULAW, 8, 8),
    "vocoder_raw": ("vocoder_raw", RAW + ",cin_pad=2", 12, 8),
    "vocoder_normal": ("vocoder_raw", RAW + ",output_distribution=Normal,cin_pad=0", 8, 8),
    "mfcc_ae": ("ae", "name=model2,cin_channels=39,frame_rate=50", 16, 39),
    "cat_mfcc_ae": ("ae", "name=cat_ae,cin_channels=39,frame_rate=25", 16, 39),
}
STOCHASTIC = ("catae", "catae_hard", "cat_mfcc_ae")
UP = {"upsample_params": {"upsample_scales": [2, 2]}, "clip_thresh": 1.0}


def cfgs(family, **over):
    preset, hp, _, _ = FAMILIES[family]
    spec = f"{TINY},{hp}"
    return (jpreset(preset, spec).replace(**UP, **over), load_preset(preset, spec).replace(**UP, **over))


def pair(family, seed=0, **over):
    """(jcfg, jmodel, JAX TrainState) and (cfg, model) with the same weights."""
    jcfg, cfg = cfgs(family, **over)
    jmodel = jbuild(jcfg)
    js = jinit(jcfg, jmodel, jax.random.PRNGKey(seed))
    model = build_model(cfg, device="cpu")
    load_jax_params(model, to_np(js.params))
    return (jcfg, jmodel, js), (cfg, model)


def batch(family, seed=0, B=2, T=32):
    """numpy batch: x/y codes (mu-law) or samples in [-1, 1] with both edge
    bins (scalar input), features, speaker ids, lengths with a masked tail."""
    cfg = cfgs(family)[1]
    _, _, frames, dim = FAMILIES[family]
    rng = np.random.default_rng(seed)
    if cfg.is_mulaw_quantize:
        x = rng.integers(0, 32, (B, T)).astype(np.int32)
        y = x[..., None]
    else:
        x = rng.uniform(-1.0, 1.0, (B, T)).astype(np.float32)
        x[0, 3], x[1, 7] = 1.0, -1.0
        y = x[..., None]
    b = {"x": x, "y": y, "c": rng.standard_normal((B, frames, dim)).astype(np.float32),
         "lengths": np.array([T, T - 5], np.int32)[:B]}
    if cfg.gin_channels > 0:  # as the collator: no g without global conditioning
        b["g"] = np.array([1, 5], np.int32)[:B]
    return b


def jax_x(cfg, x):
    return jnp.asarray(x) if cfg.is_mulaw_quantize else jnp.asarray(x)[..., None]


def port_x(cfg, x):
    return torch.from_numpy(x).long() if cfg.is_mulaw_quantize else torch.from_numpy(x)[..., None]


def gumbel_uniforms(rng, slices, shape):
    """The uniforms the JAX CatWAE / CatMfccAE forward draws from ``rng``
    (the forward splits once, gumbel_apply once per slice)."""
    _, sk = jax.random.split(rng)
    out = []
    for _ in range(slices):
        sk, ski = jax.random.split(sk)
        out.append(torch.tensor(np.asarray(jax.random.uniform(ski, shape, minval=1e-10, maxval=1.0))))
    return out


def latent_frames(model, frames):
    return frames // getattr(model, "downsample", 1)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_forward_matches_jax(family):
    (jcfg, jmodel, js), (cfg, model) = pair(family)
    b = batch(family)
    rng = jax.random.PRNGKey(3)
    g = b.get("g")
    y, aux, perp, _ = jmodel.forward(js.params, js.model_state, rng, jax_x(jcfg, b["x"]), jnp.asarray(b["c"]),
                                     None if g is None else jnp.asarray(g), train=True)
    kw = {}
    if family in STOCHASTIC:
        shape = (2, latent_frames(model, b["c"].shape[1]), cfg.K)
        kw["uniforms"] = gumbel_uniforms(rng, cfg.num_slices, shape)
    with torch.no_grad():
        y2, aux2, perp2 = model.forward(port_x(cfg, b["x"]), torch.from_numpy(b["c"]),
                                        None if g is None else torch.from_numpy(g), train=True, **kw)
    assert y2.shape == y.shape
    np.testing.assert_allclose(y2.numpy(), np.asarray(y), atol=1e-4)
    np.testing.assert_allclose(float(aux2), float(aux), rtol=1e-5)
    np.testing.assert_allclose(float(perp2), float(perp), rtol=1e-5)
    if family in STOCHASTIC:
        assert float(perp) > 1.0  # the draws picked more than one code


@pytest.mark.parametrize("with_tar", [False, True], ids=["self", "tar_c"])
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_encode_matches_jax(family, with_tar):
    (_, jmodel, js), (_, model) = pair(family, seed=1)
    b = batch(family, seed=1)
    tar = np.random.default_rng(7).standard_normal((2, b["c"].shape[1] + 4, b["c"].shape[2])).astype(np.float32)
    want = jmodel.encode(js.params, js.model_state, jnp.asarray(b["c"]),
                         tar_c=jnp.asarray(tar) if with_tar else None)
    with torch.no_grad():
        got = model.encode(torch.from_numpy(b["c"]), tar_c=torch.from_numpy(tar) if with_tar else None)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


def test_speaker_code_matches_jax():
    (_, jmodel, js), (_, model) = pair("new_inae", seed=2)
    c = batch("new_inae", seed=2)["c"]
    want = jmodel.speaker_code(js.params, jnp.asarray(c))
    with torch.no_grad():
        got = model.speaker_code(torch.from_numpy(c))
    assert got.shape == (2, 64)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def flat(tree):
    return _flatten_tree(to_np(tree))


def assert_states_close(js, st, live_floor=0.8):
    """Live parameters, Adam moments, EMA shadow and counters (as
    tests/test_torch_port_train.py: elements whose gradient is zero in exact
    arithmetic are f32 noise in both packages and are left out of the
    parameter check)."""
    jmu, jnu = flat(js.opt_state.inner_state[0].mu), flat(js.opt_state.inner_state[0].nu)
    mu_max = max(np.abs(v).max() for v in jmu.values())
    nu_max = max(np.abs(v).max() for v in jnu.values())
    jp, je = flat(js.params), flat(js.ema_params)
    pp = {k: v.detach().numpy() for k, v in flatten_params(st.model).items()}
    assert set(jp) == set(pp)
    n_live = 0
    for k in pp:
        live = np.abs(jmu[k]) > 1e-5 * mu_max
        n_live += live.sum()
        np.testing.assert_allclose(pp[k][live], jp[k][live], atol=2e-5, rtol=0, err_msg=k)
        np.testing.assert_allclose(st.mu[k].numpy(), jmu[k], atol=1e-4 * mu_max, rtol=0, err_msg=k)
        np.testing.assert_allclose(st.nu[k].numpy(), jnu[k], atol=1e-4 * nu_max, rtol=0, err_msg=k)
        np.testing.assert_allclose(st.ema[k].numpy(), je[k], atol=1e-6, rtol=0, err_msg=k)
    assert n_live > live_floor * sum(v.size for v in pp.values())
    assert st.step == int(js.step)


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
@pytest.mark.parametrize("family", ["inae", "new_inae", "catae", "vocoder_raw"])
def test_three_f32_train_steps_match_jax(family, fused):
    (jcfg, jmodel, js), (cfg, model) = pair(family, fused_stack=fused)
    jstep, step = jmake(jcfg, jmodel, donate=False), make_train_step(cfg, model)
    st = init_state(cfg, model)
    b = batch(family)
    tb = {k: torch.from_numpy(v) for k, v in b.items()}
    forward = model.forward
    for i in range(3):
        if family in STOCHASTIC:
            # the JAX step's forward key: fold_in(rng, step)
            shape = (2, latent_frames(model, b["c"].shape[1]), cfg.K)
            u = gumbel_uniforms(jax.random.fold_in(jax.random.PRNGKey(1), i), cfg.num_slices, shape)
            model.forward = lambda *a, _u=u, **kw: forward(*a, **{**kw, "uniforms": _u})
        js, jm = jstep(js, b, jax.random.PRNGKey(1))
        st, m = step(st, tb)
        for k in ("loss", "recon_loss", "aux_loss", "perplexity", "grad_norm", "lr"):
            np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-5, err_msg=f"step {i} {k}")
    # at tau = 0.1 the Gumbel softmax is nearly one-hot, so what reaches the
    # encoder and the unpicked codes is below 1e-5 of the largest gradient
    assert_states_close(js, st, live_floor=0.7 if family in STOCHASTIC else 0.8)


def test_fused_step_gradient_reaches_the_speaker_encoder():
    """new_inae conditions the stack on the speaker code, so K3's dg_add must
    carry the gradient into spk.*: one fused step's spk.* gradients equal
    the unfused step's."""
    grads = {}
    for fused in (False, True):
        _, (cfg, model) = pair("new_inae", fused_stack=fused)
        b = {k: torch.from_numpy(v) for k, v in batch("new_inae", seed=4).items()}
        make_train_step(cfg, model)(init_state(cfg, model), b)
        grads[fused] = {k: p.grad.clone() for k, p in model.named_parameters() if k.startswith("spk.")}
    assert len(grads[True]) == 8
    for k, g in grads[False].items():
        assert float(g.abs().max()) > 0, k
        np.testing.assert_allclose(grads[True][k].numpy(), g.numpy(), atol=1e-6, rtol=1e-4, err_msg=k)


def test_scalar_batch_and_feature_ae_steps_are_finite():
    """The raw vocoder's MoL step, the MoG step, and the feature AEs' MSE
    step, each from its own first batch, give finite metrics."""
    for family in ("vocoder_normal", "mfcc_ae", "cat_mfcc_ae"):
        _, (cfg, model) = pair(family)
        b = {k: torch.from_numpy(v) for k, v in batch(family).items()}
        st, m = make_train_step(cfg, model)(init_state(cfg, model), b)
        assert all(np.isfinite(float(v)) for v in m.values()), family


def _pin_output(params, model):
    """Zero post2's weight (g = 0) and bias one class, in both packages."""
    post2 = params["wavenet"]["post2"]
    post2["g"] = jnp.zeros_like(post2["g"])
    post2["b"] = jnp.zeros_like(post2["b"]).at[20].set(50.0)
    with torch.no_grad():
        model.wavenet.post2.g.zero_()
        model.wavenet.post2.b.zero_()
        model.wavenet.post2.b[20] = 50.0
    return params


@pytest.mark.parametrize("family", ["inae", "new_inae"])
def test_batch_wavegen_with_tar_c_and_pinned_bias_matches_jax(family):
    from wavenet_autoencoders_tpu.eval.synthesize import batch_wavegen as jwavegen
    from wavenet_autoencoders_tpu_torch.eval.synthesize import batch_wavegen

    (jcfg, jmodel, js), (cfg, model) = pair(family, seed=5)
    params = _pin_output(dict(js.params), model)
    c = np.random.default_rng(5).standard_normal((2, 18, 39)).astype(np.float32)  # padded to 18 (ds 2)
    tar = np.random.default_rng(6).standard_normal((1, 22, 39)).astype(np.float32)
    g = np.array([1, 4], np.int32)
    for tar_c in (tar, None):
        want = jwavegen(jcfg, jmodel, params, js.model_state, c, g, tar_c=tar_c)
        got = batch_wavegen(cfg, model, c, g, tar_c=tar_c, device="cpu")
        assert got.shape == want.shape == (2, 36)
        np.testing.assert_array_equal(got, want)


def test_batch_wavegen_drops_speaker_ids_without_global_conditioning():
    """``run_synthesis_list`` passes speaker ids to every model; vocoder_raw
    (gin = -1) has no use for them, and its draws do not depend on them."""
    from wavenet_autoencoders_tpu_torch.eval.synthesize import batch_wavegen

    _, (cfg, model) = pair("vocoder_raw", seed=3)
    c = np.random.default_rng(3).standard_normal((2, 8, 8)).astype(np.float32)
    with_ids = batch_wavegen(cfg, model, c, np.array([1, 4], np.int32), device="cpu")
    without = batch_wavegen(cfg, model, c, None, device="cpu")
    assert with_ids.shape == (2, 16) and np.isfinite(with_ids).all()
    np.testing.assert_array_equal(with_ids, without)


def test_new_inae_decode_conditions_on_the_target_speaker_code():
    """The pinned bias hides g; here K1's plain version, teacher-forced, with
    g = speaker_code(tar_c) against the JAX WaveNet.apply on the same code."""
    from wavenet_autoencoders_tpu_torch.kernels import decode as K

    (_, jmodel, js), (_, model) = pair("new_inae", seed=8)
    rng = np.random.default_rng(8)
    c = rng.standard_normal((2, 16, 39)).astype(np.float32)
    tar = rng.standard_normal((2, 20, 39)).astype(np.float32)
    lat_j = jmodel.encode(js.params, {}, jnp.asarray(c), tar_c=jnp.asarray(tar))
    g_j = jmodel.speaker_code(js.params, jnp.asarray(tar))
    T = lat_j.shape[1] * 4
    ids = rng.integers(0, 32, (2, T)).astype(np.int32)
    want = jmodel.wavenet.apply(js.params["wavenet"], jax.nn.one_hot(ids, 32), lat_j, g_j)
    net = model.wavenet
    with torch.no_grad():
        lat = model.encode(torch.from_numpy(c), tar_c=torch.from_numpy(tar))
        g_add = K.precompute_g_add(net, model.speaker_code(torch.from_numpy(tar)))
        _, got = K.wavenet_decode(net, K.pack_decode_weights(net), T, 0, net._align_conditioning(lat, T), g_add,
                                  torch.from_numpy(ids), True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


@pytest.mark.parametrize("family", ["wvae", "inae1", "new_inae", "catae", "vocoder_raw", "mfcc_ae", "cat_mfcc_ae"])
def test_checkpoints_load_in_both_directions(family, tmp_path):
    from wavenet_autoencoders_tpu.train.checkpoint import save_pytree

    (jcfg, jmodel, js), (cfg, model) = pair(family, seed=9)
    # JAX npz -> port
    path = tmp_path / "jax.npz"
    save_pytree({"params": js.params, "step": np.int64(0)}, path)
    fresh = build_model(cfg, device="cpu", seed=123)
    load_flat_params(fresh, np.load(path), prefix="params/")
    for k, v in flatten_params(fresh).items():
        np.testing.assert_array_equal(v.detach().numpy(), flat(js.params)[k], err_msg=k)
    # port npz (after one step) -> JAX
    st, _ = make_train_step(cfg, fresh)(init_state(cfg, fresh), {k: torch.from_numpy(v)
                                                                 for k, v in batch(family).items()})
    back = jload(jinit(jcfg, jmodel, jax.random.PRNGKey(4)), save_checkpoint(st, tmp_path / "port"))
    assert int(back.step) == 1
    for k, v in flatten_params(fresh).items():
        np.testing.assert_array_equal(flat(back.params)[k], v.detach().numpy(), err_msg=k)
        np.testing.assert_array_equal(flat(back.ema_params)[k], st.ema[k].numpy(), err_msg=k)


@pytest.mark.parametrize("preset", available_presets())
def test_every_preset_builds(preset):
    from wavenet_autoencoders_tpu.models.zoo import build_model as jbuild_model

    cfg = load_preset(preset, "layers=2,stacks=1,encoder_hid=8")
    model = build_model(cfg, device="cpu")
    assert type(model).__name__ == type(jbuild_model(jpreset(preset, "layers=2,stacks=1"))).__name__


def _dump(root, n_utts=6, frames=40, hop=4):
    """train / test dumps of 2 speakers (V001, V002): mu-law codes and
    39-dim features."""
    rng = np.random.default_rng(6)
    lines, test = [], []
    for i in range(n_utts):
        d = root / "dump" / "english" / "train_no_dev" / f"V00{i % 2 + 1}_{i}"
        d.mkdir(parents=True)
        np.save(d / "wave.npy", rng.integers(0, 32, frames * hop))
        np.save(d / "mfcc.norm.npy", rng.standard_normal((frames, 39)).astype(np.float32))
        lines.append(f"{d}/|{frames}|{i % 2}|dummy")
    (root / "dump" / "train.txt").write_text("\n".join(lines) + "\n")
    for i in range(3):
        d = root / "dump" / "english" / "test" / f"V00{i % 2 + 1}_{100 + i}"
        d.mkdir(parents=True)
        np.save(d / "mfcc.norm.npy", rng.standard_normal((18 + 4 * i, 39)).astype(np.float32))
        test.append(d)
    return root / "dump", test


def test_cli_inae_train_infer_synthesize_on_cpu(tmp_path):
    from scipy.io import wavfile

    from wavenet_autoencoders_tpu_torch.cli.main import main

    dump, test = _dump(tmp_path)
    hp = f"{TINY},{MULAW},batch_size=2,fused_stack=true," + 'upsample_params={"upsample_scales": [2, 4]}'
    ckpt = tmp_path / "exp"
    main(["train", "--preset", "inae", "--hparams", hp, "--device", "cpu", str(dump), str(ckpt), "--max-steps", "2"])
    recs = [json.loads(line) for line in (ckpt / "logs" / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in recs if r["phase"] == "train_no_dev"][:2] == [1, 2]
    assert all(np.isfinite(r["loss"]) for r in recs if "loss" in r)
    path = str(ckpt / "checkpoint_step000000002.npz")

    scp = tmp_path / "scp.json"
    scp.write_text(json.dumps([[f"wav/{d.name}.wav", f"{d}/"] for d in test]))
    main(["infer", "--preset", "inae", "--hparams", hp, "--device", "cpu", path, str(scp), str(tmp_path / "abx")])
    out = np.loadtxt(tmp_path / "abx" / "2019" / "english" / "test" / f"{test[0].name}.txt")
    assert out.shape == (9, 8) and np.isfinite(out).all()
    assert not (tmp_path / "abx" / "bitrate.json").exists()  # a continuous latent has no bitrate

    syn = tmp_path / "synthesis.txt"
    syn.write_text("".join(f"{d.name} V00{2 - i % 2}\n" for i, d in enumerate(test)))
    sp2ind = tmp_path / "sp2ind.json"
    sp2ind.write_text(json.dumps({"V001": 0, "V002": 1}))
    main(["synthesize", "--preset", "inae", "--hparams", hp, "--device", "cpu", "--batch", "2", path,
          str(dump / "english" / "test"), str(tmp_path / "syn"), str(syn), str(sp2ind), "english",
          "--train-dump-root", str(dump / "english" / "train_no_dev")])
    for i, d in enumerate(test):
        sr, w = wavfile.read(tmp_path / "syn" / "2019" / "english" / "test" / f"V00{2 - i % 2}_{d.name.split('_')[1]}.wav")
        assert len(w) == (18 + 4 * i) * 4 and np.isfinite(w.astype(np.float64)).all()
