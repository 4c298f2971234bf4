"""The SVQ-WAE serving slice end to end at a tiny svqwae, with the same JAX
weights in both packages: encode, upsample + teacher-forced decode,
``batch_wavegen`` with a pinned output bias, ``export_representations``
and the port's CLI on a JAX-written npz checkpoint.

Tolerances: 1e-5 abs on encoder/VQ outputs (f32 on the CPU; the codes are
codebook rows, so equal indices give equal rows); ABX txt files are
written '%.6f', so they may differ by one unit of the last digit; 1e-4 on
logits; waveforms from deterministic sampling must be equal.
"""
import json
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _torch_port_util import models  # noqa: E402

K_PIN = 20  # the class the pinned output bias selects


def _feats(seed, B, T):
    return np.random.default_rng(seed).standard_normal((B, T, 39)).astype(np.float32)


@pytest.mark.parametrize("pre_vq", [False, True])
def test_encode_matches_jax(pre_vq):
    _, jmodel, params, state, _, model = models(seed=0)
    c = _feats(0, 2, 24)
    want = jmodel.encode(params, state, jnp.asarray(c), pre_vq=pre_vq)
    with torch.no_grad():
        got = model.encode(torch.from_numpy(c), pre_vq=pre_vq)
    assert got.shape == (2, 6, 8)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_upsample_and_teacher_decode_match_jax_apply():
    from wavenet_autoencoders_tpu_torch.kernels import decode as K

    _, jmodel, params, state, _, model = models(seed=1)
    c = _feats(1, 2, 16)
    lat_j = jmodel.encode(params, state, jnp.asarray(c))
    T = lat_j.shape[1] * 4
    ids = np.random.default_rng(1).integers(0, 32, (2, T)).astype(np.int32)
    g = np.array([2, 5], np.int32)
    want = jmodel.wavenet.apply(params["wavenet"], jax.nn.one_hot(ids, 32), lat_j, jnp.asarray(g))
    net = model.wavenet
    with torch.no_grad():
        lat = model.encode(torch.from_numpy(c))
        c_up = net._align_conditioning(lat, T)
        g_add = K.precompute_g_add(net, torch.from_numpy(g))
        _, got = K.wavenet_decode(net, K.pack_decode_weights(net), T, 0, c_up, g_add,
                                  torch.from_numpy(ids), True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


def _pin_output(params, model):
    """Zero post2's weight (g = 0) and bias one class, in both packages."""
    post2 = params["wavenet"]["post2"]
    post2["g"] = jnp.zeros_like(post2["g"])
    post2["b"] = jnp.zeros_like(post2["b"]).at[K_PIN].set(50.0)
    with torch.no_grad():
        model.wavenet.post2.g.zero_()
        model.wavenet.post2.b.zero_()
        model.wavenet.post2.b[K_PIN] = 50.0
    return params


def test_batch_wavegen_with_pinned_bias_matches_jax():
    from wavenet_autoencoders_tpu.eval.synthesize import batch_wavegen as jwavegen
    from wavenet_autoencoders_tpu_torch.eval.synthesize import batch_wavegen

    jcfg, jmodel, params, state, cfg, model = models(seed=2)
    params = _pin_output(params, model)
    c = _feats(2, 2, 18)  # padded to 20 frames -> 5 latent frames -> 20 samples
    g = np.array([1, 4], np.int32)
    want = jwavegen(jcfg, jmodel, params, state, c, g)
    got = batch_wavegen(cfg, model, c, g, device="cpu")
    assert got.shape == want.shape == (2, 20)
    np.testing.assert_allclose(got, want, atol=1e-6)


def _corpus(root: Path, lengths):
    test = root / "dump" / "english" / "test"
    rows = []
    for i, n in enumerate(lengths):
        d = test / f"V00{i % 2 + 1}_{100 + i}"
        d.mkdir(parents=True)
        np.save(d / "mfcc.norm.npy", _feats(10 + i, 1, n)[0])
        rows.append([f"wav/{d.name}.wav", str(d) + "/"])
    scp = root / "test_src_dst.json"
    scp.write_text(json.dumps(rows))
    return scp, [Path(r[1]).name for r in rows]


def _compare_exports(dst_a: Path, dst_b: Path, names):
    for name in names:
        a = np.loadtxt(dst_a / "2019" / "english" / "test" / f"{name}.txt")
        b = np.loadtxt(dst_b / "2019" / "english" / "test" / f"{name}.txt")
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, atol=1.5e-6)
    ba = json.loads((dst_a / "bitrate.json").read_text())
    bb = json.loads((dst_b / "bitrate.json").read_text())
    # bitrate keys each frame by its '%.6f' text; a frame is the
    # straight-through value z + (q - z), whose last bit follows z, so one
    # frame may round across a boundary in one package and not the other
    assert ba["n_frames"] == bb["n_frames"]
    assert abs(ba["n_distinct"] - bb["n_distinct"]) <= 2
    np.testing.assert_allclose(ba["bitrate"], bb["bitrate"], rtol=0.05)


def test_export_representations_matches_jax(tmp_path):
    from wavenet_autoencoders_tpu.eval.infer import export_representations as jexport
    from wavenet_autoencoders_tpu_torch.eval.infer import export_representations

    jcfg, jmodel, params, state, cfg, model = models(seed=3)
    scp, names = _corpus(tmp_path, [37, 80, 230])
    assert jexport(jcfg, jmodel, params, state, str(scp), str(tmp_path / "jax")) == 3
    assert export_representations(cfg, model, str(scp), str(tmp_path / "port"), device="cpu") == 3
    _compare_exports(tmp_path / "jax", tmp_path / "port", names)


def _jax_checkpoint(tmp_path, params, state, jcfg):
    from wavenet_autoencoders_tpu.train.checkpoint import save_pytree

    ckpt = tmp_path / "checkpoint_step000000010.npz"
    save_pytree({"params": params, "model_state": state, "step": np.int64(10)}, ckpt)
    cfg_path = tmp_path / "config.json"
    jcfg.save(cfg_path)
    return ckpt, cfg_path


def test_cli_infer_loads_a_jax_checkpoint(tmp_path):
    from wavenet_autoencoders_tpu.eval.infer import export_representations as jexport
    from wavenet_autoencoders_tpu_torch.cli.main import main

    jcfg, jmodel, params, state, _, _ = models(seed=4)
    ckpt, cfg_path = _jax_checkpoint(tmp_path, params, state, jcfg)
    scp, names = _corpus(tmp_path, [41, 64])
    jexport(jcfg, jmodel, params, state, str(scp), str(tmp_path / "jax"))
    main(["infer", "--preset", str(cfg_path), "--device", "cpu", str(ckpt), str(scp), str(tmp_path / "port")])
    _compare_exports(tmp_path / "jax", tmp_path / "port", names)


def test_cli_synthesize_matches_jax_cli_with_pinned_bias(tmp_path):
    from scipy.io import wavfile

    from wavenet_autoencoders_tpu.cli.main import main as jmain
    from wavenet_autoencoders_tpu_torch.cli.main import main

    jcfg, _, params, state, _, model = models(seed=5)
    params = _pin_output(params, model)
    ckpt, cfg_path = _jax_checkpoint(tmp_path, params, state, jcfg)
    _, names = _corpus(tmp_path, [18, 18, 26])
    dump = tmp_path / "dump" / "english" / "test"
    syn = tmp_path / "synthesis.txt"
    syn.write_text("".join(f"{n} V002\n" for n in names))
    sp2ind = tmp_path / "sp2ind.json"
    sp2ind.write_text(json.dumps({"V001": 0, "V002": 1}))
    common = ["--preset", str(cfg_path), str(ckpt), str(dump)]
    tail = [str(syn), str(sp2ind), "english", "--batch", "2"]
    jmain(["synthesize", *common, str(tmp_path / "jax"), *tail])
    main(["synthesize", "--device", "cpu", *common, str(tmp_path / "port"), *tail])
    for n in names:
        f = f"2019/english/test/V002_{n.split('_')[1]}.wav"
        _, a = wavfile.read(tmp_path / "jax" / f)
        _, b = wavfile.read(tmp_path / "port" / f)
        assert len(b) == (20 if n != names[2] else 28)
        np.testing.assert_array_equal(a, b)


def test_flat_params_round_trip_the_jax_tree_paths():
    from wavenet_autoencoders_tpu.train.checkpoint import _flatten
    from wavenet_autoencoders_tpu_torch.utils.params import flatten_params

    _, _, params, _, _, model = models(seed=6)
    want = _flatten(params)
    got = {k: v.detach().numpy() for k, v in flatten_params(model).items()}
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
