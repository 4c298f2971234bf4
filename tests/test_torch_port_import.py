"""The port's reference-checkpoint importer (``utils/torch_import.py``)
against the JAX package's: synthetic reference state dicts (the inverse
mapping, ``reference_state_dict``, of seeded port models) for vqwae (one
codebook), svqwae (sliced codebooks), inae and the plain vocoder; the
torch pickles of a training checkpoint and of a bare state dict through
``import_checkpoint``; the family rule; the three layout checks of
tests/test_torch_import.py on the port's ops; and the teacher-forced logits
of imported weights in both packages.

Tolerances: the imported trees bit for bit; the layout checks 1e-5 abs,
as tests/test_torch_import.py; svqwae logits, port against JAX, 1e-4 abs
(f32, T=64; the two frameworks' convs sum in other orders).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from _torch_port_util import TINY_SVQWAE  # noqa: E402
from wavenet_autoencoders_tpu.utils import torch_import as jti  # noqa: E402
from wavenet_autoencoders_tpu_torch.config import load_preset  # noqa: E402
from wavenet_autoencoders_tpu_torch.models import build_model  # noqa: E402
from wavenet_autoencoders_tpu_torch.utils import torch_import as ti  # noqa: E402
from wavenet_autoencoders_tpu_torch.utils.params import _flatten_tree, flatten_params, load_jax_params  # noqa: E402

UP = {"upsample_params": {"upsample_scales": [2, 2]}}
FAMILIES = {
    "vqwae": ("vqwae", TINY_SVQWAE),
    "svqwae": ("svqwae", TINY_SVQWAE),
    "inae": ("inae", TINY_SVQWAE),
    "vocoder": ("vocoder", "layers=4,stacks=2,residual_channels=16,gate_channels=32,skip_out_channels=16,"
                           "cin_channels=8,gin_channels=4,n_speakers=8,out_channels=32,quantize_channels=32"),
}


def _family(name, seed=3):
    preset, hp = FAMILIES[name]
    cfg = load_preset(preset, hp).replace(**UP)
    model = build_model(cfg, device="cpu", seed=seed)
    sd = ti.reference_state_dict(model, prefix="" if cfg.name == "wavenet_vocoder" else "wavenet.")
    return cfg, model, sd


def _assert_trees_equal(a, b):
    fa, fb = _flatten_tree(a), _flatten_tree(b)
    assert sorted(fa) == sorted(fb)
    for k in fa:
        x, y = np.asarray(fa[k]), np.asarray(fb[k])
        assert x.dtype == y.dtype and x.shape == y.shape, (k, x.dtype, y.dtype, x.shape, y.shape)
        np.testing.assert_array_equal(x, y, err_msg=k)


def _save(path, sd, wrap):
    tensors = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()}
    torch.save({"state_dict": tensors, "global_step": 3} if wrap else tensors, path)
    return path


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_import_equals_the_jax_import_bit_for_bit(family):
    cfg, model, sd = _family(family)
    if cfg.name == "wavenet_vocoder":
        tree, jtree = {"wavenet": ti.import_wavenet(sd, cfg.layers, prefix="")}, {
            "wavenet": jti.import_wavenet(sd, cfg.layers, prefix="")}
    else:
        tree, jtree = ti.import_vqvae(sd, n_layers=cfg.layers), jti.import_vqvae(sd, n_layers=cfg.layers)
        assert ("vq" in tree) == family.endswith("vqwae")
        assert "codebooks" in tree.get("vq", {}) if family == "svqwae" else "codebooks" not in tree.get("vq", {})
    _assert_trees_equal(tree, jtree)
    assert sorted(_flatten_tree(tree)) == sorted(flatten_params(model))
    # and it loads into a fresh port model as the weights it came from
    fresh = build_model(cfg, device="cpu", seed=4)
    load_jax_params(fresh, tree)
    for k, p in flatten_params(fresh).items():
        assert torch.equal(p, flatten_params(model)[k]), k


@pytest.mark.parametrize("wrap", [True, False], ids=["training_checkpoint", "bare_state_dict"])
def test_import_checkpoint_reads_the_torch_pickle(tmp_path, wrap):
    from wavenet_autoencoders_tpu.config import load_preset as jload_preset

    for family in ("svqwae", "vocoder"):
        cfg, model, sd = _family(family)
        path = _save(tmp_path / f"{family}.pth", sd, wrap)
        tree = ti.import_checkpoint(str(path), cfg)
        _assert_trees_equal(tree, jti.import_checkpoint(str(path), jload_preset(FAMILIES[family][0],
                                                                               FAMILIES[family][1])))
        fresh = build_model(cfg, device="cpu", seed=5)
        load_jax_params(fresh, tree)
        assert all(torch.equal(p, flatten_params(model)[k]) for k, p in flatten_params(fresh).items())


def test_unknown_family_raises_as_jax(tmp_path):
    from wavenet_autoencoders_tpu.config import load_preset as jload_preset

    cfg, _, sd = _family("svqwae")
    path = _save(tmp_path / "m.pth", sd, True)
    for mod, c in ((ti, cfg), (jti, jload_preset("ae"))):
        with pytest.raises(ValueError, match="no torch import rule for model"):
            mod.import_checkpoint(str(path), c.replace(name="model2"))


def test_conv_layout_matches_torch():
    from wavenet_autoencoders_tpu_torch.ops.conv import Conv1d, causal_conv1d_apply
    from wavenet_autoencoders_tpu_torch.utils.jax_random import PRNGKey

    torch.manual_seed(0)
    Cout, Cin, K, d, T = 6, 4, 3, 4, 32
    w, b, x = torch.randn(Cout, Cin, K), torch.randn(Cout), torch.randn(1, Cin, T)
    # reference-style causal conv: symmetric pad (k-1)*d then truncate
    y_t = F.conv1d(x, w, b, padding=(K - 1) * d, dilation=d)[:, :, :T]
    p = Conv1d(Cin, Cout, K, key=PRNGKey(0))
    with torch.no_grad():
        p.w.copy_(torch.from_numpy(ti._conv_w(w.numpy())))
        p.b.copy_(b)
        y = causal_conv1d_apply(p, x.transpose(1, 2), dilation=d)
    np.testing.assert_allclose(y.numpy(), y_t.transpose(1, 2).numpy(), atol=1e-5)


def test_weight_norm_fold_matches_torch():
    from wavenet_autoencoders_tpu_torch.ops.conv import WNConv1d, conv1d_apply
    from wavenet_autoencoders_tpu_torch.utils.jax_random import PRNGKey

    torch.manual_seed(1)
    conv = torch.nn.utils.weight_norm(torch.nn.Conv1d(4, 6, 3, bias=True, padding=1))
    sd = {f"c.{k}": v.detach().numpy() for k, v in conv.state_dict().items()}
    p = WNConv1d(4, 6, 3, key=PRNGKey(1))
    with torch.no_grad():
        for k, v in ti._wn_conv(sd, "c").items():
            getattr(p, k).copy_(torch.from_numpy(v))
        x = torch.randn(2, 4, 16)
        y = conv1d_apply(p, x.transpose(1, 2), padding=[(1, 1)])
        np.testing.assert_allclose(y.numpy(), conv(x).transpose(1, 2).numpy(), atol=1e-5)


def test_linear_layout_matches_torch():
    from wavenet_autoencoders_tpu_torch.ops.conv import Linear, linear_apply
    from wavenet_autoencoders_tpu_torch.utils.jax_random import PRNGKey

    torch.manual_seed(2)
    lin, x = torch.nn.Linear(8, 3), torch.randn(5, 8)
    p = Linear(8, 3, key=PRNGKey(2))
    with torch.no_grad():
        p.w.copy_(torch.from_numpy(ti._lin_w(lin.weight.numpy())))
        p.b.copy_(lin.bias)
        np.testing.assert_allclose(linear_apply(p, x).numpy(), lin(x).numpy(), atol=1e-5)


def test_imported_svqwae_logits_equal_jax():
    from wavenet_autoencoders_tpu.config import load_preset as jload_preset
    from wavenet_autoencoders_tpu.models.zoo import build_model as jbuild

    cfg, _, sd = _family("svqwae", seed=8)
    model = build_model(cfg, device="cpu", seed=9)
    load_jax_params(model, ti.import_vqvae(sd, n_layers=cfg.layers))
    jmodel = jbuild(jload_preset("svqwae", TINY_SVQWAE).replace(**UP))
    _, state = jmodel.init(jax.random.PRNGKey(0))
    params = jti.import_vqvae(sd, n_layers=cfg.layers)
    rng = np.random.default_rng(0)
    x = rng.integers(0, 32, (2, 64)).astype(np.int32)
    c = rng.standard_normal((2, 64, 39)).astype(np.float32)
    g = np.array([1, 6], np.int32)
    jy = jmodel.forward(params, state, jax.random.PRNGKey(0), x, c, g, train=False)[0]
    with torch.no_grad():
        y = model(torch.from_numpy(x).long(), torch.from_numpy(c), torch.from_numpy(g), train=False)[0]
    assert np.abs(np.asarray(jy)).max() > 0.1
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=0, atol=1e-4)


def test_reference_vqvae_checkpoint_logits_in_the_port():
    """tests/test_torch_e2e_parity.py's VQVAE case on the port: the
    reference's own modules, randomly initialised, their ``state_dict``
    imported; skipped where the reference snapshot is not mounted."""
    parity = pytest.importorskip("test_torch_e2e_parity")
    import vqvae_model

    torch.manual_seed(42)
    tm = vqvae_model.VQVAE(c_in=39, hid=64, K=256, wavenet=parity._build_ref_wavenet(), encoder_hid=256).eval()
    B, Tf = 2, 8
    T = Tf // 4 * 640
    rng = np.random.RandomState(0)
    x_np = parity._onehot_codes(rng, B, T)
    c_np = rng.randn(B, 39, Tf).astype(np.float32)
    g_np = rng.randint(0, 153, size=(B,))
    with torch.no_grad():
        y_t, vq_t, perp_t = tm(torch.from_numpy(x_np), torch.from_numpy(c_np), torch.from_numpy(g_np)[:, None])
        enc_t = tm.encode(torch.from_numpy(c_np))
    cfg = load_preset("vqwae")
    model = build_model(cfg, device="cpu")
    load_jax_params(model, ti.import_vqvae(parity._state_dict_np(tm), n_layers=20))
    with torch.no_grad():
        y, vq, perp = model(torch.from_numpy(x_np).transpose(1, 2), torch.from_numpy(c_np).transpose(1, 2),
                            torch.from_numpy(g_np), train=False)
        enc = model.encode(torch.from_numpy(c_np).transpose(1, 2))
    np.testing.assert_allclose(y.numpy(), y_t.transpose(1, 2).numpy(), atol=1e-4)
    np.testing.assert_allclose(float(vq), float(vq_t), rtol=1e-5)
    np.testing.assert_allclose(float(perp), float(perp_t), rtol=1e-5)
    np.testing.assert_allclose(enc.numpy(), enc_t.transpose(1, 2).numpy(), atol=1e-5)
