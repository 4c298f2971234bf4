"""The port's initial weights and reseed candidates are the JAX package's
draws (``utils/jax_random.py``), on the CPU at small widths.

- For every preset and every zoo name, narrowed (4 layers, widths 8-32),
  ``build_model(cfg, "cpu", seed)`` holds the parameters and the model
  state of the JAX ``build_model(cfg).init(PRNGKey(seed))``, leaf for
  leaf: the uniform-drawn leaves (plain convs, linears, codebooks) and the
  constants bit for bit, the normal-drawn leaves (weight-normed ``v`` and
  the ``g`` derived from it, embedding tables, Gumbel code tables) within
  1e-6 relative, ``jax_random.normal``'s stated tolerance.
- The port's train step draws the JAX step's reseed candidates:
  ``randint(fold_in(fold_in(fold_in(PRNGKey(seed + 1), step), 0x5EED),
  slice), (K,), 0, N)`` at steps at and past ``vq_reseed_start``, and two
  steps without injected candidates then equal the JAX steps with the
  tolerances of ``tests/test_torch_port_train_options.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402

from _torch_port_util import to_np  # noqa: E402
from test_torch_port_train import tiny_batch, torch_batch  # noqa: E402
from test_torch_port_train_options import RESEED, assert_close_to_jax, pair  # noqa: E402
from test_torch_port_zoo import TINY  # noqa: E402
from wavenet_autoencoders_tpu.config import load_preset as jpreset  # noqa: E402
from wavenet_autoencoders_tpu.models.zoo import build_model as jbuild  # noqa: E402
from wavenet_autoencoders_tpu_torch.config import available_presets, load_preset  # noqa: E402
from wavenet_autoencoders_tpu_torch.models import bottlenecks as bn  # noqa: E402
from wavenet_autoencoders_tpu_torch.models import build_model  # noqa: E402
from wavenet_autoencoders_tpu_torch.utils.params import _flatten_tree, flatten_params, flatten_state  # noqa: E402

NARROW = TINY + ",out_channels=32,quantize_channels=32"
RAW = TINY + ",gin_channels=-1,out_channels=30,quantize_channels=256"
# every zoo name of models/zoo.py:build_model, on a preset that builds it
NAMES = {
    "wavenet_vocoder": "vocoder", "wvae": "wvae", "ae": "ae", "vqvae": "svqwae", "inae": "inae",
    "inae1": "inae", "new_inae": "new_inae", "catae": "catae", "model": "ae", "ae_feat": "ae",
    "model2": "ae", "ae2": "ae", "model4": "ae", "ae4": "ae", "catae_feat": "ae", "cat_ae": "ae",
}
# the VQ-WAE options that change what init draws or holds as state
VQ_OPTIONS = {
    "plain": "sliced=false", "K1": "use_K1=true,K1=5", "ema_sliced": "ema=true",
    "ema_plain": "ema=true,sliced=false", "post_conv": "post_conv=true", "reseed": "vq_reseed=true",
    "plain_upsample": "upsample_net=UpsampleNetwork,cin_pad=0",
}
CASES = (
    [(f"preset_{p}", p, RAW if p == "vocoder_raw" else NARROW) for p in available_presets()]
    + [(f"name_{n}", p, f"{NARROW},name={n}") for n, p in NAMES.items()]
    + [(f"svqwae_{k}", "svqwae", f"{NARROW},{v}") for k, v in VQ_OPTIONS.items()]
)
UP = {"upsample_params": {"upsample_scales": [2, 2]}}
NORMAL_DRAWN = ("/v", "/g", "table")


def _normal_drawn(path: str) -> bool:
    return path.endswith(NORMAL_DRAWN) or "gumbel/codes/" in path


@pytest.mark.parametrize("name,preset,spec", CASES, ids=[c[0] for c in CASES])
def test_build_model_is_the_jax_init(name, preset, spec):
    seed = 1234
    jcfg, cfg = jpreset(preset, spec).replace(**UP), load_preset(preset, spec).replace(**UP)
    params, state = jbuild(jcfg).init(jax.random.PRNGKey(seed))
    model = build_model(cfg, device="cpu", seed=seed)
    assert type(model).__name__ == type(jbuild(jcfg)).__name__
    for want, got in ((_flatten_tree(to_np(params)), flatten_params(model)),
                      (_flatten_tree(to_np(state)), flatten_state(model))):
        assert set(got) == set(want)
        for path, w in want.items():
            g = got[path].detach().numpy()
            assert g.dtype == w.dtype and g.shape == w.shape, path
            if _normal_drawn(path):
                np.testing.assert_allclose(g, w, rtol=1e-6, atol=0, err_msg=path)
            else:
                np.testing.assert_array_equal(g, w, err_msg=path)


def test_seeds_give_other_draws_and_the_default_is_cfg_seed():
    cfg = load_preset("svqwae", NARROW).replace(**UP)
    a = flatten_params(build_model(cfg, device="cpu"))
    b = flatten_params(build_model(cfg, device="cpu", seed=cfg.seed))
    c = flatten_params(build_model(cfg, device="cpu", seed=cfg.seed + 1))
    for k in a:
        np.testing.assert_array_equal(a[k].detach().numpy(), b[k].detach().numpy())
    assert not torch.equal(a["encoder/lin/w"], c["encoder/lin/w"])


def _jax_candidates(seed, step, K, n, slices):
    rng = jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(seed + 1), step), 0x5EED)
    return [np.asarray(jax.random.randint(jax.random.fold_in(rng, i), (K,), 0, n)).astype(np.int64)
            for i in range(slices)]


def test_reseed_draws_are_jax_at_every_step_of_their_spans():
    """``ReseedDraws`` draws a span of steps at once: its candidates are the
    JAX step's at the ends of spans and past them, for slices of two sizes
    and frame counts that change between calls."""
    from wavenet_autoencoders_tpu_torch.config import Config
    from wavenet_autoencoders_tpu_torch.train.step import RESEED_SPAN, ReseedDraws

    cfg = Config(seed=1234)
    draws = ReseedDraws(cfg, [256, 5], "cpu")
    for step in (0, 1, RESEED_SPAN - 1, RESEED_SPAN, 3 * RESEED_SPAN + 7, 4000):
        for n in (800, 12345):
            pick = draws(step)
            for i, K in enumerate((256, 5)):
                rng = jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(cfg.seed + 1), step), 0x5EED)
                want = np.asarray(jax.random.randint(jax.random.fold_in(rng, i), (K,), 0, n))
                np.testing.assert_array_equal(pick(i, n).numpy(), want, err_msg=f"step {step} slice {i} n {n}")


@pytest.mark.parametrize("ema", [False, True], ids=["sliced", "ema"])
def test_the_step_draws_the_jax_reseed_candidates(ema, monkeypatch):
    """Three steps from ``vq_reseed_start`` = 1 without injected
    candidates: the candidates every step revives from are JAX's for its
    step, and the steps equal the JAX steps given ``PRNGKey(seed + 1)``, as
    the JAX loop gives them."""
    (jcfg, jmodel, js, jstep), (cfg, model, st, step) = pair(ema=ema, **{**RESEED, "vq_reseed_start": 1})
    drawn = []
    reseed_slice = bn.reseed_slice
    monkeypatch.setattr(bn, "reseed_slice", lambda *a, cand_idx: drawn.append(cand_idx) or reseed_slice(
        *a, cand_idx=cand_idx))
    key = jax.random.PRNGKey(cfg.seed + 1)
    b = tiny_batch(2)
    n = b["c"].shape[0] * b["c"].shape[1] // model.downsample
    reseeded = []
    for i in range(3):
        js, jm = jstep(js, b, key)
        st, m = step(st, torch_batch(b))
        assert_close_to_jax(js, jm, st, m, state=i == 0)
        want = _jax_candidates(cfg.seed, i, cfg.K, n, cfg.num_slices)
        got, drawn[:] = drawn[:], []
        assert len(got) == cfg.num_slices
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), w)
        reseeded.append(float(m["reseeded"]))
    assert reseeded[0] == 0 and reseeded[1] > 0, reseeded
