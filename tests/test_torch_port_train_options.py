"""Training options of the VQ bottleneck, port against JAX package on the
CPU at the tiny svqwae (``_torch_port_util.TINY_SVQWAE``: 4 layers, widths
8-32): train steps with EMA codebooks and with dead-code reseed (the
threshold and usage decay set so that unused codes die after one step, the
port's step drawing the JAX step's reseed candidates from the same key),
and EMA-codebook checkpoints read by the other package.

Tolerances (f32): loss and grad norm 1e-4 relative; parameters (the
elements whose Adam moment is not f32 noise, as in
tests/test_torch_port_train.py), codebooks, cluster sizes, ``ema_w`` and
usage 2e-4 abs after the first step; the number of reseeded codes exactly;
``encode`` from a checkpoint 1e-4 abs. A second step is held by its
metrics only: an encoder bias whose first gradient is f32 noise (instance
norm removes a constant shift exactly) moves by ±lr in either package, and
its second gradient is real, so the moment filter cannot leave it out.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402

from _torch_port_util import tiny_cfgs, to_np  # noqa: E402
from test_torch_port_train import LIVE_MU, flat, port_params, tiny_batch, torch_batch  # noqa: E402
from wavenet_autoencoders_tpu.models.zoo import build_model as jbuild  # noqa: E402
from wavenet_autoencoders_tpu.train import init_state as jinit  # noqa: E402
from wavenet_autoencoders_tpu.train import load_checkpoint as jload  # noqa: E402
from wavenet_autoencoders_tpu.train import make_train_step as jmake  # noqa: E402
from wavenet_autoencoders_tpu.train import save_checkpoint as jsave  # noqa: E402
from wavenet_autoencoders_tpu_torch.models import build_model  # noqa: E402
from wavenet_autoencoders_tpu_torch.train.checkpoint import load_checkpoint, save_checkpoint  # noqa: E402
from wavenet_autoencoders_tpu_torch.train.step import init_state, make_train_step  # noqa: E402
from wavenet_autoencoders_tpu_torch.utils.params import flatten_state, load_jax_params  # noqa: E402

TOL = 2e-4
# unused codes die after one step: usage 0.5/K < 0.9/K
RESEED = {"vq_reseed": True, "vq_reseed_start": 0, "vq_reseed_thresh": 0.9, "vq_reseed_decay": 0.5}


def pair(**over):
    """JAX (cfg, model, state, step_fn) and port (cfg, model, state, step_fn)
    from the same JAX init (key 0): parameters and model state."""
    jcfg, cfg = tiny_cfgs()
    over = {"clip_thresh": 1.0, **over}
    jcfg, cfg = jcfg.replace(**over), cfg.replace(**over)
    jmodel = jbuild(jcfg)
    js = jinit(jcfg, jmodel, jax.random.PRNGKey(0))
    model = build_model(cfg, device="cpu").train()
    load_jax_params(model, to_np(js.params), to_np(js.model_state))
    return (jcfg, jmodel, js, jmake(jcfg, jmodel, donate=False)), (cfg, model, init_state(cfg, model),
                                                                    make_train_step(cfg, model))


def assert_close_to_jax(js, jm, st, m, state=True):
    """Metrics, and with ``state`` the parameters and the model state."""
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-4)
    np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]), rtol=1e-4)
    assert float(m["reseeded"]) == float(jm["reseeded"])
    if not state:
        return
    jmu = flat(js.opt_state.inner_state[0].mu)
    mu_max = max(np.abs(v).max() for v in jmu.values())
    jp = flat(js.params)
    for k, v in port_params(st).items():
        sel = np.abs(jmu[k]) > LIVE_MU * mu_max
        if k.startswith("vq/"):  # codebook rows may be reseeded: every element
            sel = np.ones_like(sel)
        np.testing.assert_allclose(v[sel], jp[k][sel], atol=TOL, rtol=0, err_msg=k)
    jstate = flat(js.model_state)
    pstate = {k: v.numpy() for k, v in flatten_state(st.model).items()}
    assert set(pstate) == set(jstate) and pstate
    for k, v in pstate.items():
        np.testing.assert_allclose(v, jstate[k], atol=TOL, rtol=0, err_msg=k)


@pytest.mark.parametrize("over", [
    {"ema": True},
    {"ema": True, "sliced": False},
], ids=["ema_sliced", "ema_plain"])
def test_ema_codebook_steps_match_jax(over):
    (jcfg, jmodel, js, jstep), (cfg, model, st, step) = pair(**over)
    assert not any(k.startswith("vq/") for k in port_params(st))
    for i in range(2):
        b = tiny_batch(i)
        js, jm = jstep(js, b, jax.random.PRNGKey(1))
        st, m = step(st, torch_batch(b))
        assert_close_to_jax(js, jm, st, m, state=i == 0)
    # the statistics moved from their zero init
    assert float(st.model.vq.cluster_size[0].sum()) > 0


@pytest.mark.parametrize("ema", [False, True], ids=["sliced", "ema"])
def test_reseed_steps_match_jax(ema):
    """Two steps: in step 1 the unused codes die and are revived from the
    batch's pre-VQ codes with the JAX package's candidates: the port's step
    draws them under ``fold_in(PRNGKey(cfg.seed + 1), step)``, and the JAX
    step is given that key, as the JAX loop gives it."""
    (jcfg, jmodel, js, jstep), (cfg, model, st, step) = pair(ema=ema, **RESEED)
    assert jcfg.seed == cfg.seed
    key = jax.random.PRNGKey(cfg.seed + 1)
    b = tiny_batch(2)
    reseeded = []
    for i in range(2):
        js, jm = jstep(js, b, key)
        st, m = step(st, torch_batch(b))
        assert_close_to_jax(js, jm, st, m, state=i == 0)
        reseeded.append(float(m["reseeded"]))
    assert reseeded[0] > 0, reseeded


def _encode_pair(jmodel, js, model, c):
    want = np.asarray(jmodel.encode(js.params, js.model_state, c))
    with torch.no_grad():
        got = model.encode(torch.from_numpy(c)).numpy()
    return got, want


def test_jax_ema_checkpoint_loads_in_port(tmp_path):
    (jcfg, jmodel, js, jstep), (cfg, _, _, _) = pair(ema=True, **RESEED)
    js, _ = jstep(js, tiny_batch(5), jax.random.PRNGKey(1))
    path = jsave(js, tmp_path)
    model = build_model(cfg, device="cpu", seed=99)
    st = load_checkpoint(init_state(cfg, model), path)
    assert st.step == 1
    for k, v in flatten_state(model).items():
        np.testing.assert_array_equal(v.numpy(), flat(js.model_state)[k], err_msg=k)
    c = tiny_batch(6)["c"]
    got, want = _encode_pair(jmodel, js, model, c)
    np.testing.assert_allclose(got, want, atol=1e-4)


def test_port_ema_checkpoint_loads_in_jax(tmp_path):
    (jcfg, jmodel, js0, _), (cfg, model, st, step) = pair(ema=True, **RESEED)
    st, _ = step(st, torch_batch(tiny_batch(7)))
    path = save_checkpoint(st, tmp_path)
    z = np.load(path)
    assert {k for k in z.files if k.startswith("model_state/")} == {
        f"model_state/{k}" for k in flatten_state(model)}
    assert any(k.startswith("model_state/") for k in np.load(tmp_path / "checkpoint_step000000001_ema.npz").files)
    js = jload(jinit(jcfg, jmodel, jax.random.PRNGKey(5)), path)
    for k, v in flatten_state(model).items():
        np.testing.assert_array_equal(flat(js.model_state)[k], v.numpy(), err_msg=k)
    c = tiny_batch(8)["c"]
    got, want = _encode_pair(jmodel, js, model, c)
    np.testing.assert_allclose(got, want, atol=1e-4)
