"""The port's training slice against the JAX package on the CPU, at a tiny
svqwae (``_torch_port_util.TINY_SVQWAE``): losses, schedules, the
collator's crops, the training forward, three train steps (unfused, and
fused through the plain K2/K3 against interpret-mode Pallas), checkpoints
in both directions, and ``cli.main train`` end to end.

Tolerances (f32 unless stated):
- forward, losses, schedules: 1e-4 abs on logits, 1e-5 relative on scalars;
- train steps: loss and grad norm 1e-5 relative; parameters 2e-5 abs; Adam
  moments 1e-4 of the largest moment; EMA shadow 1e-6 abs. Parameters whose
  gradient is zero in exact arithmetic are left out of the parameter check:
  with instance norm after the encoder, a constant-over-time shift of the
  code (the projection bias, and encoder biases of channels whose ReLU
  pattern is constant over the few frames) is removed exactly, so both
  packages' gradients there are f32 rounding noise (|mu| < 1e-5 of the
  largest moment), which Adam's sign-like first steps turn into moves of
  ±lr in either direction. One such flip is 4e-4, 20x the bound.
- bf16 compute: one step's loss within 1e-3 relative and grad norm within
  5e-2 relative of the JAX bf16 step (the two frameworks' CPU bf16 convs
  round at other places; measured 3e-5 and 1.1e-2).
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _torch_port_util import TINY_SVQWAE, tiny_cfgs, to_np  # noqa: E402
from wavenet_autoencoders_tpu.models.zoo import build_model as jbuild  # noqa: E402
from wavenet_autoencoders_tpu.train import init_state as jinit  # noqa: E402
from wavenet_autoencoders_tpu.train import load_checkpoint as jload  # noqa: E402
from wavenet_autoencoders_tpu.train import make_train_step as jmake  # noqa: E402
from wavenet_autoencoders_tpu.train import save_checkpoint as jsave  # noqa: E402
from wavenet_autoencoders_tpu_torch.models import build_model  # noqa: E402
from wavenet_autoencoders_tpu_torch.train.checkpoint import (  # noqa: E402
    load_checkpoint,
    restore_parts,
    save_checkpoint,
)
from wavenet_autoencoders_tpu_torch.train.step import init_state, make_train_step  # noqa: E402
from wavenet_autoencoders_tpu_torch.utils.params import _flatten_tree, flatten_params, load_jax_params  # noqa: E402

LIVE_MU = 1e-5


def tiny_batch(seed=0, B=2, T=32):
    """numpy batch shaped for the tiny model (8 latent frames x 4)."""
    rng = np.random.default_rng(seed)
    return {
        "x": rng.integers(0, 32, (B, T)).astype(np.int32),
        "y": rng.integers(0, 32, (B, T, 1)).astype(np.int32),
        "c": rng.standard_normal((B, T, 39)).astype(np.float32),
        "g": np.array([1, 5], np.int32)[:B],
        "lengths": np.array([T, T - 5], np.int32)[:B],
    }


def torch_batch(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def pair(**over):
    """JAX (cfg, model, state, step_fn) and port (cfg, model, state, step_fn)
    with the same initial weights (JAX init from key 0)."""
    jcfg, cfg = tiny_cfgs()
    over = {"clip_thresh": 1.0, **over}
    jcfg, cfg = jcfg.replace(**over), cfg.replace(**over)
    jmodel = jbuild(jcfg)
    js = jinit(jcfg, jmodel, jax.random.PRNGKey(0))
    model = build_model(cfg, device="cpu")
    load_jax_params(model, to_np(js.params))
    st = init_state(cfg, model)
    return (jcfg, jmodel, js, jmake(jcfg, jmodel, donate=False)), (cfg, model, st, make_train_step(cfg, model))


def flat(tree):
    return _flatten_tree(to_np(tree))


def port_params(st):
    return {k: v.detach().numpy() for k, v in flatten_params(st.model).items()}


def assert_states_close(js, st):
    """Parameters (live elements), Adam moments, EMA shadow and counters."""
    jmu, jnu = flat(js.opt_state.inner_state[0].mu), flat(js.opt_state.inner_state[0].nu)
    mu_max = max(np.abs(v).max() for v in jmu.values())
    nu_max = max(np.abs(v).max() for v in jnu.values())
    jp, pp, je = flat(js.params), port_params(st), flat(js.ema_params)
    assert set(jp) == set(pp)
    n_live = 0
    for k in pp:
        live = np.abs(jmu[k]) > LIVE_MU * mu_max
        n_live += live.sum()
        np.testing.assert_allclose(pp[k][live], jp[k][live], atol=2e-5, rtol=0, err_msg=k)
        np.testing.assert_allclose(st.mu[k].numpy(), jmu[k], atol=1e-4 * mu_max, rtol=0, err_msg=k)
        np.testing.assert_allclose(st.nu[k].numpy(), jnu[k], atol=1e-4 * nu_max, rtol=0, err_msg=k)
        np.testing.assert_allclose(st.ema[k].numpy(), je[k], atol=1e-6, rtol=0, err_msg=k)
    assert n_live > 0.85 * sum(v.size for v in pp.values())
    assert st.step == int(js.step) and st.count == int(js.opt_state.inner_state[0].count)


def test_sequence_mask_and_masked_cross_entropy_match_jax():
    from wavenet_autoencoders_tpu.ops.losses import masked_cross_entropy as jce
    from wavenet_autoencoders_tpu.ops.losses import sequence_mask as jmask
    from wavenet_autoencoders_tpu_torch.ops.losses import masked_cross_entropy, sequence_mask

    rng = np.random.default_rng(0)
    lengths = np.array([7, 3, 0], np.int32)
    logits = rng.standard_normal((3, 7, 11)).astype(np.float32)
    targets = rng.integers(0, 11, (3, 7, 1)).astype(np.int32)
    mask = sequence_mask(torch.from_numpy(lengths), 7)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask(jnp.asarray(lengths), 7)))
    got = masked_cross_entropy(torch.from_numpy(logits), torch.from_numpy(targets), mask[..., None])
    want = jce(jnp.asarray(logits), jnp.asarray(targets), jnp.asarray(mask.numpy())[..., None])
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    # an all-zero mask divides by max(sum(mask), 1), not by 0
    zero = masked_cross_entropy(torch.from_numpy(logits), torch.from_numpy(targets), torch.zeros(3, 7))
    assert float(zero) == 0.0


@pytest.mark.parametrize("name,kw", [
    ("noam_learning_rate_decay", {"warmup_steps": 4000}),
    ("step_learning_rate_decay", {"anneal_rate": 0.5, "anneal_interval": 400000}),
    ("cyclic_cosine_annealing", {"T": 100, "M": 10}),
])
def test_schedules_match_jax_at_golden_steps(name, kw):
    from wavenet_autoencoders_tpu.train.schedule import get_schedule as jget
    from wavenet_autoencoders_tpu_torch.train.schedule import get_schedule

    fn, jfn = get_schedule(name, 4e-4, kw), jget(name, 4e-4, kw)
    for step in (0, 1, 7, 3999, 4000, 399999, 400000, 1234567):
        np.testing.assert_allclose(fn(step), float(jfn(jnp.int32(step))), rtol=1e-5, err_msg=f"{name} {step}")


def test_collator_crops_match_jax():
    from wavenet_autoencoders_tpu.data.dataset import Collator as JCollator
    from wavenet_autoencoders_tpu_torch.data.dataset import Collator

    jcfg, cfg = tiny_cfgs()
    rng = np.random.default_rng(1)
    hop = cfg.get_hop_size()
    items = []
    for i, frames in enumerate((32, 40, 57, 90)):
        items.append((rng.integers(0, 32, frames * hop), rng.standard_normal((frames, 39)).astype(np.float32), i % 3))
    jcol, col = JCollator(jcfg, seed=3), Collator(cfg, seed=3)
    assert col.pad_value == jcol.pad_value == 15  # mu-law silence for 32 channels
    for _ in range(3):
        a, b = col(items), jcol(items)
        assert set(a) == set(b)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_vqwae_training_forward_matches_jax():
    (jcfg, jmodel, js, _), (cfg, model, _, _) = pair()
    b = tiny_batch(2)
    y, aux, perp, _ = jmodel.forward(js.params, js.model_state, jax.random.PRNGKey(0), jnp.asarray(b["x"]),
                                     jnp.asarray(b["c"]), jnp.asarray(b["g"]), train=True)
    tb = torch_batch(b)
    with torch.no_grad():
        y2, aux2, perp2 = model.forward(tb["x"].long(), tb["c"], tb["g"], train=True)
    np.testing.assert_allclose(y2.numpy(), np.asarray(y), atol=1e-4)
    np.testing.assert_allclose(float(aux2), float(aux), rtol=1e-5)
    np.testing.assert_allclose(float(perp2), float(perp), rtol=1e-5)


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
def test_three_f32_train_steps_match_jax(fused):
    (_, _, js, jstep), (_, _, st, step) = pair(fused_stack=fused)
    b = tiny_batch(0)
    for _ in range(3):
        js, jm = jstep(js, b, jax.random.PRNGKey(1))
        st, m = step(st, torch_batch(b))
        for k in ("loss", "recon_loss", "aux_loss", "perplexity", "grad_norm", "lr"):
            np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-5, err_msg=k)
    assert_states_close(js, st)


def test_bf16_train_step_finite_and_close_to_jax():
    (_, _, js, jstep), (_, model, st, step) = pair(compute_dtype="bfloat16")
    b = tiny_batch(0)
    js, jm = jstep(js, b, jax.random.PRNGKey(1))
    st, m = step(st, torch_batch(b))
    assert all(np.isfinite(float(v)) for v in m.values())
    assert all(torch.isfinite(p).all() for p in model.parameters())
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-3)
    np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]), rtol=5e-2)


def test_jax_checkpoint_resumes_in_port(tmp_path):
    (jcfg, jmodel, js, jstep), (cfg, _, _, _) = pair()
    b = tiny_batch(3)
    js, _ = jstep(js, b, jax.random.PRNGKey(1))
    path = jsave(js, tmp_path)
    # a port state from other weights, then the JAX checkpoint
    model = build_model(cfg, device="cpu", seed=99)
    st = load_checkpoint(init_state(cfg, model), path)
    assert st.step == 1 and st.count == 1
    assert_states_close(js, st)
    js, jm = jstep(js, b, jax.random.PRNGKey(1))
    st, m = make_train_step(cfg, model)(st, torch_batch(b))
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-5)
    assert_states_close(js, st)


def test_port_checkpoint_loads_in_jax(tmp_path):
    (jcfg, jmodel, js0, jstep), (cfg, model, st, step) = pair()
    b = tiny_batch(4)
    st, _ = step(st, torch_batch(b))
    path = save_checkpoint(st, tmp_path)
    for name in ("checkpoint_step000000001.npz", "checkpoint_step000000001_ema.npz",
                 "checkpoint_latest.npz", "checkpoint_latest_ema.npz"):
        assert (tmp_path / name).exists(), name
    fresh = jinit(jcfg, jmodel, jax.random.PRNGKey(5))
    js = jload(fresh, path)
    assert int(js.step) == 1
    for k, v in port_params(st).items():
        np.testing.assert_array_equal(flat(js.params)[k], v, err_msg=k)
        np.testing.assert_array_equal(flat(js.opt_state.inner_state[0].mu)[k], st.mu[k].numpy(), err_msg=k)
        np.testing.assert_array_equal(flat(js.ema_params)[k], st.ema[k].numpy(), err_msg=k)
    # and JAX's next step from the port's checkpoint equals the port's next step
    js, jm = jstep(js, b, jax.random.PRNGKey(1))
    st, m = step(st, torch_batch(b))
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-5)
    assert_states_close(js, st)


def test_async_checkpoint_writes_the_state_it_was_given(tmp_path, monkeypatch):
    """The asynchronous writer holds host copies: a train step that updates
    the CPU state in place before the write lands leaves both files (the
    main and the ``_ema`` one) with the state of the checkpoint's step."""
    import threading

    from wavenet_autoencoders_tpu_torch.train import checkpoint as ck

    _, (cfg, model, st, step) = pair()
    st, _ = step(st, torch_batch(tiny_batch(4)))
    want = dict(np.load(save_checkpoint(st, tmp_path / "sync")))
    stepped, write = threading.Event(), ck.write_checkpoint
    monkeypatch.setattr(ck, "write_checkpoint", lambda *a: stepped.wait(30) and write(*a))
    saver = ck.AsyncCheckpointer()
    saver.save(st, tmp_path / "async")
    st, _ = step(st, torch_batch(tiny_batch(5)))
    stepped.set()
    saver.wait()
    for name in ("checkpoint_step000000001.npz", "checkpoint_step000000001_ema.npz"):
        got = dict(np.load(tmp_path / "async" / name))
        ref = want if "_ema" not in name else dict(np.load(tmp_path / "sync" / name))
        assert set(got) == set(ref)
        for k in ref:
            np.testing.assert_array_equal(got[k], ref[k], err_msg=f"{name} {k}")


def test_reset_optimizer_and_restore_parts(tmp_path):
    _, (cfg, model, st, step) = pair()
    st, _ = step(st, torch_batch(tiny_batch(5)))
    path = save_checkpoint(st, tmp_path)
    fresh = load_checkpoint(init_state(cfg, build_model(cfg, device="cpu", seed=7)), path, reset_optimizer=True)
    assert fresh.count == 0 and all(float(v.abs().max()) == 0.0 for v in fresh.mu.values())
    np.testing.assert_array_equal(port_params(fresh)["wavenet/first/v"], port_params(st)["wavenet/first/v"])
    # restore_parts: same-shape weights come from the file, a resized codebook stays
    other_cfg = cfg.replace(K=4)
    other = build_model(other_cfg, device="cpu", seed=7)
    book = other.vq.codebooks[0].detach().clone()
    restore_parts(other, path, log=lambda *_: None)
    np.testing.assert_array_equal(other.wavenet.first.v.detach().numpy(), port_params(st)["wavenet/first/v"])
    assert torch.equal(other.vq.codebooks[0], book)


def _dump(root, n_utts=6, frames=40, hop=4):
    rng = np.random.default_rng(6)
    lines = []
    for i in range(n_utts):
        d = root / "dump" / "english" / "train" / f"V00{i % 2 + 1}_{i}"
        d.mkdir(parents=True)
        np.save(d / "wave.npy", rng.integers(0, 32, frames * hop))
        np.save(d / "mfcc.norm.npy", rng.standard_normal((frames, 39)).astype(np.float32))
        lines.append(f"{d}/|{frames}|{i % 2}|dummy")
    (root / "dump" / "train.txt").write_text("\n".join(lines) + "\n")
    return root / "dump", [root / "dump" / "english" / "train" / f"V00{i % 2 + 1}_{i}" for i in range(n_utts)]


def test_cli_train_then_infer_on_cpu(tmp_path, capsys):
    from wavenet_autoencoders_tpu_torch.cli.main import main

    dump, utts = _dump(tmp_path)
    hp = TINY_SVQWAE + ',batch_size=2,upsample_params={"upsample_scales": [4, 4]}'
    ckpt = tmp_path / "exp"
    main(["train", "--preset", "svqwae", "--hparams", hp, "--device", "cpu", str(dump), str(ckpt),
          "--max-steps", "2"])
    for name in ("checkpoint_step000000002.npz", "checkpoint_step000000002_ema.npz", "config.json"):
        assert (ckpt / name).exists(), name
    recs = [json.loads(line) for line in (ckpt / "logs" / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in recs if r["phase"] == "train_no_dev"][:2] == [1, 2]
    assert all(np.isfinite(r["loss"]) and np.isfinite(r["grad_norm"]) for r in recs if "loss" in r)
    z = np.load(ckpt / "checkpoint_step000000002.npz")
    assert int(z["step"]) == 2 and int(z["opt_state/inner_state/0/count"]) == 2

    scp = tmp_path / "scp.json"
    scp.write_text(json.dumps([[f"wav/{u.name}.wav", f"{u}/"] for u in utts[:2]]))
    main(["infer", "--preset", "svqwae", "--hparams", hp, "--device", "cpu", "--no-use-ema",
          str(ckpt / "checkpoint_step000000002.npz"), str(scp), str(tmp_path / "abx"), "--lan", "english"])
    out = np.loadtxt(tmp_path / "abx" / "2019" / "english" / "test" / f"{utts[0].name}.txt")
    assert out.shape == (10, 8) and np.isfinite(out).all()


@pytest.mark.parametrize("over", [
    {"time_jitter": True}, {"vq_drop": True, "drop_dim": 2}, {"vq_reseed": True}, {"dropout": 0.05},
], ids=["time_jitter", "vq_drop", "reseed", "dropout"])
def test_unported_training_options_raise(over):
    """The options an earlier slice refused (time jitter, VQ-dropout, reseed,
    dropout) now train: one step gives finite metrics. A model axis one
    process cannot form (``mesh_shape.model`` 2 over 1 process) raises with
    each of them instead of training something else (tensor parallelism
    itself is tests/test_torch_port_tensor_parallel.py's)."""
    _, cfg = tiny_cfgs()
    cfg = cfg.replace(**over)
    model = build_model(cfg, device="cpu").train()
    _, m = make_train_step(cfg, model)(init_state(cfg, model), torch_batch(tiny_batch()))
    assert all(np.isfinite(float(v)) for v in m.values()), m
    tp = cfg.replace(mesh_shape={"data": -1, "model": 2})
    with pytest.raises(ValueError, match="mesh_shape model=2 does not divide 1 processes"):
        make_train_step(tp, build_model(tp, device="cpu"))
