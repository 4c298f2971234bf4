"""The port's dev pass, sample dump, decode hook and profiler hook against
the JAX package on the CPU, at a tiny svqwae (``_torch_port_util.TINY_SVQWAE``)
with the same weights in both packages.

Tolerances (f32): the eval step's ``loss``, ``recon_loss`` and
``recon_loss_ema`` 1e-4 relative, ``perplexity`` exact; the sample
forward's logits 1e-4 abs; the sample dump's wavs equal (the same logits,
argmax); the decode hook's target wav equal. The hooks must leave the live
weights bit for bit as they were.
"""
import json

import numpy as np
import pytest
from scipy.io import wavfile

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _torch_port_util import TINY_SVQWAE, tiny_cfgs, to_np  # noqa: E402
from wavenet_autoencoders_tpu.models.zoo import build_model as jbuild  # noqa: E402
from wavenet_autoencoders_tpu.train.step import init_state as jinit  # noqa: E402
from wavenet_autoencoders_tpu_torch.models import build_model  # noqa: E402
from wavenet_autoencoders_tpu_torch.train.step import init_state  # noqa: E402
from wavenet_autoencoders_tpu_torch.utils.params import _flatten_tree, flatten_params, load_jax_params  # noqa: E402


def tiny_batch(seed=0, B=2, T=32):
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
    """JAX (cfg, model, state) and port (cfg, model, state) with the same
    live weights and the same EMA shadow, which differs from them."""
    jcfg, cfg = tiny_cfgs()
    jcfg, cfg = jcfg.replace(**over), cfg.replace(**over)
    jmodel = jbuild(jcfg)
    js = jinit(jcfg, jmodel, jax.random.PRNGKey(0))
    leaves, tree = jax.tree.flatten(js.params)
    rng = np.random.default_rng(11)
    ema = [np.asarray(v) + 0.3 * rng.standard_normal(v.shape).astype(np.float32) for v in leaves]
    js.ema_params = jax.tree.unflatten(tree, [jnp.asarray(v) for v in ema])
    model = build_model(cfg, device="cpu")
    load_jax_params(model, to_np(js.params))
    st = init_state(cfg, model)
    st.ema = {k: torch.from_numpy(np.array(v)) for k, v in _flatten_tree(to_np(js.ema_params)).items()}
    return (jcfg, jmodel, js), (cfg, model, st)


def live(model):
    return {k: v.detach().clone() for k, v in flatten_params(model).items()}


def assert_bitwise(a, b):
    assert set(a) == set(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
def test_eval_step_matches_jax(fused):
    from wavenet_autoencoders_tpu.train.step import make_eval_step as jmake
    from wavenet_autoencoders_tpu_torch.train.step import make_eval_step

    (jcfg, jmodel, js), (cfg, model, st) = pair(fused_stack=fused)
    b = tiny_batch(0)
    want = jmake(jcfg, jmodel)(js, b, jax.random.PRNGKey(0))
    before = live(model)
    got = make_eval_step(cfg, model)(st, torch_batch(b))
    assert sorted(got) == sorted(want) == ["aux_loss", "loss", "perplexity", "recon_loss", "recon_loss_ema"]
    for k in ("loss", "recon_loss", "aux_loss", "recon_loss_ema"):
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-4, err_msg=k)
    assert float(got["perplexity"]) == float(want["perplexity"])
    # the shadow differs: its loss is not the live one
    assert abs(float(got["recon_loss_ema"]) - float(got["recon_loss"])) > 1e-2
    assert_bitwise(live(model), before)
    assert all(p.grad is None for p in model.parameters())


def test_eval_step_without_ema_shadow():
    from wavenet_autoencoders_tpu_torch.train.step import make_eval_step

    _, (cfg, model, st) = pair()
    st.ema = None
    got = make_eval_step(cfg, model)(st, torch_batch(tiny_batch(1)))
    assert sorted(got) == ["aux_loss", "loss", "perplexity", "recon_loss"]
    assert float(got["loss"]) == pytest.approx(float(got["recon_loss"] + got["aux_loss"]), rel=1e-6)


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
def test_sample_forward_matches_jax(fused):
    from wavenet_autoencoders_tpu.train.step import _prep_x
    from wavenet_autoencoders_tpu.train.step import make_sample_forward as jmake
    from wavenet_autoencoders_tpu_torch.train.step import make_sample_forward

    (jcfg, jmodel, js), (cfg, model, st) = pair(fused_stack=fused)
    b = tiny_batch(2)
    want = jmake(jcfg, jmodel)(js.params, js.model_state, jax.random.PRNGKey(0), _prep_x(jcfg, jnp.asarray(b["x"])),
                               jnp.asarray(b["c"]), jnp.asarray(b["g"]))
    tb = torch_batch(b)
    got = make_sample_forward(cfg, model)(tb["x"], tb["c"], tb["g"])
    assert not got.requires_grad
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


def _wavs(d):
    return {p.name: wavfile.read(p)[1] for p in sorted(d.glob("*.wav"))}


@pytest.mark.parametrize("step", [3, 10])
def test_save_states_writes_jax_wavs(tmp_path, step):
    """The same logits through both packages' sample dump (mu-law): the same
    item pick, argmax and wavs."""
    from wavenet_autoencoders_tpu.train.eval_hooks import save_states as jsave
    from wavenet_autoencoders_tpu_torch.train.eval_hooks import save_states

    jcfg, cfg = tiny_cfgs()
    b = tiny_batch(3)
    logits = np.random.default_rng(step).standard_normal((2, 32, 32)).astype(np.float32)
    jsave(jcfg, step, logits, b, tmp_path / "jax")
    save_states(cfg, step, torch.from_numpy(logits), torch_batch(b), tmp_path / "port")
    want, got = _wavs(tmp_path / "jax/intermediate/audio"), _wavs(tmp_path / "port/intermediate/audio")
    assert sorted(got) == [f"step{step:09d}_predicted.wav", f"step{step:09d}_target.wav"]
    assert sorted(got) == sorted(want)
    for k in got:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_save_states_samples_a_mixture(tmp_path):
    """Scalar output (MoL): the port samples with its own sampler from a
    generator seeded with the step; the prediction has the target's length,
    is not silent and repeats for the same step; the batch is not changed.
    The JAX package's dump fails here (it zeroes a read-only view of its
    sample; ROADMAP.md section 3), so the target is held against the JAX
    ``save_wav`` of the item zeroed past its length."""
    from wavenet_autoencoders_tpu.dsp import save_wav as jsave_wav
    from wavenet_autoencoders_tpu.train.eval_hooks import save_states as jsave
    from wavenet_autoencoders_tpu_torch.train.eval_hooks import save_states

    jcfg, cfg = (c.replace(input_type="raw", output_distribution="Logistic", out_channels=30) for c in tiny_cfgs())
    rng = np.random.default_rng(4)
    b = tiny_batch(4)
    b["y"] = rng.uniform(-0.5, 0.5, (2, 32, 1)).astype(np.float32)
    y_hat = rng.standard_normal((2, 32, 30)).astype(np.float32)
    with pytest.raises(ValueError, match="read-only"):
        jsave(jcfg, 7, y_hat, {k: v.copy() for k, v in b.items()}, tmp_path / "jax")
    tb = torch_batch({k: v.copy() for k, v in b.items()})
    for d in ("port", "port2"):
        save_states(cfg, 7, torch.from_numpy(y_hat), tb, tmp_path / d)
    np.testing.assert_array_equal(tb["y"].numpy(), b["y"])
    idx = int(np.random.default_rng(cfg.seed + 7).integers(0, 2))
    want = b["y"][idx, :, 0].copy()
    want[b["lengths"][idx]:] = 0
    jsave_wav(want, tmp_path / "want.wav", 16000)
    got, again = (_wavs(tmp_path / d / "intermediate/audio") for d in ("port", "port2"))
    np.testing.assert_array_equal(got["step000000007_target.wav"], wavfile.read(tmp_path / "want.wav")[1])
    pred = got["step000000007_predicted.wav"]
    assert pred.shape == (32,) and np.abs(pred).max() > 0
    np.testing.assert_array_equal(pred, again["step000000007_predicted.wav"])


def test_eval_model_target_equals_jax(tmp_path):
    from wavenet_autoencoders_tpu.train.eval_hooks import eval_model as jeval
    from wavenet_autoencoders_tpu_torch.train.eval_hooks import eval_model

    (jcfg, jmodel, js), (cfg, model, st) = pair()
    b = tiny_batch(5)
    jeval(jcfg, jmodel, js.params, js.model_state, 8, b, tmp_path / "jax")
    eval_model(cfg, model, 8, torch_batch(b), tmp_path / "port")
    want, got = _wavs(tmp_path / "jax"), _wavs(tmp_path / "port")
    assert sorted(got) == sorted(want) == ["step000000008_predicted.wav", "step000000008_target.wav"]
    np.testing.assert_array_equal(got["step000000008_target.wav"], want["step000000008_target.wav"])
    assert got["step000000008_predicted.wav"].shape == want["step000000008_predicted.wav"].shape
    assert sorted(p.name for p in (tmp_path / "port").iterdir()) == sorted(p.name for p in (tmp_path / "jax").iterdir())


@pytest.mark.parametrize("warm", [True, False], ids=["warm_shadow", "young_shadow"])
def test_hooks_use_the_warm_shadow_and_leave_live_weights_bitwise(tmp_path, capsys, warm):
    """ema_decay 0.5 warms the shadow at step 10: the hooks at step 12 run
    on the shadow, at step 4 on the live weights; both leave the live
    weights exactly as they were."""
    from wavenet_autoencoders_tpu_torch.train.eval_hooks import save_states
    from wavenet_autoencoders_tpu_torch.train.loop import _try_eval_model, _try_save_states
    from wavenet_autoencoders_tpu_torch.train.step import ema_warm_steps, make_sample_forward

    _, (cfg, model, st) = pair(ema_decay=0.5)
    assert ema_warm_steps(0.5) == 10
    step = 12 if warm else 4
    tb = torch_batch(tiny_batch(6))
    before = live(model)
    fwd = make_sample_forward(cfg, model)
    _try_save_states(cfg, fwd, st, step, tb, tmp_path / "hook")
    _try_eval_model(cfg, st, step, tb, tmp_path / "hook")
    out = capsys.readouterr().out
    assert "skipped" not in out and f"save_states at step {step}" in out
    assert_bitwise(live(model), before)
    # the dump equals one made from the weights the hook should have used
    with torch.no_grad():
        if warm:
            y = torch.func.functional_call(model, {k.replace("/", "."): v for k, v in st.ema.items()},
                                           (tb["x"].long(), tb["c"], tb["g"]), {"train": False})[0]
        else:
            y = model(tb["x"].long(), tb["c"], tb["g"], train=False)[0]
    save_states(cfg, step, y, tb, tmp_path / "want")
    got, want = _wavs(tmp_path / "hook/intermediate/audio"), _wavs(tmp_path / "want/intermediate/audio")
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert (tmp_path / "hook/intermediate/train_no_dev_eval" / f"step{step:09d}_predicted.wav").exists()


def test_failing_hook_is_skipped_and_training_state_kept(tmp_path, capsys):
    from wavenet_autoencoders_tpu_torch.train.loop import _try_save_states

    _, (cfg, model, st) = pair(ema_decay=0.5)
    before = live(model)

    def broken(x, c, g):
        raise RuntimeError("boom")

    _try_save_states(cfg, broken, st, 20, torch_batch(tiny_batch(0)), tmp_path)
    assert "save_states skipped: RuntimeError: boom" in capsys.readouterr().out
    assert_bitwise(live(model), before)


def _dump(root, n_utts, seed, frames=40, hop=4):
    rng = np.random.default_rng(seed)
    lines = []
    for i in range(n_utts):
        d = root / f"V00{i % 2 + 1}_{i}"
        d.mkdir(parents=True)
        np.save(d / "wave.npy", rng.integers(0, 32, frames * hop))
        np.save(d / "mfcc.norm.npy", rng.standard_normal((frames, 39)).astype(np.float32))
        lines.append(f"{d}/|{frames}|{i % 2}|dummy")
    (root / "train.txt").write_text("\n".join(lines) + "\n")
    return root


HOOKS = (TINY_SVQWAE + ',batch_size=2,dev_batch_size=2,checkpoint_interval=2,train_eval_interval=4,'
         'test_eval_epoch_interval=1,upsample_params={"upsample_scales": [4, 4]}')


def _files(d):
    """Every file under ``d`` but TensorBoard's event files (named by time
    and host)."""
    return sorted(str(p.relative_to(d)) for p in d.rglob("*") if p.is_file() and "tfevents" not in p.name)


def _records(d):
    return [json.loads(line) for line in (d / "logs" / "metrics.jsonl").read_text().splitlines()]


def test_train_with_dev_dump_writes_the_jax_files(tmp_path, capsys):
    """4 steps over 4 utterances at B=2: epochs end at steps 2 and 4, each
    with a dev pass and a dev AR decode; checkpoints and sample dumps at 2
    and 4, the train decode hook at 4. Both loops write the same files."""
    from wavenet_autoencoders_tpu.config import load_preset as jload
    from wavenet_autoencoders_tpu.train.loop import train as jtrain
    from wavenet_autoencoders_tpu_torch.config import load_preset
    from wavenet_autoencoders_tpu_torch.train.loop import train

    train_dump, dev_dump = _dump(tmp_path / "train", 4, 0), _dump(tmp_path / "dev", 2, 1)
    jtrain(jload("svqwae", HOOKS), str(train_dump), str(tmp_path / "jax"), max_steps=4, dev_dump_root=str(dev_dump))
    train(load_preset("svqwae", HOOKS), str(train_dump), str(tmp_path / "port"), max_steps=4,
          dev_dump_root=str(dev_dump), device="cpu")
    out = capsys.readouterr().out
    assert "skipped" not in out
    got, want = _files(tmp_path / "port"), _files(tmp_path / "jax")
    assert got == want
    for f in ("intermediate/audio/step000000002_predicted.wav", "intermediate/audio/step000000004_target.wav",
              "intermediate/train_no_dev_eval/step000000004_predicted.wav",
              "intermediate/dev_eval/step000000002_predicted.wav", "intermediate/dev_eval/step000000004_target.wav"):
        assert f in got, f
    recs, jrecs = _records(tmp_path / "port"), _records(tmp_path / "jax")
    for phase, steps in (("dev", [2, 4]), ("dev_epoch", [1, 2])):
        mine = [r for r in recs if r["phase"] == phase]
        theirs = [r for r in jrecs if r["phase"] == phase]
        assert [r["step"] for r in mine] == [r["step"] for r in theirs] == steps
        assert all(sorted(r) == sorted(t) for r, t in zip(mine, theirs))
        assert all(np.isfinite(r[k]) for r in mine for k in ("loss", "recon_loss_ema", "perplexity"))


def test_cli_dev_dump_without_train_txt_has_no_dev_pass(tmp_path):
    from wavenet_autoencoders_tpu_torch.cli.main import main

    train_dump = _dump(tmp_path / "train", 4, 0)
    (tmp_path / "empty").mkdir()
    ckpt = tmp_path / "exp"
    main(["train", "--preset", "svqwae", "--hparams", HOOKS, "--device", "cpu", str(train_dump), str(ckpt),
          "--max-steps", "2", "--dev-dump-root", str(tmp_path / "empty")])
    assert not any(r["phase"].startswith("dev") for r in _records(ckpt))
    assert (ckpt / "intermediate/audio/step000000002_predicted.wav").exists()
    assert not (ckpt / "intermediate/dev_eval").exists()


def test_profile_dir_writes_a_trace_of_steps_10_to_15(tmp_path, capsys):
    from wavenet_autoencoders_tpu_torch.config import load_preset
    from wavenet_autoencoders_tpu_torch.train.loop import train

    prof = tmp_path / "prof"
    cfg = load_preset("svqwae", HOOKS).replace(profile_dir=str(prof), checkpoint_interval=100,
                                                 train_eval_interval=100, fused_stack=True)
    train(cfg, str(_dump(tmp_path / "train", 4, 0)), str(tmp_path / "exp"), max_steps=16, device="cpu")
    trace = prof / "trace_steps_10_15.json"
    assert f"profile trace written to {trace}" in capsys.readouterr().out
    events = json.loads(trace.read_text())["traceEvents"]
    names = {e.get("name", "") for e in events}
    assert any(n.startswith("aten::") for n in names)
    # the 5 traced steps each ran the (plain, on the CPU) fused stack forward and backward
    assert sum(n == "FusedGLUStack" for n in names) == 1
    assert sum(e.get("name") == "FusedGLUStack" for e in events) == 5
    # the tracer's spans, on the profiler's timeline: the steps 10-14 (the traced 10-15), each with the
    # batch whose wait it followed, and the batches built meanwhile with their loads and copies
    spans = [e for e in events if e.get("cat") == "program_span"]
    steps = sorted((e for e in spans if e["name"] == "step"), key=lambda e: e["ts"])
    assert [e["args"]["step"] for e in steps] == [10, 11, 12, 13, 14]
    waits = [e for e in spans if e["name"] == "data.wait"]
    assert sorted(e["args"]["batch"] for e in waits) == [e["args"]["batch"] for e in steps] == [11, 12, 13, 14, 15]
    assert {e["name"] for e in spans} == {"step", "data.wait", "data.build", "data.load", "data.to_device"}
    built = sorted(e["args"]["batch"] for e in spans if e["name"] == "data.build")
    assert built and built == list(range(built[0], built[0] + len(built)))
    by_id = {e["args"]["id"]: e for e in spans}
    for e in spans:
        if e["name"] in ("data.load", "data.to_device"):
            assert by_id[e["args"]["parent"]]["name"] == "data.build"
            assert e["tid"] == by_id[e["args"]["parent"]]["tid"] != steps[0]["tid"]
    for st in steps:
        stack = [e for e in events if e.get("name") == "FusedGLUStack" and st["ts"] <= e["ts"]
                 and e["ts"] + e["dur"] <= st["ts"] + st["dur"]]
        assert len(stack) == 1, st
    counters = json.loads(trace.read_text())["programCounters"]
    assert counters["data.batches"] == len(built) and counters["dropped"] == 0
    assert "kernels.glu_stack.LAUNCHES_FWD" in counters
