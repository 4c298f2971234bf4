"""Both training loops, line for line, on the CPU: the JAX package's
``train/loop.py`` and the port's on the same dump, from their own initial
weights (``build_model`` and ``init`` from ``cfg.seed``), with
``log_every=1``.

The configs are run K's and run F's frozen configs (chip_smoke phases
13-15), narrowed as ``tests/test_torch_port_quality_runs.py`` narrows them,
at f32, with the schedule compressed so that 16 steps at B=2 over 8
utterances (4 steps an epoch) cross every event of run K's schedule: the
VQ warm-up's end (step 3), reseeds from ``vq_reseed_start`` = 5 with a
threshold at which unused codes die, the lr halving (step 10), checkpoints
with their sample dumps (steps 6 and 12, and the final one at 16) and the
dev pass (every second epoch: steps 8 and 16).

Adam runs at lr 4e-5 and eps 1e-6 (run K: 4e-4 and 1e-8), where the JAX
loop holds itself to the bounds below (one device against two,
``test_the_jax_loop_holds_itself_to_these_bounds``). At run K's values it
does not: elements whose gradient is zero in exact arithmetic (the biases
of channels that pass the last ReLU whole, which the instance norm then
removes) get f32 noise of ~1e-9, which Adam's normalized update turns into
moves of up to ~lr; once a later batch sends such a channel below zero
the bias matters, and the JAX loop on one device and on two parts by
6.4e-4 in step 2's grad norm (in step 12's by 3.3e-5 at lr 4e-5 and eps
1e-8, all of it from one element of ``encoder/blocks/9/b``).

Two f32 runs whose parameters differ by ~1e-8 give gradients that part
wherever an input of the post-net's ReLU lies between them: on the dump of
seed 0, run F's step 13 has one at -1.46e-8 in the JAX run and +5.93e-8
in the port's, and the grad norms part by 8.4e-4, while the port's
gradient at the JAX run's own parameters is the JAX gradient within
3.5e-6 (``test_a_port_step_from_each_jax_state_is_the_jax_line`` holds
every line of that run so). Such a crossing comes in about one 16-step run
in three (seeds 10 and 20 give one in run K); the dump's seed, 30, has
none in these runs, so each line of the loops holds to the bound.

Held: every train, epoch and dev log line, ``loss``, ``recon_loss``,
``aux_loss``, ``perplexity``, ``grad_norm``, ``lr`` and ``recon_loss_ema``
within 1e-5 relative and ``reseeded`` exactly; every checkpoint as
``tests/test_torch_port_train.py:assert_states_close`` holds a state
(parameters 2e-5 abs on the elements whose first Adam moment is not f32
noise, the moments 1e-4 of the largest, the EMA shadow 1e-6 abs) plus the
model state (codebook usage) 2e-4 abs, as
``tests/test_torch_port_train_options.py`` holds it; the sample dumps'
files equal. Run K also runs fused: the port's plain K2/K3 against the
interpret-mode Pallas stack.

In bf16 (run K's ``compute_dtype``) the first step's loss is held within
1e-3 relative (``tests/test_torch_port_train.py``'s bf16 bound), and the
first step's gradient is held per module group (encoder, codebooks,
upsample network, the rest of the WaveNet) against the f32 gradient: the
port's bf16 rounding may take it at most twice as far from it as the JAX
package's takes its own. Both packages' bf16 encoder gradients are ~13-16%
from the f32 one and ~11% from each other there (measured): the bf16
products of the decoder's backward reach the encoder through the instance
norm, and each package rounds them in its own order.
"""
import json

import numpy as np
import pytest
from scipy.io import wavfile

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from test_torch_port_quality_runs import quality_cfgs  # noqa: E402
from wavenet_autoencoders_tpu.train.loop import train as jtrain  # noqa: E402
from wavenet_autoencoders_tpu_torch.train.loop import train  # noqa: E402

STEPS = 16
SCHEDULE = dict(
    vq_warmup_steps=3, vq_reseed_start=5, vq_reseed_thresh=0.9, vq_reseed_decay=0.5,
    lr_schedule_kwargs={"anneal_interval": 10, "anneal_rate": 0.5},
    checkpoint_interval=6, dev_epoch_interval=2, dev_batch_size=2,
    train_eval_interval=10**6, test_eval_epoch_interval=10**6,
    optimizer_params={"lr": 4e-5, "eps": 1e-6, "weight_decay": 0.0},
)
DUMP_SEED = 30
METRICS = ("loss", "recon_loss", "aux_loss", "perplexity", "grad_norm", "lr", "recon_loss_ema")
LIVE_MU = 1e-5
# the bf16 first step: the port's distance to the f32 gradient, in units of
# the JAX package's, in each module group
BF16_ERROR_RATIO = 2.0
GROUPS = ("encoder", "vq", "wavenet/upsample", "wavenet")


def _dump(root, n_utts, seed, frames=14, hop=160):
    rng = np.random.default_rng(seed)
    lines = []
    for i in range(n_utts):
        d = root / f"V00{i % 2 + 1}_{i}"
        d.mkdir(parents=True)
        np.save(d / "wave.npy", rng.integers(0, 256, frames * hop))
        np.save(d / "mfcc.norm.npy", rng.standard_normal((frames, 39)).astype(np.float32))
        lines.append(f"{d}/|{frames}|{i % 4}|dummy")
    (root / "train.txt").write_text("\n".join(lines) + "\n")
    return root


def _records(d):
    return [json.loads(line) for line in (d / "logs" / "metrics.jsonl").read_text().splitlines()]


def _one_device():
    """The JAX loop's mesh on one CPU device, as the port runs (the fused
    stack's interpret-mode Pallas call cannot be partitioned)."""
    import jax

    from wavenet_autoencoders_tpu.parallel.mesh import make_mesh

    return make_mesh(None, devices=jax.devices()[:1], data=1)


def _run_both(tmp_path, run, steps=STEPS, cfgs=None, frames=14, **over):
    jcfg, cfg = cfgs or quality_cfgs(run, **{**SCHEDULE, **over})
    train_dump = _dump(tmp_path / "train", 8, DUMP_SEED, frames)
    dev_dump = _dump(tmp_path / "dev", 2, DUMP_SEED + 1, frames)
    jtrain(jcfg, str(train_dump), str(tmp_path / "jax"), max_steps=steps, log_every=1, dev_dump_root=str(dev_dump),
           mesh=_one_device())
    train(cfg, str(train_dump), str(tmp_path / "port"), max_steps=steps, log_every=1,
          dev_dump_root=str(dev_dump), device="cpu")
    return tmp_path / "jax", tmp_path / "port"


def test_the_jax_loop_holds_itself_to_these_bounds(tmp_path):
    """The JAX loop on one device against its default mesh (the batch over
    two devices): every log line within the bounds the port is held to."""
    jcfg, _ = quality_cfgs("run_K", **SCHEDULE)
    train_dump, dev_dump = _dump(tmp_path / "train", 8, DUMP_SEED), _dump(tmp_path / "dev", 2, DUMP_SEED + 1)
    for name, mesh in (("two", None), ("one", _one_device())):
        jtrain(jcfg, str(train_dump), str(tmp_path / name), max_steps=STEPS, log_every=1,
               dev_dump_root=str(dev_dump), mesh=mesh)
    assert_logs_match(tmp_path / "two", tmp_path / "one")


def assert_logs_match(jdir, pdir, rtol=None):
    """Every log line: the same phases and steps in the same order, the
    metrics within 1e-5 relative (or ``rtol[metric]``), ``reseeded``
    exactly. Returns the train lines."""
    want, got = _records(jdir), _records(pdir)
    assert [(r["phase"], r["step"]) for r in got] == [(r["phase"], r["step"]) for r in want]
    for g, w in zip(got, want):
        keys = sorted(set(w) - {"time", "samples_per_sec"})
        assert sorted(set(g) - {"time", "samples_per_sec"}) == keys, (g, w)
        for k in keys:
            if k in METRICS:
                np.testing.assert_allclose(g[k], w[k], rtol=(rtol or {}).get(k, 1e-5), atol=0,
                                           err_msg=f"{w['phase']} {w['step']} {k}")
            elif k == "reseeded":
                assert g[k] == w[k], (w["step"], g[k], w[k])
    return [r for r in got if r["phase"] == "train_no_dev"]


def assert_checkpoints_match(jdir, pdir, min_live=0.85, param_atol=2e-5):
    """Every checkpoint of the JAX run has its port twin, held as
    ``assert_states_close`` holds a state (live parameters within
    ``param_atol``), plus the model state; at least ``min_live`` of the
    parameters are live (their first Adam moment is not f32 noise)."""
    names = sorted(p.name for p in jdir.glob("checkpoint_step*.npz"))
    assert names == sorted(p.name for p in pdir.glob("checkpoint_step*.npz")) and names
    for name in names:
        j, p = dict(np.load(jdir / name)), dict(np.load(pdir / name))
        assert set(p) == set(j), name
        if name.endswith("_ema.npz"):
            for k in j:
                np.testing.assert_allclose(p[k], j[k], atol=1e-6, rtol=0, err_msg=f"{name} {k}")
            continue
        mu = {k[len("opt_state/inner_state/0/mu/"):]: v for k, v in j.items() if "/mu/" in k}
        mu_max = max(np.abs(v).max() for v in mu.values())
        nu_max = max(np.abs(v).max() for k, v in j.items() if "/nu/" in k)
        n_live = n_all = 0
        for k, v in j.items():
            if k.startswith("params/"):
                path = k[len("params/"):]
                live = np.abs(mu[path]) > LIVE_MU * mu_max
                if path.startswith("vq/"):  # a reseeded row is replaced whole
                    live = np.ones_like(live)
                n_live, n_all = n_live + live.sum(), n_all + live.size
                np.testing.assert_allclose(p[k][live], v[live], atol=param_atol, rtol=0, err_msg=f"{name} {k}")
            elif "/mu/" in k:
                np.testing.assert_allclose(p[k], v, atol=1e-4 * mu_max, rtol=0, err_msg=f"{name} {k}")
            elif "/nu/" in k:
                np.testing.assert_allclose(p[k], v, atol=1e-4 * nu_max, rtol=0, err_msg=f"{name} {k}")
            elif k.startswith("model_state/"):
                np.testing.assert_allclose(p[k], v, atol=2e-4, rtol=0, err_msg=f"{name} {k}")
            else:
                np.testing.assert_array_equal(p[k], v, err_msg=f"{name} {k}")
        assert n_live > min_live * n_all, name


def assert_sample_dumps_match(jdir, pdir):
    """The same dumps at the checkpoint steps: the targets equal, the
    predictions (the argmax of the logits) equal at all but at most 1 in 500
    samples, the argmax near-ties of an untrained model's near-uniform
    logits."""
    audio = sorted(p.relative_to(jdir) for p in (jdir / "intermediate" / "audio").glob("*.wav"))
    assert audio == sorted(p.relative_to(pdir) for p in (pdir / "intermediate" / "audio").glob("*.wav"))
    assert {p.name[:13] for p in audio} == {"step000000006", "step000000012"}
    for rel in audio:
        got, want = wavfile.read(pdir / rel)[1], wavfile.read(jdir / rel)[1]
        assert got.shape == want.shape, rel
        if rel.name.endswith("_target.wav"):
            np.testing.assert_array_equal(got, want, err_msg=str(rel))
        else:
            assert (got != want).mean() <= 1 / 500, (rel, int((got != want).sum()))


@pytest.mark.parametrize("run,fused", [("run_K", False), ("run_K", True), ("run_F", False)],
                         ids=["run_K", "run_K_fused", "run_F"])
def test_loops_match_line_for_line(tmp_path, run, fused):
    jdir, pdir = _run_both(tmp_path, run, fused_stack=fused)
    lines = assert_logs_match(jdir, pdir)
    steps = [r["step"] for r in lines]
    assert steps[:STEPS] == list(range(1, STEPS + 1))
    lr = [r["lr"] for r in lines[:STEPS]]
    assert lr[9] == lr[0] and lr[10] == lr[0] / 2  # the halving: step 11 runs at state.step 10
    phases = [r["phase"] for r in _records(pdir)]
    assert phases.count("dev") == 2 and phases.count("train_no_dev_epoch") == 4
    if run == "run_K":
        assert any(r["reseeded"] > 0 for r in lines), [r["reseeded"] for r in lines]
        assert all(r["reseeded"] == 0 for r in lines[:5])
        assert lines[0]["loss"] == lines[0]["recon_loss"]  # no aux loss before the warm-up's ramp
    assert_checkpoints_match(jdir, pdir)
    assert_sample_dumps_match(jdir, pdir)


def test_a_port_step_from_each_jax_state_is_the_jax_line(tmp_path):
    """On the dump of seed 0, where run F's loops part at step 13 (a
    post-net ReLU input between their parameters), every train line of the
    JAX loop is one port step from the JAX loop's previous checkpoint on
    the loop's batch, within the loops' bounds: the port computes the JAX
    step at the JAX parameters, on each side of the crossing."""
    from wavenet_autoencoders_tpu_torch.data.dataset import WaveDataset, data_iterator
    from wavenet_autoencoders_tpu_torch.models import build_model
    from wavenet_autoencoders_tpu_torch.train.checkpoint import load_checkpoint
    from wavenet_autoencoders_tpu_torch.train.step import init_state, make_train_step

    steps = 13
    jcfg, cfg = quality_cfgs("run_F", **{**SCHEDULE, "checkpoint_interval": 1})
    train_dump, dev_dump = _dump(tmp_path / "train", 8, 0), _dump(tmp_path / "dev", 2, 1)
    jdir = tmp_path / "jax"
    jtrain(jcfg, str(train_dump), str(jdir), max_steps=steps, log_every=1, dev_dump_root=str(dev_dump),
           mesh=_one_device())
    lines = [r for r in _records(jdir) if r["phase"] == "train_no_dev"][:steps]
    model = build_model(cfg, device="cpu").train()
    step_fn = make_train_step(cfg, model)
    batches = data_iterator(WaveDataset(str(train_dump), cfg), cfg, prefetch=0)
    for i, want in enumerate(lines):
        batch = {k: torch.from_numpy(np.asarray(v)) for k, v in next(batches).items()}
        state = init_state(cfg, model)
        if i:
            load_checkpoint(state, jdir / f"checkpoint_step{i:09d}.npz")
        _, m = step_fn(state, batch)
        assert want["step"] == i + 1
        for k in METRICS:
            if k in want:
                np.testing.assert_allclose(float(m[k]), want[k], rtol=1e-5, atol=0, err_msg=f"step {i + 1} {k}")


NOISE_STEPS = 8
# Every draw of the JAX step's key chain, each case narrowed as run K and
# run through 8 steps of SCHEDULE (the VQ warm-up's end, a checkpoint with
# its sample dump at step 6, the dev pass at step 8): run E (time jitter from
# step 0, per_side false; crops of 3 latent frames), run K with decoder
# dropout and VQ-dropout, and the Gumbel-softmax families. The MFCC AE runs
# without the dev pass: the JAX eval step scores every model's output as a
# waveform and fails on feature outputs (ROADMAP.md section 3). Each case:
# (config, overrides, share of live parameters in its checkpoints: behind
# the Gumbel-softmax at tau 0.1 the encoders get moments 100x under the
# decoders', and 75 % (CatWAE) and 46 % (CatMfccAE) of the elements are
# live, measured)
NOISE_CASES = {
    "run_E": ("run_E", dict(max_time_steps=1920), 0.85),
    "dropout_vq_drop": ("run_K", dict(dropout=0.1, vq_drop=True, drop_dim=2), 0.85),
    "catae": ("catae", dict(K=8, num_slices=2), 0.7),
    "cat_mfcc_ae": ("ae", dict(name="cat_ae", cin_channels=39, frame_rate=25, K=8, num_slices=2,
                               dev_epoch_interval=10**6), 0.4),
}
# Run E is held to twice the JAX loop's own spread where that exceeds
# 1e-5: its narrowed config (commitment scale 1 behind the instance norm,
# over 3 latent frames) gives encoder gradients that are near-cancelling
# sums, and the JAX loop on one device and on two parts by up to 4.2e-5 in
# the grad norm and 6.1e-6 in the aux loss over these 8 steps (dump seeds
# 30, 31, 35; measured), with every loss within 3.1e-7; its parameters at
# the step-6 checkpoint likewise
SPREAD_RATIO = 2.0


def _noise_cfgs(case):
    from test_torch_port_quality_runs import NARROW

    from wavenet_autoencoders_tpu.config import load_preset as jload
    from wavenet_autoencoders_tpu_torch.config import load_preset

    base, over, _ = NOISE_CASES[case]
    if base.startswith("run_"):
        return quality_cfgs(base, **{**SCHEDULE, **over})
    over = {**NARROW, **SCHEDULE, **over}
    return jload(base).replace(**over), load_preset(base).replace(**over)


def _jitter_moves(cfg, steps):
    """Latent frames the step key chain's jitter moves in ``steps`` steps
    (the jitter key is ``split(fold_in(PRNGKey(seed + 1), step))[1]``,
    frames clamped at the crop's edges do not move)."""
    from wavenet_autoencoders_tpu_torch.models import bottlenecks as bn
    from wavenet_autoencoders_tpu_torch.utils import jax_random as jr

    frames = cfg.max_time_steps // (cfg.hop_size * (100 // cfg.frame_rate))
    lo, hi = bn._jitter_bounds(cfg.time_jitter_prob, cfg.time_jitter_per_side)
    moved = 0
    for step in range(steps):
        u = jr.uniform(jr.split(jr.fold_in(jr.PRNGKey(cfg.seed + 1), step))[1], (cfg.batch_size, frames))
        moved += int((u[:, 1:] < lo).sum() + (u[:, :-1] > hi).sum())
    return moved


@pytest.mark.parametrize("case", sorted(NOISE_CASES))
def test_loops_with_every_draw_match_line_for_line(tmp_path, case):
    """The port's own draws (time jitter, dropout, VQ-dropout, Gumbel noise)
    from the JAX step's keys: every log line within 1e-5 (run E's within
    twice the JAX loop's own one- against two-device spread, measured here,
    where that is larger), the checkpoints and the sample dump as the
    16-step cases hold them."""
    jcfg, cfg = _noise_cfgs(case)
    rtol, param_atol = None, 2e-5
    if case == "run_E":
        assert cfg.time_jitter and not cfg.time_jitter_per_side and not cfg.time_jitter_start
        assert _jitter_moves(cfg, NOISE_STEPS) > 0
        spread_dir = tmp_path / "spread"
        train_dump, dev_dump = _dump(spread_dir / "train", 8, DUMP_SEED), _dump(spread_dir / "dev", 2, DUMP_SEED + 1)
        jtrain(jcfg, str(train_dump), str(spread_dir / "jax_two"), max_steps=NOISE_STEPS, log_every=1,
               dev_dump_root=str(dev_dump))
    jdir, pdir = _run_both(tmp_path, case, steps=NOISE_STEPS, cfgs=(jcfg, cfg))
    if case == "run_E":
        pairs = list(zip(_records(tmp_path / "spread" / "jax_two"), _records(jdir)))
        spread = {k: max(abs(a[k] - b[k]) / abs(b[k]) for a, b in pairs if b.get(k)) for k in METRICS}
        print("run E: the JAX loop's one- and two-device lines part by", {k: f"{v:.2e}" for k, v in spread.items()})
        rtol = {k: max(1e-5, SPREAD_RATIO * v) for k, v in spread.items()}
        name = "checkpoint_step000000006.npz"
        a, b = dict(np.load(tmp_path / "spread" / "jax_two" / name)), dict(np.load(jdir / name))
        p_spread = max(np.abs(a[k] - b[k]).max() for k in b if k.startswith("params/"))
        print(f"run E: the JAX loop's one- and two-device parameters at step 6 part by {p_spread:.2e}")
        param_atol = max(2e-5, SPREAD_RATIO * p_spread)
    lines = assert_logs_match(jdir, pdir, rtol)
    assert [r["step"] for r in lines][:NOISE_STEPS] == list(range(1, NOISE_STEPS + 1))
    assert_checkpoints_match(jdir, pdir, NOISE_CASES[case][2], param_atol)
    audio = sorted(p.relative_to(jdir) for p in jdir.rglob("*.wav"))
    assert audio == sorted(p.relative_to(pdir) for p in pdir.rglob("*.wav"))
    for rel in audio:
        got, want = wavfile.read(pdir / rel)[1], wavfile.read(jdir / rel)[1]
        assert got.shape == want.shape and (got != want).mean() <= 1 / 500, rel


def test_two_rank_dp_steps_with_every_draw_equal_one_process(tmp_path):
    """Two gloo ranks of a tiny svqwae with time jitter (from step 0,
    per_side false), VQ-dropout and decoder dropout: each rank draws its
    rows of the global batch's draw, and the steps equal one process's on
    the whole batch (``tests/test_torch_port_distributed.py``'s bounds, the
    Adam moments within 3e-5 of the largest: without any draw this tiny
    model's two-rank moments already part from one process's by 4.6e-6 of
    it in ``encoder/lin/w``, behind the instance norm, and with the jitter
    and VQ-dropout by 1.1e-5, while the losses agree within 1.3e-7;
    measured on the CPU)."""
    from test_torch_port_distributed import two_ranks_against_one

    ref = two_ranks_against_one(tmp_path, "noise", mu_atol=3e-5)
    assert np.isfinite(ref["metrics/1/loss"])


def _group(path: str) -> str:
    return next(g for g in GROUPS if path.startswith(g + "/"))


def _group_distances(ckpt_a, ckpt_b) -> dict:
    """‖b − a‖ / ‖a‖ of the first Adam moment (0.1 × the first step's
    gradient) over each module group."""
    a, b = dict(np.load(ckpt_a)), dict(np.load(ckpt_b))
    diff, norm = {}, {}
    for k, v in a.items():
        if "/mu/" in k:
            g = _group(k.split("/mu/", 1)[1])
            diff[g] = diff.get(g, 0.0) + float(np.square(b[k].astype(np.float64) - v).sum())
            norm[g] = norm.get(g, 0.0) + float(np.square(v.astype(np.float64)).sum())
    return {g: (diff[g] / norm[g]) ** 0.5 for g in GROUPS}


def test_bf16_first_step_loss_and_gradient_by_module_group(tmp_path):
    """Step 1 of run K's narrowed config at run K's compute dtype (bf16),
    clipping off, so the first Adam moment is 0.1 × the gradient, and the
    VQ warm-up off, so the codebooks have one (run K's step 1 ramps the aux
    loss in from 0). The loss is held within 1e-3 relative. Per module
    group, the port's bf16 gradient is held to the f32 gradient (the JAX
    step's, which the port's f32 step equals within 1e-5) no more than
    ``BF16_ERROR_RATIO`` times as far as the JAX package's bf16 gradient
    is; the distance between the two bf16 gradients is printed."""
    over = dict(clip_thresh=-1.0, vq_warmup_steps=0, checkpoint_interval=1, dev_epoch_interval=100)
    jdir, pdir = _run_both(tmp_path, "run_K", compute_dtype="bfloat16", **over)
    want, got = _records(jdir)[0], _records(pdir)[0]
    assert want["step"] == got["step"] == 1
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-3)
    jcfg, _ = quality_cfgs("run_K", **{**SCHEDULE, **over})
    jtrain(jcfg, str(tmp_path / "train"), str(tmp_path / "f32"), max_steps=1, log_every=1, mesh=_one_device())
    name = "checkpoint_step000000001.npz"
    f32 = tmp_path / "f32" / name
    jax_err, port_err = _group_distances(f32, jdir / name), _group_distances(f32, pdir / name)
    between = _group_distances(jdir / name, pdir / name)
    print("bf16 step 1 by group: port vs JAX", between, "| JAX vs f32", jax_err, "| port vs f32", port_err,
          "| grad norm", got["grad_norm"], "against", want["grad_norm"])
    for g in GROUPS:
        assert port_err[g] <= BF16_ERROR_RATIO * jax_err[g], (g, port_err, jax_err)
