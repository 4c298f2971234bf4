"""The port's tensor parallelism on the CPU (gloo), against the JAX
package's rules and TP step and against the port's own one-process step:
the 13 sharding rules leaf by leaf (``param_sharding_tree`` on a (4, 2)
mesh), the mesh's axes and rank order, the per-half gate shards, float64
gradients of a 2-rank model group, 2-rank train steps (unfused, fused
through the plain K2/K3, with dropout), the JAX TP step, a 2 x 2 TP x DP
step with EMA codebooks, and ``train`` through the CLI on 2 ranks with its
checkpoint read back by the port and by the JAX package.

Rendezvous is a FileStore in ``tmp_path``, and every subprocess has a
timeout; the workers (``tests/_torch_port_tp_worker.py``) import only the
port.

Tolerances:
- float64 gradients: 1e-10 of the largest gradient (only the summation
  order differs);
- f32 steps against the one-process step: loss and grad norm 1e-5
  relative; updated parameters 1e-5 of the largest parameter magnitude
  (2.5% of one step of Adam at lr 4e-4: a gradient whose f32 rounding
  differs through cancellation moves its Adam update by up to ~4e-3 lr,
  measured on the CPU in encoder/blocks/3/w), leaving out the elements whose Adam moment is f32 noise in either run,
  as tests/test_torch_port_train.py does: svqwae's instance norm removes
  the encoder's constant-over-time shifts exactly, so the projection
  bias's gradient is 0 in exact arithmetic (3e-13 in the float64 test),
  and Adam's sign-like first steps move such elements by +-lr either way.
  The noise is larger here than across the two packages: the model group
  sums the conditioning's gradient in another order, and the bias's
  moments reached 3.8e-5 of the largest moment after 2 steps (measured on
  the CPU), so |mu| <= 1e-4 of the largest moment counts as noise; at
  least 85% of the elements are held;
- against the JAX TP step on the 8-device CPU mesh: rtol 2e-3, the JAX
  package's own TP tolerance (tests/test_parallel.py);
- TP x DP with EMA codebooks: cluster sizes rtol 1e-4 and codebooks rtol
  2e-3 (atol 1e-6), as tests/test_parallel.py holds the JAX mesh;
- logits of a TP checkpoint, port against JAX: 1e-4 abs (f32).
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402

from _torch_port_tp_worker import grads64, run  # noqa: E402
from _torch_port_util import TINY_SVQWAE  # noqa: E402
from wavenet_autoencoders_tpu_torch.models import build_model  # noqa: E402
from wavenet_autoencoders_tpu_torch.parallel.mesh import (  # noqa: E402
    Shard,
    coords,
    leaf_shard,
    local_slice,
    mesh_axes,
    place_local,
    tp_shards,
)
from wavenet_autoencoders_tpu_torch.utils.params import flatten_params, shard_params  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
WORKER = Path(__file__).with_name("_torch_port_tp_worker.py")
TIMEOUT = 150
LIVE_MU = 1e-4
TP_HP = TINY_SVQWAE + ",gate_channels=16"
TP_OVER = {"upsample_params": {"upsample_scales": [2, 2]}, "batch_size": 4, "clip_thresh": 1.0,
           "mesh_shape": {"data": -1, "model": 2}}


def _env():
    return {**os.environ, "PYTHONPATH": str(ROOT), "OMP_NUM_THREADS": "1"}


def _wait(procs, logs, timeout=TIMEOUT):
    try:
        for p in procs:
            p.wait(timeout=timeout)
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        pytest.fail("a rank timed out:\n" + "\n".join(f.read_text()[-3000:] for f in logs))
    for p, f in zip(procs, logs):
        assert p.returncode == 0, f.read_text()[-4000:]


def _batches(n, B=4, T=32, seed=0):
    rng = np.random.default_rng(seed)
    return [{"x": rng.integers(0, 32, (B, T)).astype(np.int32),
             "y": rng.integers(0, 32, (B, T, 1)).astype(np.int32),
             "c": rng.standard_normal((B, T, 39)).astype(np.float32),
             "g": rng.integers(0, 8, B).astype(np.int32),
             "lengths": np.array([T, T - 13, T - 2, 9][:B], np.int32)} for _ in range(n)]


def _inputs(tmp_path, spec, params, batches):
    out = {"spec": json.dumps(spec)}
    out.update({f"params/{k}": v for k, v in params.items()})
    for i, b in enumerate(batches):
        out.update({f"batch/{i}/{k}": v for k, v in b.items()})
    path = tmp_path / "inputs.npz"
    np.savez(path, **out)
    return path


def _spec(**over):
    return {"preset": "svqwae", "hparams": TP_HP, "over": {**TP_OVER, **over}}


def _seeded_params(spec):
    from _torch_port_tp_worker import make_cfg

    model = build_model(make_cfg(spec), device="cpu")
    return {k: v.detach().numpy() for k, v in flatten_params(model).items()}


def _spawn(tmp_path, inputs, world):
    """Run ``world`` worker ranks on ``inputs``; returns their outputs."""
    init = f"file://{tmp_path / 'store'}"
    outs = [tmp_path / f"rank{i}.npz" for i in range(world)]
    logs = [tmp_path / f"rank{i}.log" for i in range(world)]
    procs = [subprocess.Popen([sys.executable, str(WORKER), init, str(world), str(i), str(inputs), str(outs[i])],
                              cwd=tmp_path, env=_env(), stdout=open(logs[i], "w"), stderr=subprocess.STDOUT)
             for i in range(world)]
    _wait(procs, logs)
    return [dict(np.load(o)) for o in outs]


def _assert_steps_close(got, ref, steps):
    for i in range(steps):
        for k in ("loss", "recon_loss", "aux_loss", "perplexity", "grad_norm"):
            np.testing.assert_allclose(got[f"metrics/{i}/{k}"], ref[f"metrics/{i}/{k}"], rtol=1e-5,
                                       err_msg=f"step {i} {k}")
    mu_max = max(np.abs(v).max() for k, v in ref.items() if k.startswith("mu/"))
    p_max = max(np.abs(v).max() for k, v in ref.items() if k.startswith("params/"))
    n_live = n_all = 0
    for k, v in ref.items():
        if k.startswith("params/"):
            mu = "mu/" + k[len("params/"):]
            live = (np.abs(ref[mu]) > LIVE_MU * mu_max) & (np.abs(got[mu]) > LIVE_MU * mu_max)
            n_live, n_all = n_live + live.sum(), n_all + live.size
            np.testing.assert_allclose(got[k][live], v[live], rtol=0, atol=1e-5 * p_max, err_msg=k)
        elif k.startswith("model_state/"):
            np.testing.assert_allclose(got[k], v, rtol=0, atol=1e-5 * np.abs(v).max(), err_msg=k)
    assert n_live > 0.85 * n_all, (n_live, n_all)


# ---- the rules and the mesh ----


@pytest.mark.parametrize("preset", ["svqwae", "inae", "new_inae", "vocoder_raw"])
def test_rules_shard_the_axis_jax_param_sharding_tree_names(preset):
    from jax.sharding import Mesh

    from wavenet_autoencoders_tpu.config import load_preset as jload_preset
    from wavenet_autoencoders_tpu.models.zoo import build_model as jbuild
    from wavenet_autoencoders_tpu.parallel.mesh import _path_str, param_sharding_tree
    from wavenet_autoencoders_tpu_torch.config import load_preset

    jmodel = jbuild(jload_preset(preset))
    params = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0))[0]
    mesh = Mesh(np.asarray(jax.devices()).reshape(4, 2), ("data", "model"))
    want = {}
    for path, sh in jax.tree_util.tree_flatten_with_path(param_sharding_tree(params, mesh, tp=True))[0]:
        spec = tuple(sh.spec)
        want[_path_str(path)] = spec.index("model") if "model" in spec else None
    model = build_model(load_preset(preset), device="cpu")
    shapes = {k: tuple(p.shape) for k, p in flatten_params(model).items()}
    got = {k: (None if (s := leaf_shard(k, shape)) is None else s.axis) for k, shape in shapes.items()}
    assert got == want
    assert sum(a is not None for a in got.values()) > 0
    for model_axis in (2, 4):
        assert set(tp_shards(shapes, model_axis)) == {k for k, a in got.items() if a is not None}


@pytest.mark.parametrize("world,model,batch", [(8, 2, 8), (8, 4, 40), (4, 2, 2), (6, 2, 3), (2, 2, 40)])
def test_mesh_axes_and_rank_order_are_the_jax_mesh(world, model, batch):
    from wavenet_autoencoders_tpu.config import load_preset as jload_preset
    from wavenet_autoencoders_tpu.parallel.mesh import make_mesh_for_batch
    from wavenet_autoencoders_tpu_torch.config import load_preset

    shape = {"data": -1, "model": model}
    devices = jax.devices()[:world]
    mesh = make_mesh_for_batch(jload_preset("svqwae").replace(mesh_shape=shape), batch, devices=devices)
    cfg = load_preset("svqwae").replace(mesh_shape=shape, batch_size=batch)
    if mesh.devices.size != world:  # the JAX mesh leaves devices out; the port refuses
        with pytest.raises(ValueError, match="cannot split batch_size"):
            mesh_axes(cfg, world)
        return
    assert mesh_axes(cfg, world) == (mesh.shape["data"], mesh.shape["model"])
    for r, d in enumerate(devices):
        (pos,) = zip(*np.nonzero(mesh.devices == d))
        assert coords(r, model) == tuple(int(i) for i in pos)


def test_mesh_shape_override_parses_as_the_jax_config():
    from wavenet_autoencoders_tpu.config import load_preset as jload_preset
    from wavenet_autoencoders_tpu_torch.config import load_preset

    hp = 'mesh_shape={"data": -1, "model": 2},batch_size=8'
    assert load_preset("svqwae", hp).mesh_shape == jload_preset("svqwae", hp).mesh_shape == {"data": -1, "model": 2}


@pytest.mark.parametrize("n", [2, 4])
def test_per_half_shards_give_each_rank_its_gate_columns(n):
    """Rank m's shards of conv/cproj/gproj (per half) and out/skip (rows)
    compute columns [m·G/2n, (m+1)·G/2n) of the layer's gated activation,
    and its partial out/skip products sum to the layer's."""
    from wavenet_autoencoders_tpu_torch.ops.conv import wn_fold
    from wavenet_autoencoders_tpu_torch.ops.modules import ResidualGLU, _gate
    from wavenet_autoencoders_tpu_torch.utils.jax_random import PRNGKey

    lp = ResidualGLU(8, 16, 3, 8, cin_channels=5, gin_channels=3, key=PRNGKey(0))
    x, c, g = torch.randn(2, 7, 8), torch.randn(2, 7, 5), torch.randn(2, 1, 3)
    full = {k: p.detach() for k, p in flatten_params(lp).items()}
    shapes = {f"layers/0/{k}": tuple(v.shape) for k, v in full.items()}
    shards = tp_shards(shapes, n)
    assert set(shards) == {f"layers/0/{k}" for k in ("conv/v", "conv/g", "conv/b", "cproj/v", "cproj/g",
                                                     "gproj/v", "gproj/g", "out/v", "skip/v")}

    def gated(p):
        w = lambda name: wn_fold(p[f"{name}/g"], p[f"{name}/v"])  # noqa: E731
        h = torch.nn.functional.conv1d(torch.nn.functional.pad(x.transpose(1, 2), (2, 0)),
                                       w("conv").permute(2, 1, 0)).transpose(1, 2) + p["conv/b"]
        return _gate(h, c @ w("cproj")[0], g @ w("gproj")[0])

    with torch.no_grad():
        want = gated(full)
        out_sum = 0.0
        for m in range(n):
            local = {k: local_slice(v, shards[f"layers/0/{k}"], n, m) if f"layers/0/{k}" in shards else v
                     for k, v in full.items()}
            cols = want.shape[-1] // n
            torch.testing.assert_close(gated(local), want[..., m * cols:(m + 1) * cols], rtol=1e-6, atol=1e-6)
            out_sum = out_sum + gated(local) @ local["out/v"][0]
        torch.testing.assert_close(out_sum, want @ full["out/v"][0], rtol=1e-5, atol=1e-6)


def test_shard_params_and_place_local_invert_each_other():
    from wavenet_autoencoders_tpu_torch.config import load_preset

    cfg = load_preset("svqwae", TP_HP).replace(mesh_shape={"data": -1, "model": 2})
    full = {k: p.detach() for k, p in flatten_params(build_model(cfg, device="cpu")).items()}
    parts = [shard_params(full, cfg, (0, m)) for m in range(2)]
    shards = tp_shards({k: tuple(v.shape) for k, v in full.items()}, 2)
    for k, v in full.items():
        if k not in shards:
            assert parts[0][k] is v and parts[1][k] is v
            continue
        assert parts[0][k].shape[shards[k].axis] * 2 == v.shape[shards[k].axis]
        buf = torch.zeros_like(v)
        for m in range(2):
            place_local(buf, parts[m][k], shards[k], 2, m)
        assert torch.equal(buf, v), k
    assert shards["wavenet/layers/0/conv/v"] == Shard(2, 2) and shards["wavenet/post2/v"] == Shard(1, 1)


# ---- a model group of 2 ranks against one process ----


def test_float64_gradients_of_a_model_group_equal_one_process(tmp_path):
    spec = {**_spec(), "mode": "grad64"}
    inputs = _inputs(tmp_path, spec, _seeded_params(spec), _batches(1))
    r0, r1 = _spawn(tmp_path, inputs, 2)
    ref = grads64(inputs, one_process=True)
    gmax = max(np.abs(v).max() for k, v in ref.items() if k.startswith("grad/"))
    assert set(r0) - {"coords"} == set(ref)
    for k, v in ref.items():
        np.testing.assert_allclose(r0[k], v, rtol=0, atol=1e-10 * gmax, err_msg=k)
        np.testing.assert_array_equal(r0[k], r1[k], err_msg=k)


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
def test_two_rank_tp_steps_equal_one_process(tmp_path, fused):
    spec = _spec(fused_stack=fused)
    inputs = _inputs(tmp_path, spec, _seeded_params(spec), _batches(2))
    r0, r1 = _spawn(tmp_path, inputs, 2)
    assert list(r0["coords"]) == [0, 0, 1, 2] and list(r1["coords"]) == [0, 1, 1, 2]
    for k in r0:
        if not k.startswith(("coords", "counters")):
            np.testing.assert_array_equal(r0[k], r1[k], err_msg=f"ranks differ: {k}")
    ref = run(inputs, one_process=True)
    _assert_steps_close(r0, ref, 2)
    # fused: every rank runs the whole stack (the plain K2 on the CPU) each step
    assert int(r0["counters/k2_calls"]) == int(r1["counters/k2_calls"]) == (2 if fused else 0)
    assert int(ref["counters/k2_calls"]) == (2 if fused else 0) and int(ref["counters/model_collectives"]) == 0
    assert int(r0["counters/model_collectives"]) > 0


def test_tp_dropout_draws_the_masks_of_one_process(tmp_path):
    """Both model ranks draw one process's masks (the JAX step's: one split
    of ``fold_in(PRNGKey(seed + 1), step)`` a layer): their step equals the
    one-process step, which draws its own."""
    from _torch_port_tp_worker import make_cfg

    spec = _spec(dropout=0.05)
    inputs = _inputs(tmp_path, spec, _seeded_params(spec), _batches(2))
    r0, r1 = _spawn(tmp_path, inputs, 2)
    ref = run(inputs, one_process=True)
    _assert_steps_close(r0, ref, 2)
    np.testing.assert_array_equal(r0["params/wavenet/layers/0/conv/v"], r1["params/wavenet/layers/0/conv/v"])
    # and the masks matter: under another seed's key the step is another one
    other = run(inputs, one_process=True, seed=make_cfg(spec).seed + 1)
    assert abs(other["metrics/0/loss"] - ref["metrics/0/loss"]) > 1e-4 * ref["metrics/0/loss"]


def test_tp_step_matches_the_jax_tp_step(tmp_path):
    """tests/test_parallel.py's TP step (vqwae, gate 16, a (4, 2) mesh over
    the 8 CPU devices, unfused) against 2 port ranks of one model group."""
    from test_train import tiny_batch, tiny_cfg

    from _torch_port_util import to_np
    from wavenet_autoencoders_tpu.models import build_model as jbuild
    from wavenet_autoencoders_tpu.parallel import make_mesh, shard_batch, shard_state
    from wavenet_autoencoders_tpu.train import init_state as jinit
    from wavenet_autoencoders_tpu.train import make_train_step as jmake
    from wavenet_autoencoders_tpu_torch.utils.params import _flatten_tree

    jcfg = tiny_cfg(mesh_shape={"data": 4, "model": 2}, gate_channels=16)
    jmodel = jbuild(jcfg)
    mesh = make_mesh(jcfg)
    js = jinit(jcfg, jmodel, jax.random.PRNGKey(0))
    params = _flatten_tree(to_np(js.params))
    batch = tiny_batch(jcfg, B=8)
    n_js, jm = jmake(jcfg, jmodel, donate=False)(shard_state(js, mesh), shard_batch(batch, mesh),
                                                 jax.random.PRNGKey(7))
    over = {k: getattr(jcfg, k) for k in ("layers", "stacks", "residual_channels", "gate_channels",
                                          "skip_out_channels", "encoder_hid", "cin_channels", "gin_channels",
                                          "n_speakers", "K", "out_channels", "quantize_channels", "upsample_params",
                                          "max_time_steps", "hop_size", "compute_dtype", "clip_thresh")}
    spec = {"preset": "vqwae", "over": {**over, "batch_size": 8, "mesh_shape": {"data": -1, "model": 2}}}
    r0, _ = _spawn(tmp_path, _inputs(tmp_path, spec, params, [batch]), 2)
    np.testing.assert_allclose(r0["metrics/0/loss"], float(jm["loss"]), rtol=2e-3)
    np.testing.assert_allclose(r0["metrics/0/grad_norm"], float(jm["grad_norm"]), rtol=2e-3)
    jp = _flatten_tree(to_np(n_js.params))
    for k in ("wavenet/layers/0/conv/v", "wavenet/post2/v", "wavenet/layers/0/out/v", "encoder/lin/w"):
        np.testing.assert_allclose(r0[f"params/{k}"], jp[k], rtol=2e-3, atol=1e-6, err_msg=k)


def test_tp_x_dp_ema_codebook_statistics_stay_global(tmp_path):
    """A 2 x 2 mesh (4 ranks: data 2, model 2) with sliced EMA codebooks
    against one process on the whole batch, as
    tests/test_parallel.py::test_vq_ema_stats_global_under_tp_x_dp holds
    the JAX mesh."""
    spec = _spec(ema=True, sliced=True)
    inputs = _inputs(tmp_path, spec, _seeded_params(spec), _batches(2))
    outs = _spawn(tmp_path, inputs, 4)
    assert [list(o["coords"]) for o in outs] == [[0, 0, 2, 2], [0, 1, 2, 2], [1, 0, 2, 2], [1, 1, 2, 2]]
    ref = run(inputs, one_process=True)
    for i in range(2):
        np.testing.assert_allclose(outs[0][f"metrics/{i}/loss"], ref[f"metrics/{i}/loss"], rtol=1e-5)
    for sl in range(2):
        for o in outs:
            np.testing.assert_allclose(o[f"model_state/vq/cluster_size/{sl}"], ref[f"model_state/vq/cluster_size/{sl}"],
                                       rtol=1e-4)
            np.testing.assert_allclose(o[f"model_state/vq/codebooks/{sl}"], ref[f"model_state/vq/codebooks/{sl}"],
                                       rtol=2e-3, atol=1e-6)
    _assert_steps_close(outs[3], ref, 2)


# ---- train through the CLI on a model group; its checkpoint ----


def _cli(dump, dev_dump, ckpt, extra=(), mesh=True):
    hp = (TP_HP + ",batch_size=4,dev_batch_size=2,checkpoint_interval=2,train_eval_interval=2,"
          'test_eval_epoch_interval=1,upsample_params={"upsample_scales": [4, 4]}'
          + (',mesh_shape={"data": -1, "model": 2}' if mesh else ""))
    return ["-m", "wavenet_autoencoders_tpu_torch.cli.main", "train", "--preset", "svqwae", "--hparams", hp,
            "--device", "cpu", str(dump), str(ckpt), "--max-steps", "2", "--dev-dump-root", str(dev_dump), *extra]


def test_tp_cli_train_checkpoint_restores_in_the_port_and_in_jax(tmp_path):
    """``train`` through the CLI on a model group of 2 for one epoch of 2
    steps: the dev pass on the sharded model (with the EMA shadow's loss),
    the checkpoint, sample-dump and decode hooks on rank 0's gathered copy
    (train and dev decode), against the same run in one process."""
    from test_torch_port_train import _dump

    from wavenet_autoencoders_tpu.config import load_preset as jload_preset
    from wavenet_autoencoders_tpu.models.zoo import build_model as jbuild
    from wavenet_autoencoders_tpu.train import init_state as jinit
    from wavenet_autoencoders_tpu.train import load_checkpoint as jload
    from wavenet_autoencoders_tpu_torch.cli.main import main
    from wavenet_autoencoders_tpu_torch.config import load_preset
    from wavenet_autoencoders_tpu_torch.train.checkpoint import load_checkpoint
    from wavenet_autoencoders_tpu_torch.train.step import init_state

    dump, _ = _dump(tmp_path, n_utts=8)
    dev_dump, _ = _dump(tmp_path / "dev", n_utts=4)
    init = f"file://{tmp_path / 'store'}"
    logs = [tmp_path / f"rank{i}.log" for i in range(2)]
    procs = [subprocess.Popen([sys.executable, *_cli(dump, dev_dump, tmp_path / f"tp{i}", ("--coordinator", init,
                                                                                 "--num-processes", "2",
                                                                                 "--process-id", str(i)))],
                              cwd=tmp_path, env=_env(), stdout=open(logs[i], "w"), stderr=subprocess.STDOUT)
             for i in range(2)]
    _wait(procs, logs)
    text = logs[0].read_text()
    assert "mesh: {'data': 1, 'model': 2} over 2 devices" in text and "skipped" not in text, text[-3000:]
    assert not (tmp_path / "tp1").exists()
    for name in ("checkpoint_step000000002.npz", "checkpoint_step000000002_ema.npz",
                 "intermediate/audio/step000000002_predicted.wav",
                 "intermediate/train_no_dev_eval/step000000002_predicted.wav",
                 "intermediate/dev_eval/step000000002_predicted.wav"):
        assert (tmp_path / "tp0" / name).exists(), name
    main(_cli(dump, dev_dump, tmp_path / "one", mesh=False)[2:])
    tp_ck, one_ck = (np.load(tmp_path / d / "checkpoint_step000000002.npz") for d in ("tp0", "one"))
    assert sorted(tp_ck.files) == sorted(one_ck.files)
    assert all(tp_ck[k].shape == one_ck[k].shape for k in tp_ck.files)
    recs = [[json.loads(line) for line in (tmp_path / d / "logs" / "metrics.jsonl").read_text().splitlines()]
            for d in ("tp0", "one")]
    for phase, keys in (("train_no_dev", ("loss",)), ("dev", ("loss", "recon_loss_ema", "perplexity"))):
        tp, one = ([r for r in rs if r["phase"] == phase] for rs in recs)
        assert [r["step"] for r in tp] == [r["step"] for r in one] and tp, phase
        for k in keys:
            np.testing.assert_allclose([r[k] for r in tp], [r[k] for r in one], rtol=1e-5, err_msg=f"{phase} {k}")

    hp = TP_HP + ',batch_size=4,upsample_params={"upsample_scales": [4, 4]}'
    cfg = load_preset("svqwae", hp)
    model = build_model(cfg, device="cpu", seed=3)
    st = load_checkpoint(init_state(cfg, model), tmp_path / "tp0" / "checkpoint_step000000002.npz")
    assert st.step == 2 and st.count == 2
    jcfg = jload_preset("svqwae", hp)
    jmodel = jbuild(jcfg)
    js = jload(jinit(jcfg, jmodel, jax.random.PRNGKey(5)), tmp_path / "tp0" / "checkpoint_step000000002.npz")
    assert int(js.step) == 2
    b = _batches(1, B=2, T=64)[0]
    b["c"] = b["c"][:, :16]  # the dump's hop: 4 samples a frame
    jy = jmodel.forward(js.params, js.model_state, jax.random.PRNGKey(0), b["x"], b["c"], b["g"], train=False)[0]
    with torch.no_grad():
        y = model(torch.from_numpy(b["x"]).long(), torch.from_numpy(b["c"]), torch.from_numpy(b["g"]),
                  train=False)[0]
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=0, atol=1e-4)
