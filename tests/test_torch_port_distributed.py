"""The port's multi-process data parallelism on the CPU (gloo), mirroring
tests/test_distributed.py: the batch slice, the data-axis rule and the
refusal of uneven tensor-parallel meshes; a 2-process train step against the
1-process step on the same global batch with EMA codebooks, reseed, time
jitter and VQ-dropout on, and rows of other lengths on the two ranks (the
global masked mean); the CLI ``train`` over 2 processes (only rank 0
writes); and a SIGTERM on one rank stopping both after the same step.

Rendezvous is a FileStore in ``tmp_path`` (no TCP port to race for), and
every subprocess has a timeout. The workers import only the port.

Tolerances (f32): loss and grad norm 1e-5 relative; parameters (the
elements whose Adam moment is not f32 noise, as in
tests/test_torch_port_train.py) and the model state 1e-5 of the tensor's
largest magnitude; Adam moments 1e-5 of the largest moment. The two ranks
hold bitwise-equal replicas.
"""
import json
import os
import signal
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from _torch_port_dp_worker import STEPS, dp_batch, dp_config, run  # noqa: E402
from _torch_port_util import TINY_SVQWAE  # noqa: E402
from wavenet_autoencoders_tpu_torch.parallel import distributed as dist  # noqa: E402
from wavenet_autoencoders_tpu_torch.parallel.mesh import check_mesh, data_axis  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
WORKER = Path(__file__).with_name("_torch_port_dp_worker.py")
LIVE_MU = 1e-5
TIMEOUT = 120


def _env():
    return {**os.environ, "PYTHONPATH": str(ROOT), "OMP_NUM_THREADS": "1"}


def _wait(procs, timeout=TIMEOUT):
    outs = []
    deadline = time.time() + timeout
    try:
        for p in procs:
            out, _ = p.communicate(timeout=max(1.0, deadline - time.time()))
            outs.append(out)
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        pytest.fail("a rank timed out:\n" + "\n".join(o[-3000:] for o in outs))
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-4000:]
    return outs


@pytest.mark.parametrize("world,rank,batch,want", [(1, 0, 8, (0, 8)), (2, 1, 8, (4, 4)), (4, 2, 40, (20, 10))])
def test_host_local_batch_slice(monkeypatch, world, rank, batch, want):
    monkeypatch.setattr(dist, "world_size", lambda: world)
    monkeypatch.setattr(dist, "rank", lambda: rank)
    assert dist.host_local_batch_slice(batch) == want


@pytest.mark.parametrize("device,rank,want", [("cuda", 3, "cuda:1"), ("cuda", 0, "cuda:0"), ("cuda:1", 0, "cuda:1"),
                                              ("cpu", 1, "cpu")])
def test_local_device_is_the_rank_modulo_the_cards(monkeypatch, device, rank, want):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert dist.local_device(device, rank) == torch.device(want)


def test_host_local_batch_slice_needs_a_divisible_batch(monkeypatch):
    monkeypatch.setattr(dist, "world_size", lambda: 4)
    with pytest.raises(AssertionError, match="6 % processes 4"):
        dist.host_local_batch_slice(6)


@pytest.mark.parametrize("batch,devices", [(8, 8), (6, 4), (40, 3), (7, 8), (5, 2)])
def test_data_axis_is_the_jax_mesh_rule(batch, devices):
    import jax

    from wavenet_autoencoders_tpu.parallel.mesh import make_mesh_for_batch

    want = make_mesh_for_batch(None, batch, devices=jax.devices()[:devices]).shape["data"]
    assert data_axis(batch, devices) == want


def test_uneven_worlds_and_gate_halves_raise():
    """A model axis that does not divide the ranks, ranks that cannot split
    the batch, and a sharded dimension the model axis does not divide (each
    half of a gate leaf) raise ValueError: the port refuses the uneven
    shards the JAX partitioner would pad."""
    from wavenet_autoencoders_tpu_torch.models import build_model
    from wavenet_autoencoders_tpu_torch.utils.params import flatten_params

    cfg = dp_config().replace(mesh_shape={"data": -1, "model": 2})
    with pytest.raises(ValueError, match="model=2 does not divide 3 processes"):
        check_mesh(cfg, 3)
    with pytest.raises(ValueError, match="model=2 does not divide 1 processes"):
        check_mesh(cfg, 1)
    with pytest.raises(ValueError, match="cannot split batch_size=4"):
        check_mesh(dp_config(), 3)
    check_mesh(dp_config(), 2)
    for gate, ok in ((36, True), (18, False)):
        shapes = {k: tuple(v.shape) for k, v in flatten_params(build_model(cfg.replace(gate_channels=gate),
                                                                           device="cpu")).items()}
        if ok:
            check_mesh(cfg, 4, shapes=shapes)
        else:
            with pytest.raises(ValueError, match=r"layers/0/conv/g: each half of dimension 0 \(9\) does not divide by "
                                                 r"mesh_shape model=2"):
                check_mesh(cfg, 4, shapes=shapes)


def test_two_process_step_equals_one_process_step(tmp_path):
    """2 ranks of 2 rows each against 1 process on the 4 rows, 2 steps with
    EMA codebooks, reseed (codes die and are revived in step 1), time
    jitter and VQ-dropout; the rows' lengths differ between the ranks."""
    outs = [tmp_path / f"rank{i}.npz" for i in range(2)]
    init = f"file://{tmp_path / 'store'}"
    procs = [subprocess.Popen([sys.executable, str(WORKER), init, "2", str(i), str(outs[i])], cwd=tmp_path,
                              env=_env(), stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for i in range(2)]
    _wait(procs)
    r0, r1 = (dict(np.load(o)) for o in outs)
    for k in r0:
        np.testing.assert_array_equal(r0[k], r1[k], err_msg=f"replicas differ: {k}")

    ref = run(slice(0, 4))
    assert set(ref) == set(r0)
    for i in range(STEPS):
        for k in ("loss", "recon_loss", "aux_loss", "perplexity", "grad_norm"):
            np.testing.assert_allclose(r0[f"metrics/{i}/{k}"], ref[f"metrics/{i}/{k}"], rtol=1e-5,
                                       err_msg=f"step {i} {k}")
        assert r0[f"metrics/{i}/reseeded"] == ref[f"metrics/{i}/reseeded"]
    assert ref["metrics/0/reseeded"] > 0
    mu_max = max(np.abs(v).max() for k, v in ref.items() if k.startswith("mu/"))
    for k, v in ref.items():
        if k.startswith("params/"):
            live = np.abs(ref["mu/" + k[7:]]) > LIVE_MU * mu_max
            np.testing.assert_allclose(r0[k][live], v[live], rtol=0, atol=1e-5 * np.abs(v).max(), err_msg=k)
        elif k.startswith("mu/"):
            np.testing.assert_allclose(r0[k], v, rtol=0, atol=1e-5 * mu_max, err_msg=k)
        elif k.startswith("model_state/"):
            np.testing.assert_allclose(r0[k], v, rtol=0, atol=1e-5 * np.abs(v).max(), err_msg=k)

    # the loss is the global masked mean; the ranks' mean of their own means
    # (mask counts 49 and 37 of the 86 shifted steps) is off by 10x the bound
    from wavenet_autoencoders_tpu_torch.models import build_model
    from wavenet_autoencoders_tpu_torch.train.step import objective, prep_x

    cfg = dp_config()
    model = build_model(cfg, device="cpu")
    b = {k: torch.from_numpy(v) for k, v in dp_batch(0).items()}
    with torch.no_grad():
        y = model(prep_x(cfg, b["x"]), b["c"], b["g"], train=False)[0]
        whole = float(objective(cfg, model, y, b, 32))
        halves = [float(objective(cfg, model, y[s], {k: v[s] for k, v in b.items()}, 32))
                  for s in (slice(0, 2), slice(2, 4))]
    assert abs(np.mean(halves) - whole) > 10 * 1e-5 * whole, (halves, whole)


def _train_cmd(dump, ckpt, rank, init, extra=(), hooks_every=2):
    hp = (TINY_SVQWAE + f",batch_size=4,checkpoint_interval={hooks_every},train_eval_interval={hooks_every},"
          'upsample_params={"upsample_scales": [4, 4]}')
    return [sys.executable, "-m", "wavenet_autoencoders_tpu_torch.cli.main", "train", "--preset", "svqwae",
            "--hparams", hp, "--device", "cpu", str(dump), str(ckpt), "--coordinator", init,
            "--num-processes", "2", "--process-id", str(rank), *extra]


def test_two_process_cli_train_only_rank0_writes(tmp_path):
    from test_torch_port_train import _dump

    dump, _ = _dump(tmp_path, n_utts=8)
    ckpts = [tmp_path / f"exp{i}" for i in range(2)]
    init = f"file://{tmp_path / 'store'}"
    procs = [subprocess.Popen(_train_cmd(dump, ckpts[i], i, init, ("--max-steps", "2")), cwd=tmp_path,
                              env=_env(), stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for i in range(2)]
    logs = _wait(procs)
    assert "data parallel: 2 processes, 2 of 4 rows each" in logs[0]
    assert not ckpts[1].exists(), sorted(ckpts[1].rglob("*"))
    for name in ("checkpoint_step000000002.npz", "checkpoint_step000000002_ema.npz", "config.json",
                 "intermediate/audio/step000000002_predicted.wav",
                 "intermediate/train_no_dev_eval/step000000002_predicted.wav"):
        assert (ckpts[0] / name).exists(), name
    recs = [json.loads(line) for line in (ckpts[0] / "logs" / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in recs if r["phase"] == "train_no_dev"][:2] == [1, 2]
    assert all(np.isfinite(r["loss"]) for r in recs if "loss" in r)
    assert "skipped" not in logs[0]


def test_sigterm_on_one_rank_stops_both_at_the_same_step(tmp_path):
    from test_torch_port_train import _dump

    dump, _ = _dump(tmp_path, n_utts=8)
    ckpt = tmp_path / "exp"
    init = f"file://{tmp_path / 'store'}"
    logs = [tmp_path / f"rank{i}.log" for i in range(2)]
    procs = [subprocess.Popen(_train_cmd(dump, ckpt, i, init, ("--max-steps", "100000"), 10**6), cwd=tmp_path,
                              env=_env(), stdout=open(logs[i], "w"), stderr=subprocess.STDOUT, text=True)
             for i in range(2)]
    try:
        deadline = time.time() + TIMEOUT
        while "step 1 loss" not in logs[0].read_text():
            assert time.time() < deadline and all(p.poll() is None for p in procs), logs[0].read_text()[-3000:]
            time.sleep(0.2)
        procs[1].send_signal(signal.SIGTERM)
        for p in procs:
            p.wait(timeout=TIMEOUT)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    texts = [f.read_text() for f in logs]
    assert [p.returncode for p in procs] == [0, 0], texts
    steps = [int(t.split("interrupted at step ")[1].split()[0]) for t in texts]
    assert steps[0] == steps[1] > 0, steps
    assert (ckpt / f"checkpoint_step{steps[0]:09d}.npz").exists()


def test_one_rank_group_through_the_cli_runs_its_collectives(tmp_path):
    """``train --coordinator ... --num-processes 1``: a process group of one
    rank runs the step's collectives (as NCCL does on one card) and trains
    what the run without a group trains."""
    import wavenet_autoencoders_tpu_torch.parallel.distributed as D
    from test_torch_port_train import _dump
    from wavenet_autoencoders_tpu_torch.cli.main import main

    dump, _ = _dump(tmp_path, n_utts=8)
    hp = TINY_SVQWAE + ',batch_size=4,ema=true,upsample_params={"upsample_scales": [4, 4]}'
    losses = {}
    for name, extra in (("group", ["--coordinator", f"file://{tmp_path / 'store'}", "--num-processes", "1",
                                   "--process-id", "0"]), ("none", [])):
        before = D.COLLECTIVES
        main(["train", "--preset", "svqwae", "--hparams", hp, "--device", "cpu", str(dump), str(tmp_path / name),
              "--max-steps", "2", *extra])
        assert (D.COLLECTIVES > before) == (name == "group")
        assert not torch.distributed.is_initialized()
        recs = [json.loads(line) for line in (tmp_path / name / "logs" / "metrics.jsonl").read_text().splitlines()]
        losses[name] = [r["loss"] for r in recs if r["phase"] == "train_no_dev"]
    np.testing.assert_allclose(losses["group"], losses["none"], rtol=1e-6)
