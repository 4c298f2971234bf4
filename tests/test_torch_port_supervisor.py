"""The port's training supervisor (``train/supervisor.py``), mirroring
tests/test_supervisor.py's seven cases with a fake trainer subprocess:
clean completion, crash and restart, collapse-abort (exit 3) is terminal, a
hang (the log goes quiet: SIGUSR1 for a stack dump, then a kill), an
identical-failure loop (zero progress across restarts), the probe gating
the launch, and the CLI entry; the probe is injected. Then the port's own
parts: the default command relaunches the port's CLI, and the default probe
is a CUDA matmul that imports no JAX (read, never run on the CPU)."""
from __future__ import annotations

import sys
import textwrap

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from wavenet_autoencoders_tpu_torch.train import supervisor as S  # noqa: E402
from wavenet_autoencoders_tpu_torch.train.supervisor import Supervisor, SupervisorPolicy  # noqa: E402

FAKE = textwrap.dedent(
    """
    import json, os, signal, sys, time, faulthandler
    faulthandler.register(signal.SIGUSR1, all_threads=True)
    mode = sys.argv[1]
    state_f = sys.argv[2]           # persists "resume step" across restarts
    target = int(sys.argv[3])
    start = 0
    if os.path.exists(state_f):
        start = json.load(open(state_f))["step"]
    if mode == "clean":
        for s in range(start + 1, target + 1):
            print(f"step {s} loss 1.0", flush=True)
        sys.exit(0)
    if mode == "crash_once":
        stop = target if start > 0 else target // 2
        for s in range(start + 1, stop + 1):
            print(f"step {s} loss 1.0", flush=True)
            json.dump({"step": s}, open(state_f, "w"))
        sys.exit(0 if start > 0 else 9)
    if mode == "collapse":
        for s in range(start + 1, 4):
            print(f"step {s} loss 1.0", flush=True)
        print("collapse_abort: perplexity dead", flush=True)
        sys.exit(3)
    if mode == "hang":
        print(f"step {start + 1} loss 1.0", flush=True)
        signal.signal(signal.SIGTERM, signal.SIG_IGN)
        while True:
            time.sleep(1)
    if mode == "always_crash_at_zero":
        sys.exit(7)
    """
)


@pytest.fixture()
def fake_trainer(tmp_path):
    script = tmp_path / "fake_trainer.py"
    script.write_text(FAKE)
    return script


def _sup(tmp_path, fake_trainer, mode, target, probe=lambda: True, **pol):
    log = tmp_path / "train.log"
    policy = SupervisorPolicy(
        target_step=target,
        stale_s=pol.pop("stale_s", 2.0),
        grace_s=pol.pop("grace_s", 0.5),
        poll_s=0.2,
        backoff0_s=0.05,
        backoff_max_s=0.2,
        dump_wait_s=0.3,
        **pol,
    )
    cmd = [
        sys.executable,
        str(fake_trainer),
        mode,
        str(tmp_path / "state.json"),
        str(target),
    ]
    return Supervisor(cmd=cmd, log_path=log, policy=policy, probe=probe), log


def test_clean_run_completes(tmp_path, fake_trainer):
    sup, log = _sup(tmp_path, fake_trainer, "clean", target=5)
    res = sup.run()
    assert res.status == "done"
    assert res.last_step == 5
    assert res.restarts == 0
    assert (tmp_path / "TRAIN_DONE").exists()


def test_crash_is_restarted_to_completion(tmp_path, fake_trainer):
    sup, log = _sup(tmp_path, fake_trainer, "crash_once", target=8)
    res = sup.run()
    assert res.status == "done"
    assert res.last_step == 8
    assert res.restarts == 1
    assert "died rc=9" in log.read_text()


def test_collapse_abort_is_terminal(tmp_path, fake_trainer):
    sup, log = _sup(tmp_path, fake_trainer, "collapse", target=100)
    res = sup.run()
    assert res.status == "collapse"
    assert res.restarts == 0  # no relaunch after a diagnosed-dead run
    assert (tmp_path / "TRAIN_FAILED").exists()


def test_hang_gets_stack_dump_then_kill(tmp_path, fake_trainer):
    # hang ignores SIGTERM; supervisor must SIGUSR1 (stack dump) then KILL.
    # zero-progress accounting then stops the restart loop.
    sup, log = _sup(
        tmp_path, fake_trainer, "hang", target=100, max_zero_progress=2
    )
    res = sup.run()
    text = log.read_text()
    assert "requesting stack dump" in text
    assert "Current thread" in text  # faulthandler actually wrote a stack
    assert res.status == "gave_up"
    assert (tmp_path / "TRAIN_FAILED").exists()


def test_zero_progress_loop_gives_up(tmp_path, fake_trainer):
    sup, log = _sup(
        tmp_path, fake_trainer, "always_crash_at_zero", target=100,
        max_zero_progress=3,
    )
    res = sup.run()
    assert res.status == "gave_up"
    assert res.restarts == 2  # 3rd zero-progress check fires before relaunch


def test_probe_gates_launch(tmp_path, fake_trainer):
    calls = {"n": 0}

    def flaky_probe():
        calls["n"] += 1
        return False

    sup, log = _sup(tmp_path, fake_trainer, "clean", target=3, probe=flaky_probe)
    res = sup.run()
    assert res.status == "probe_failed"
    assert calls["n"] == 2
    assert not (tmp_path / "TRAIN_DONE").exists()


def test_cli_entrypoint(tmp_path, fake_trainer):
    log = tmp_path / "cli.log"
    rc = S.main(
        [
            "--steps", "4", "--log", str(log),
            "--stale-s", "2", "--grace-s", "0.5", "--poll-s", "0.2",
            "--",
            sys.executable, str(fake_trainer), "clean",
            str(tmp_path / "state.json"), "4",
        ],
        probe=lambda: True,
    )
    assert rc == 0
    assert "step 4" in log.read_text()


def test_default_command_relaunches_the_port_cli():
    assert S.trainer_command(["train", "--preset", "svqwae", "d", "e"]) == [
        sys.executable, "-m", "wavenet_autoencoders_tpu_torch.cli.main", "train", "--preset", "svqwae", "d", "e"]
    assert S.trainer_command([sys.executable, "x.py"]) == [sys.executable, "x.py"]


def test_default_probe_is_a_cuda_matmul_without_jax():
    import inspect

    assert Supervisor.__dataclass_fields__["probe"].default is S.default_cuda_probe
    src = inspect.getsource(S.default_cuda_probe)
    assert "device='cuda'" in src and "import torch" in src and "jax" not in src
