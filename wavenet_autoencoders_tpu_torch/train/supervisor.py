"""Training supervisor: launch, watch, restart (counterpart of
``wavenet_autoencoders_tpu/train/supervisor.py``).

The reference's failure handling is a rolling ``checkpoint_latest.pth``
plus a KeyboardInterrupt handler (``vqwae_train.py:878-910,1137-1145``);
recovery policy (when to restart, when to give up) was left to the
operator. Here it is a module: it launches the trainer (by default the
port's CLI, ``python -m wavenet_autoencoders_tpu_torch.cli.main train
...``), watches its log, and relaunches it (resuming is the trainer's
command line's business, e.g. ``--checkpoint .../checkpoint_latest.npz``).

Policy (each clause traces to an observed failure mode):

* **stall detection** — if the trainer's log goes quiet past ``stale_s``
  (after a ``grace_s`` compile grace), ask the trainer for a Python stack
  dump (SIGUSR1 -> faulthandler, registered by the launcher) so the log
  records WHY it hung, then kill the exact PID (never a pattern).
* **probe before (re)launch** — a cheap CUDA matmul in a subprocess;
  never relaunch onto a card that does not answer. Injectable for tests.
* **exponential backoff** between relaunches, capped.
* **terminal conditions** — trainer exit code ``collapse_exit_code``
  (the loop's CollapseAbort, exit 3) means the run is diagnosed dead:
  relaunching cannot help. Three consecutive relaunches with zero step
  progress = an identical-failure loop; give up with the stack dumps on
  record. A restart budget bounds the total.
* **done** — the trainer reaching ``target_step`` (parsed from its log)
  or exiting 0.

``TRAIN_DONE`` / ``TRAIN_FAILED`` marker files are written next to the
log, as the JAX package's supervisor writes them.
"""
from __future__ import annotations

import os
import re
import signal
import subprocess
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Sequence


@dataclass
class SupervisorPolicy:
    target_step: int
    stale_s: float = 360.0       # log quiet this long = stalled
    grace_s: float = 900.0       # compile grace after (re)launch
    poll_s: float = 30.0
    backoff0_s: float = 30.0
    backoff_max_s: float = 600.0
    max_restarts: int = 20
    max_zero_progress: int = 3
    collapse_exit_code: int = 3
    dump_wait_s: float = 15.0    # time for faulthandler to write the stack


@dataclass
class SupervisorResult:
    status: str          # done | collapse | gave_up | failed | probe_failed
    last_step: int
    restarts: int
    detail: str = ""


STEP_RE = re.compile(r"^step (\d+)", re.M)


def default_cuda_probe(timeout_s: float = 90.0) -> bool:
    """Card liveness: a tiny matmul on ``cuda`` in a subprocess (the
    supervisor process itself never initializes CUDA, so it outlives a
    wedged device)."""
    code = (
        "import torch\n"
        "x = torch.ones(8, 8, device='cuda'); (x @ x).sum().item()\n"
        "torch.cuda.synchronize()\n"
    )
    try:
        r = subprocess.run(
            [sys.executable, "-c", code],
            timeout=timeout_s,
            stdout=subprocess.DEVNULL,
            stderr=subprocess.DEVNULL,
        )
        return r.returncode == 0
    except subprocess.TimeoutExpired:
        return False


@dataclass
class Supervisor:
    cmd: Sequence[str]
    log_path: Path
    policy: SupervisorPolicy
    probe: Callable[[], bool] = default_cuda_probe
    env: dict | None = None
    # marker files (shell contract of the superseded watchdog scripts)
    markers_dir: Path | None = None
    _proc: subprocess.Popen | None = field(default=None, repr=False)

    def __post_init__(self):
        self.log_path = Path(self.log_path)
        if self.markers_dir is None:
            self.markers_dir = self.log_path.parent

    # -- small, test-visible pieces ------------------------------------
    def last_step(self) -> int:
        try:
            text = self.log_path.read_text(errors="replace")
        except FileNotFoundError:
            return 0
        hits = STEP_RE.findall(text)
        return int(hits[-1]) if hits else 0

    def _note(self, msg: str) -> None:
        line = f"supervisor[{time.strftime('%H:%M:%S')}]: {msg}\n"
        with open(self.log_path, "a") as f:
            f.write(line)

    def _launch(self) -> None:
        logf = open(self.log_path, "a")
        self._proc = subprocess.Popen(
            list(self.cmd),
            stdout=logf,
            stderr=subprocess.STDOUT,
            env={**os.environ, **(self.env or {})},
        )
        self._launched_at = time.time()
        self._note(f"launched trainer pid {self._proc.pid}")

    def _log_age_s(self) -> float:
        try:
            return time.time() - self.log_path.stat().st_mtime
        except FileNotFoundError:
            return 0.0

    def _watch_one(self) -> int:
        """Wait until the trainer exits or is killed for stalling;
        returns its exit code."""
        p, pol = self._proc, self.policy
        while True:
            try:
                rc = p.wait(timeout=pol.poll_s)
                return rc
            except subprocess.TimeoutExpired:
                pass
            age = self._log_age_s()
            if age > pol.stale_s and time.time() - self._launched_at > pol.grace_s:
                self._note(
                    f"log stale {age:.0f}s -> requesting stack dump "
                    f"(SIGUSR1) from {p.pid}"
                )
                try:
                    p.send_signal(signal.SIGUSR1)
                except (ProcessLookupError, PermissionError):
                    pass
                time.sleep(pol.dump_wait_s)
                self._note(f"killing stalled trainer {p.pid}")
                p.kill()
                return p.wait()

    # -- the policy loop -----------------------------------------------
    def run(self) -> SupervisorResult:
        pol = self.policy
        done_mark = self.markers_dir / "TRAIN_DONE"
        fail_mark = self.markers_dir / "TRAIN_FAILED"
        for m in (done_mark, fail_mark):
            try:
                m.unlink()
            except FileNotFoundError:
                pass

        def finish(status, detail=""):
            (done_mark if status == "done" else fail_mark).touch()
            self._note(f"{status}: {detail or 'step ' + str(self.last_step())}")
            return SupervisorResult(status, self.last_step(), restarts, detail)

        restarts = 0
        no_progress = 0
        backoff = pol.backoff0_s
        step_before = self.last_step()

        if not self.probe():
            time.sleep(min(backoff, 120.0))
            if not self.probe():
                return finish("probe_failed", "device probe failed twice before launch")
        self._launch()

        while True:
            rc = self._watch_one()
            ls = self.last_step()
            if ls >= pol.target_step - 1 or done_mark.exists():
                return finish("done")
            if rc == pol.collapse_exit_code:
                return finish(
                    "collapse",
                    f"trainer exited {rc} (collapse_abort) — relaunch cannot help",
                )
            if rc == 0:
                # clean exit below target: the trainer decided it was done
                # (nepochs bound, --max-steps override); trust it
                return finish("done", f"clean exit at step {ls} < {pol.target_step}")

            if ls <= step_before:
                no_progress += 1
                self._note(f"no step progress since last relaunch ({no_progress} consecutive)")
                if no_progress >= pol.max_zero_progress:
                    return finish(
                        "gave_up",
                        f"{no_progress} zero-progress restarts (see stack dumps above)",
                    )
            else:
                no_progress = 0
            step_before = ls

            restarts += 1
            if restarts > pol.max_restarts:
                return finish("failed", "restart budget exhausted")
            self._note(f"trainer died rc={rc} at step {ls}; backoff {backoff:.0f}s")
            time.sleep(backoff)
            backoff = min(backoff * 2, pol.backoff_max_s)
            while not self.probe():
                self._note(f"device probe failed; waiting {backoff:.0f}s")
                time.sleep(backoff)
                backoff = min(backoff * 2, pol.backoff_max_s)
            self._launch()


TRAIN_CLI = ("-m", "wavenet_autoencoders_tpu_torch.cli.main")


def trainer_command(cmd: Sequence[str]) -> list[str]:
    """The command to supervise: ``cmd`` as given, or, when it starts with
    ``train``, the port's CLI with those arguments."""
    cmd = list(cmd)
    if cmd and cmd[0] == "train":
        return [sys.executable, *TRAIN_CLI, *cmd]
    return cmd


def main(argv=None, probe: Callable[[], bool] = default_cuda_probe):
    import argparse

    ap = argparse.ArgumentParser(
        prog="python -m wavenet_autoencoders_tpu_torch.train.supervisor",
        description="supervise a trainer subprocess (stall-kill, probe, "
        "backoff-restart; see module docstring). After --, either 'train "
        "<train args>' (the port's CLI) or a full command",
    )
    ap.add_argument("--steps", type=int, required=True, help="target step")
    ap.add_argument("--log", required=True, help="trainer log (step lines parsed from here)")
    ap.add_argument("--stale-s", type=float, default=360.0)
    ap.add_argument("--grace-s", type=float, default=900.0)
    ap.add_argument("--poll-s", type=float, default=30.0)
    ap.add_argument("--max-restarts", type=int, default=20)
    ap.add_argument("cmd", nargs=argparse.REMAINDER, help="-- trainer command")
    args = ap.parse_args(argv)
    cmd = trainer_command(args.cmd[1:] if args.cmd and args.cmd[0] == "--" else args.cmd)
    if not cmd:
        ap.error("trainer command required after --")
    sup = Supervisor(
        cmd=cmd,
        log_path=Path(args.log),
        policy=SupervisorPolicy(
            target_step=args.steps,
            stale_s=args.stale_s,
            grace_s=args.grace_s,
            poll_s=args.poll_s,
            max_restarts=args.max_restarts,
        ),
        probe=probe,
    )
    res = sup.run()
    print(f"supervisor: {res.status} at step {res.last_step} ({res.restarts} restarts) {res.detail}")
    return {"done": 0, "collapse": 3}.get(res.status, 1)


if __name__ == "__main__":
    raise SystemExit(main())
