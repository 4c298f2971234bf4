"""The profiler's stretch of a run and what is read from it: the device's
operations (kernels, copies, sets) with their names and times, the host's
spans (the benchmark's ``bench.*`` ranges and the program's operators), the
busy union, the idle gaps and the breakdown the result line carries. All
times are nanoseconds on the profiler's one clock."""
from __future__ import annotations

from dataclasses import dataclass, field

import torch

WINDOW = "bench.window"


@dataclass
class Trace:
    device: list = field(default_factory=list)  # (name, start_ns, end_ns)
    host: list = field(default_factory=list)    # (name, start_ns, end_ns)
    lo: int = 0
    hi: int = 0

    @property
    def window_s(self) -> float:
        return (self.hi - self.lo) / 1e9

    def clipped(self):
        for name, a, b in self.device:
            a, b = max(a, self.lo), min(b, self.hi)
            if b > a:
                yield name, a, b

    def device_s(self, match=None) -> float:
        """Summed device time of the operations whose name ``match`` accepts
        (every operation by default)."""
        return sum(b - a for n, a, b in self.clipped() if match is None or match(n)) / 1e9

    def count(self, match) -> int:
        return sum(1 for n, _, _ in self.clipped() if match(n))

    def busy_s(self) -> float:
        """The union of the device's operations inside the window."""
        return sum(b - a for a, b in _union([(a, b) for _, a, b in self.clipped()])) / 1e9

    def gaps(self) -> list[tuple[int, int]]:
        spans = _union([(a, b) for _, a, b in self.clipped()])
        out, at = [], self.lo
        for a, b in spans:
            if a > at:
                out.append((at, a))
            at = max(at, b)
        if self.hi > at:
            out.append((at, self.hi))
        return out

    def host_at(self, t: int) -> str:
        """What the host was doing at ``t`` (a gap's midpoint): the innermost
        benchmark span and the innermost operator around it."""
        inside = [(b - a, n) for n, a, b in self.host if a <= t < b and n != WINDOW]
        spans = sorted(x for x in inside if x[1].startswith("bench."))
        ops = sorted(x for x in inside if not x[1].startswith("bench."))
        parts = ([spans[0][1]] if spans else []) + ([ops[0][1]] if ops else [])
        return " / ".join(parts) or "host idle"

    def breakdown(self, top: int = 10) -> dict:
        by_name: dict = {}
        for n, a, b in self.clipped():
            by_name[n] = by_name.get(n, 0) + (b - a)
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        gaps = sorted(self.gaps(), key=lambda g: g[0] - g[1])[:top]
        return {"device_ops": [[n[:200], t / 1e9] for n, t in ops],
                "idle_gaps": [[self.host_at((a + b) // 2), (b - a) / 1e9] for a, b in gaps]}


def _union(spans):
    out = []
    for a, b in sorted(spans):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


class Profiler:
    """``torch.profiler`` over one stretch of a run (CPU and CUDA), read
    into a :class:`Trace` whose window is the stretch's ``bench.window``
    range; ``with prof.window():`` marks it."""

    def __init__(self, cuda: bool):
        acts = [torch.profiler.ProfilerActivity.CPU]
        if cuda:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self.prof = torch.profiler.profile(activities=acts)
        self.trace: Trace | None = None

    def __enter__(self):
        self.prof.__enter__()
        return self

    def window(self):
        return torch.profiler.record_function(WINDOW)

    def __exit__(self, *exc):
        self.prof.__exit__(*exc)
        if exc[0] is None:
            self.trace = read(self.prof)
        return False


def read(prof) -> Trace:
    t = Trace()
    for e in prof.profiler.kineto_results.events():
        name, a = e.name(), e.start_ns()
        b = a + e.duration_ns()
        on_device = e.device_type() == torch.autograd.DeviceType.CUDA
        # a host range's shadow on the device's timeline is no device operation
        if on_device and (name.startswith("bench.") or getattr(e, "is_user_annotation", lambda: False)()):
            continue
        (t.device if on_device else t.host).append((name, a, b))
    windows = [(a, b) for n, a, b in t.host if n == WINDOW]
    if windows:
        t.lo, t.hi = windows[0]
    return t
