"""The port's tracer records (``wavenet_autoencoders_tpu_torch/utils/spans.py``)
as one row a window step, for the metric readers and ``span_report.py``.

A train run's ``run["spans"]`` (``--trace 1`` only) holds the records of
its window, and ``run["window_from"]`` the state's step at the window's
first step: window step ``i`` is the ``step`` span tagged ``window_from +
i``. Pure Python over the records: it imports neither torch nor the
program.
"""
from __future__ import annotations

import statistics


def per_step(recs: dict, intervals: list, window_from: int) -> list[dict]:
    """One row a window step that has its ``step`` span: its device
    interval and its spans' host ms (``launch_ms`` = ``step.launch``,
    ``inputs_wait_ms`` = ``step.inputs_wait``, ``host_ms`` = ``step`` less
    both, ``wait_ms`` / ``build_ms`` = the ``data.wait`` / ``data.build``
    of its batch, None where not recorded), ``launches`` (its
    ``step.launch`` spans) and its ``host.pinned_allocs``."""
    by_name: dict = {}
    for s in recs["spans"]:
        by_name.setdefault(s.name, []).append(s)
    steps = {s.step: s for s in by_name.get("step", [])}
    kids: dict = {}
    for s in recs["spans"]:
        if s.parent is not None:
            kids.setdefault((s.parent, s.name), []).append(s)
    waits = {s.batch: s for s in by_name.get("data.wait", [])}
    builds = {s.batch: s for s in by_name.get("data.build", [])}
    pinned: dict = {}
    for name, n, parent in recs["counts"]:
        if name == "host.pinned_allocs":
            pinned[parent] = pinned.get(parent, 0) + n
    rows = []
    for i, iv in enumerate(intervals):
        st = steps.get(window_from + i)
        if st is None:
            continue
        ms = lambda name: sum(k.ms for k in kids.get((st.id, name), []))  # noqa: E731
        w, b = waits.get(st.batch), builds.get(st.batch)
        rows.append({"i": i, "step": st.step, "batch": st.batch, "interval_ms": iv, "step_ms": st.ms,
                     "launch_ms": ms("step.launch"), "inputs_wait_ms": ms("step.inputs_wait"),
                     "host_ms": st.ms - ms("step.launch") - ms("step.inputs_wait"),
                     "launches": len(kids.get((st.id, "step.launch"), [])),
                     "wait_ms": w.ms if w else None, "ready": w.ready if w else None,
                     "build_ms": b.ms if b else None, "pinned_allocs": pinned.get(st.id, 0)})
    return rows


def before_profiler(run: dict) -> list[dict]:
    """The rows of the window's steps before the profiler first ran in the
    process (window steps 0 to the profiled stretch's ``first`` − 1; all of
    them without a stretch). The profiler slows the host's
    ``cudaGraphLaunch`` inside its stretch and for the rest of the process
    after it, so host spans are read here alone. Empty where the run holds
    no records or the tracer dropped any."""
    recs = run.get("spans")
    if not recs or recs["dropped"]:
        return []
    rows = per_step(recs, run["intervals_ms"], run["window_from"])
    s = run.get("stretch")
    return rows if s is None else [r for r in rows if r["i"] < s["first"]]


def median(rows: list[dict], key: str) -> float | None:
    """The median of ``key`` over the rows that have it; None where none does."""
    v = [r[key] for r in rows if r[key] is not None]
    return statistics.median(v) if v else None
