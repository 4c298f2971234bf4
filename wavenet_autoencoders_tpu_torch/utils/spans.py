"""Spans and counters of the port's host work, kept in memory.

A span is a named stretch of one thread's time: start and end in ns, the
thread, the span it ran inside (its parent), and the step and the batch
it belongs to. A counter is a named integer, counted where the work
happens. The port records these:

=====================  ================================================  ==============================
Span                   Where                                             Tags
=====================  ================================================  ==============================
``data.build``         ``data_iterator``: one batch made (prefetch       ``batch``: the batch's seq
                       thread, or the caller's without prefetch)         (1, 2, ... in order)
``data.load``          its child: the native loader or the collate
``data.collate``       its child, on the Python collator's path alone
                       (input the native loader does not take): the
                       item reads, the crops and the stack
``data.to_device``     its child: ``train.loop.batch_to_device``
                       (pin, enqueue the copy)
``data.wait``          ``data_iterator``: the consumer waits for the     ``batch``; ``ready``: batches
                       prefetch queue                                    queued when it asked
``step``               ``train.step.TrainStep.__call__``                 ``step``: the state's step
                                                                         before it; ``batch`` (below)
``step.inputs_wait``   its child: ``StepInputs.write`` waits for the
                       last step-input copy
``step.warm``          its child: ``GraphedStep``'s eager first step
``step.capture``       its child: the graph's capture
``step.launch``        its child: ``CUDAGraph.replay`` (the host's
                       ``cudaGraphLaunch``)
=====================  ================================================  ==============================

Counters: ``data.batches`` (batches made), ``data.collated`` (of them,
those the Python collator made), ``step.replays``,
``step.captures``, ``host.pinned_allocs`` (pinned host blocks the caching
host allocator created, read at the end of each ``step`` span). Levels,
read whether or not the tracer is on and handed back with its records:
``graph.nodes`` (the last captured step graph's node count) and the
kernels' launch counters under their names in ``kernels.COUNTERS``, as
they stand when ``records()`` is called.

Off by default: ``span()`` then returns one shared no-op context manager
and ``count()`` returns after one flag test; nothing is allocated and
nothing recorded. ``enable()`` starts a recording: spans and counts go into
a buffer of ``capacity`` slots allocated there (what comes beyond it is
dropped and counted); ``disable()`` stops it; ``records()`` hands it back.
Nothing is written out while it records.

The clock is ``time.time_ns()``, Unix-epoch ns: the clock of
``torch.profiler``'s events (kineto's ``start_ns``), so spans land on a
profiler trace's timeline. The tracer emits no ``record_function`` range,
whose device-side shadow a trace reader could take for device work.
"""
from __future__ import annotations

import bisect
import itertools
import threading
import time
from typing import NamedTuple

from wavenet_autoencoders_tpu_torch import kernels

_ON = False
_RECORDING: _Recording | None = None
_LEVELS: dict[str, int] = {}


class Span(NamedTuple):
    """One finished span; ``id`` and ``parent`` index the recording's spans
    in the order they began. A child with no ``step`` or ``batch`` of its
    own takes its parent's; a span with neither tag nor parent takes the
    ``batch`` of the last span with a ``batch`` of its own that ended on
    its thread before it began (a ``step`` takes the batch its caller
    received from ``data_iterator`` just before)."""

    id: int
    name: str
    start_ns: int
    end_ns: int
    thread: int
    parent: int | None
    step: int | None
    batch: int | None
    ready: int | None

    @property
    def ms(self) -> float:
        return (self.end_ns - self.start_ns) / 1e6


class _Off:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Recording:
    def __init__(self, capacity: int):
        self.buf: list = [None] * capacity
        self.slots = itertools.count()  # next() is atomic under the interpreter lock
        self.local = threading.local()
        self.pinned = _pinned_allocs()

    def stack(self) -> list:
        st = getattr(self.local, "stack", None)
        if st is None:
            st = self.local.stack = []
        return st

    def put(self, slot: int, rec: tuple) -> None:
        if slot < len(self.buf):
            self.buf[slot] = rec


class _Span:
    __slots__ = ("rec", "name", "step", "batch", "ready", "slot", "parent", "t0")

    def __init__(self, rec: _Recording, name: str, step, batch, ready):
        self.rec, self.name, self.step, self.batch, self.ready = rec, name, step, batch, ready

    def __enter__(self):
        st = self.rec.stack()
        self.parent = st[-1] if st else None
        self.slot = next(self.rec.slots)
        st.append(self.slot)
        self.t0 = time.time_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.time_ns()
        self.rec.stack().pop()
        self.rec.put(self.slot, ("span", self.name, self.t0, t1, threading.get_native_id(), self.parent,
                                     self.step, self.batch, self.ready))
        return False


def span(name: str, step: int | None = None, batch: int | None = None, ready: int | None = None):
    """``with span(name, ...):`` records the block as a span while the
    tracer is on; a shared no-op otherwise."""
    if not _ON:
        return _OFF
    return _Span(_RECORDING, name, step, batch, ready)


def count(name: str, n: int = 1) -> None:
    """Adds ``n`` to counter ``name`` while the tracer is on, attributed to
    the innermost open span of the calling thread."""
    if not _ON:
        return
    s = _RECORDING
    st = s.stack()
    s.put(next(s.slots), ("count", name, n, st[-1] if st else None))


def count_pinned_allocs() -> None:
    """Counts ``host.pinned_allocs``: the pinned host blocks created since
    the last reading (``torch.cuda.host_memory_stats``), read only while
    the tracer is on."""
    if not _ON:
        return
    s = _RECORDING
    now = _pinned_allocs()
    n, s.pinned = now - s.pinned, now
    if n:
        count("host.pinned_allocs", n)


def _pinned_allocs() -> int:
    import torch

    return int(torch.cuda.host_memory_stats().get("num_host_alloc", 0)) if torch.cuda.is_initialized() else 0


def level(name: str, value: int) -> None:
    """Sets a level: a named integer that describes the program rather
    than counting its work (``graph.nodes``), kept whether or not the
    tracer is on and handed back with the records of a recording."""
    _LEVELS[name] = int(value)


def enabled() -> bool:
    return _ON


def enable(capacity: int = 1 << 17) -> None:
    """Starts a recording (the last one's records are dropped)."""
    global _ON, _RECORDING
    _RECORDING = _Recording(capacity)
    _ON = True


def disable() -> None:
    """Stops recording; spans still open finish into the recording."""
    global _ON
    _ON = False


def reset() -> None:
    """Stops recording and drops the recording's records."""
    global _RECORDING
    disable()
    _RECORDING = None


def records() -> dict:
    """The recording's records: ``spans`` (:class:`Span`, in the order they
    began), ``counters`` ({name: total}), ``counts`` ([(name, n, span id or
    None)], each as counted), ``levels`` (``graph.nodes`` and the kernels'
    launch counters as they stand now), and ``dropped`` (what the buffer
    had no room for). Empty without a recording."""
    s = _RECORDING
    if s is None:
        return {}
    issued = next(s.slots)
    spans, counts, counters = {}, [], {}
    own: dict[int, list] = {}  # thread: [(end, batch)] of the spans with a batch of their own
    for i, r in enumerate(s.buf[:issued]):
        if r is None:  # a span still open
            continue
        if r[0] == "count":
            _, name, n, parent = r
            counts.append((name, n, parent))
            counters[name] = counters.get(name, 0) + n
            continue
        _, name, a, b, thread, parent, step, batch, ready = r
        spans[i] = Span(i, name, a, b, thread, parent, step, batch, ready)
        if batch is not None:
            own.setdefault(thread, []).append((b, batch))
    for v in own.values():
        v.sort()
    for i, sp in spans.items():  # in slot order: a parent began, and took its slot, before its children
        up = spans.get(sp.parent)
        if up is not None:
            spans[i] = sp._replace(step=up.step if sp.step is None else sp.step,
                                   batch=up.batch if sp.batch is None else sp.batch)
        elif sp.batch is None and sp.thread in own:
            j = bisect.bisect_right(own[sp.thread], (sp.start_ns, float("inf"))) - 1
            if j >= 0:
                spans[i] = sp._replace(batch=own[sp.thread][j][1])
    return {"spans": list(spans.values()), "counters": counters, "counts": counts,
            "levels": {**_LEVELS, **kernels.launches()},
            "dropped": max(0, issued - len(s.buf))}
