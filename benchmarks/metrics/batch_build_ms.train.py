"""Host time the port's loader takes to make a batch: its ``data.build``
span (load, then the host-to-device copy, in the prefetch thread), a
median over the batches of the window's steps before the profiler first
ran (``benchlib/span_rows.py``). A batch made before the tracer turned on,
at the window's start, has none."""
from benchlib.span_rows import before_profiler, median

UNIT = "ms/batch"


def read(run):
    return median(before_profiler(run), "build_ms")
