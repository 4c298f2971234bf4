"""Host time of a train step outside its waits and its graph's launch:
the ``step`` span less its ``step.inputs_wait`` and ``step.launch``, a
median over the window's steps before the profiler first ran
(``benchlib/span_rows.py``)."""
from benchlib.span_rows import before_profiler, median

UNIT = "ms/step"


def read(run):
    return median(before_profiler(run), "host_ms")
