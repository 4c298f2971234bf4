"""Host time of a train step's ``cudaGraphLaunch``: its ``step.launch``
span, a median over the window's steps before the profiler first ran
(``benchlib/span_rows.py``), since the profiler lengthens the launch from
its stretch on. None where no step launched a graph (the eager step)."""
from benchlib.span_rows import before_profiler, median

UNIT = "ms/step"


def read(run):
    return median([r for r in before_profiler(run) if r["launches"]], "launch_ms")
