"""Nodes of the captured train step's CUDA graph: the tracer's
``graph.nodes`` level, read at the capture. None where the run holds no
records of the window's steps before the profiler (``benchlib/span_rows.py``)
or no graph was captured (the eager step)."""
from benchlib.span_rows import before_profiler

UNIT = "nodes"


def read(run):
    if not before_profiler(run):
        return None
    return run["spans"]["levels"].get("graph.nodes")
