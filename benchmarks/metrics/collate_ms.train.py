"""Host time the port's Python collator takes to make a batch: the
tracer's ``data.collate`` span (the item reads, the crops and the stack,
inside ``data.load`` in the prefetch thread) of each window step's batch,
a median over the window's steps before the profiler first ran
(``benchlib/span_rows.py``). None where no batch was collated in Python,
as on the native loader's path of mu-law input."""
import statistics

from benchlib.span_rows import before_profiler

UNIT = "ms/batch"


def read(run):
    rows = before_profiler(run)
    if not rows:
        return None
    collated = {s.batch: s.ms for s in run["spans"]["spans"] if s.name == "data.collate"}
    ms = [collated[r["batch"]] for r in rows if r["batch"] in collated]
    return statistics.median(ms) if ms else None
