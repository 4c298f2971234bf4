"""The whole train step's share of the H100's bf16 peak: the step's FLOPs
(``counts.flops.train_step_flop``: forward times 3, no recomputation) times
the steps over their time, from the window's steps outside the profiled
stretch (each step's interval between CUDA events)."""
from counts.flops import H100_BF16_FLOPS, train_step_flop

UNIT = "%"


def read(run):
    if run.get("kind") != "train":
        return None
    iv = run.get("intervals_ms") or []
    s = run.get("stretch")
    if s is not None:  # the stretch's steps and the one after its closing synchronisation
        skip = set(range(s["first"], s["first"] + s["steps"] + 1))
        iv = [v for i, v in enumerate(iv) if i not in skip]
    if not iv:
        return None
    return 100.0 * train_step_flop(run["cfg"], run["B"], run["T"]) * len(iv) / (sum(iv) / 1e3) / H100_BF16_FLOPS
