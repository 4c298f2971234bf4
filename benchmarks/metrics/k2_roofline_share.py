"""K2 (the fused stack's forward, ``csrc/glu_stack.cu``) against its
roofline: the frozen ``glu_bound`` forward bound at the cell's batch,
crop and widths, over K2's device time per launch in the profiled stretch."""
from counts.flops import bound_ms, glu_bound, widths, share
from counts.kernels import is_k2

UNIT = "%"


def read(run):
    tr, s = run.get("trace"), run.get("stretch")
    if run.get("kind") != "train" or tr is None or not s or not s["k2"] or not tr.count(is_k2):
        return None
    w = widths(run["cfg"])
    f2, by2, _, _ = glu_bound(run["B"], run["T"], w["C"], w["G"], w["S"], w["cin"], w["L"], w["gin"] > 0)
    return share(bound_ms(f2, by2), 1e3 * tr.device_s(is_k2) / s["k2"])
