"""K3 (the fused stack's backward, ``csrc/glu_stack.cu``) against its
roofline: the frozen ``glu_bound`` backward bound at the cell's batch,
crop and widths, over K3's device time per launch in the profiled stretch."""
from counts.flops import bound_ms, glu_bound, widths, share
from counts.kernels import is_k3

UNIT = "%"


def read(run):
    tr, s = run.get("trace"), run.get("stretch")
    if run.get("kind") != "train" or tr is None or not s or not s["k3"] or not tr.count(is_k3):
        return None
    w = widths(run["cfg"])
    _, _, f3, by3 = glu_bound(run["B"], run["T"], w["C"], w["G"], w["S"], w["cin"], w["L"], w["gin"] > 0)
    return share(bound_ms(f3, by3), 1e3 * tr.device_s(is_k3) / s["k3"])
