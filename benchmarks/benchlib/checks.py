"""The numbers that decide ``correct``: what the timed path produced against
the plain reference (``benchmarks/reference``), each compared with its
limit from the cell's file (a cell compares the numbers its ``limits``
name; the others are printed by ``calibrate.py`` only).

Training (the first three steps of the window's own step object, on the
window's own feed). A leaf's gap is the gap between the program's norm and
the reference's, over the reference's norm of that leaf or of the median
leaf, whichever is larger; ``_worst`` takes the worst leaf, ``_q90`` the
leaf at the 90th percentile, ``_median`` the median leaf:

- ``loss_gap``: the worst step's |loss − reference loss| / |reference loss|;
- ``grad_*``: the first gradient as Adam got it (its first moment after one
  step over 1 − β₁);
- ``change_*``: the parameters' change over the three steps, over the
  counted elements: those whose float32 reference gradient of the first
  step is more than its own rounding, i.e. lies farther from nought than
  from the same gradient computed in float64, and those whose gradient is
  nought in both. An element whose gradient is nought to rounding (a bias
  in front of the instance norm, on a unit that is active at every frame)
  moves under Adam by round-off alone, so the program's and the
  reference's changes there measure their rounding;
- ``ema_*``: the EMA shadow's change over the three steps, likewise;
- ``nonfinite``: window steps whose loss is not finite.
"""
from __future__ import annotations

import math


def norms(tree: dict) -> dict:
    return {k: float(v.double().norm()) for k, v in tree.items()}


def leaf_gaps(prog: dict, ref: dict, keys=None) -> dict:
    """Per leaf |‖prog‖ − ‖ref‖| / max(‖ref‖, the median leaf's ‖ref‖)."""
    keys = sorted(ref) if keys is None else sorted(keys)
    med = sorted(ref[k] for k in keys)[len(keys) // 2]
    return {k: abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30) for k in keys}


def _quantiles(gaps: dict, name: str) -> dict:
    """The worst leaf's gap, the median leaf's and the 90th percentile's
    (nearest rank)."""
    v = sorted(gaps.values())
    return {f"{name}_worst": v[-1], f"{name}_median": v[len(v) // 2],
            f"{name}_q90": v[max(0, math.ceil(0.9 * len(v)) - 1)]}


def counted(ref_grad: dict, grad64: dict) -> dict:
    """{leaf: mask of its counted elements} for the leaves with any: the
    elements whose float32 reference gradient ``ref_grad`` lies farther from
    nought than from ``grad64``, the same gradient in float64, or is
    nought in both."""
    out = {}
    for k, g in ref_grad.items():
        g, g64 = g.double(), grad64[k].double()
        m = (g64.abs() > (g - g64).abs()) | ((g == 0) & (g64 == 0))
        if bool(m.any()):
            out[k] = m
    return out


def train_numbers(prog: dict, ref: dict, w0: dict, grad64: dict) -> dict:
    """``prog``: losses (3), first_grad, params (after step 3), ema; ``ref``:
    the reference module's ``train_steps``' output; ``w0`` the weights both
    started from; ``grad64`` the reference's first gradient in float64."""
    out = {"loss_gap": max(abs(a - b) / abs(b) for a, b in zip(prog["losses"], ref["losses"]))}
    g_ref = norms(ref["first_grad"])
    keep = counted(ref["first_grad"], grad64)
    delta = lambda tree: {k: (tree[k].double() - w0[k].double())[m] for k, m in keep.items()}  # noqa: E731
    out.update(_quantiles(leaf_gaps(norms(prog["first_grad"]), g_ref), "grad"))
    out.update(_quantiles(leaf_gaps(norms(delta(prog["params"])), norms(delta(ref["params"]))), "change"))
    if ref.get("ema") is not None and prog.get("ema") is not None:
        out.update(_quantiles(leaf_gaps(norms(delta(prog["ema"])), norms(delta(ref["ema"]))), "ema"))
    return out


def judge(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """Every number of ``limits`` at most its limit (a missing or non-finite
    number fails). Returns (correct, {name: {value, limit}})."""
    out, ok = {}, True
    for name, limit in limits.items():
        value = numbers.get(name, float("nan"))
        good = value is not None and math.isfinite(value) and value <= limit
        ok = ok and good
        out[name] = {"value": value, "limit": limit}
    return ok, out
