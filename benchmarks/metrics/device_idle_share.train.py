"""The share of the profiled stretch of a train window in which no
operation ran on the device: 1 − the union of the device's operations over
the stretch."""
UNIT = "%"


def read(run):
    tr = run.get("trace")
    if run.get("kind") != "train" or tr is None or tr.window_s <= 0 or not tr.device:
        return None
    return 100.0 * (1.0 - tr.busy_s() / tr.window_s)
