"""Device time a train step spends outside the stack's kernels K2/K3: every
other device operation of the profiled stretch (the encoder, bottleneck,
upsampler, post-net and loss, their backward, Adam, the EMA, copies),
summed and divided by the stretch's steps."""
from counts.kernels import is_k2, is_k3

UNIT = "ms/step"


def read(run):
    tr, s = run.get("trace"), run.get("stretch")
    if run.get("kind") != "train" or tr is None or not s:
        return None
    if not tr.count(lambda n: True):
        return None
    return 1e3 * tr.device_s(lambda n: not (is_k2(n) or is_k3(n))) / s["steps"]
