"""The port's kernels by the names the profiler gives their launches
(``csrc/glu_stack.cu``, ``csrc/decode.cu``): K2 is the stack's forward
passes, K3 its backward's, K1 the decode."""
from __future__ import annotations

K2 = ("GateOp", "OutOp")
K3 = ("gate_act_kernel", "RebuildOp", "DactOp", "W1Op", "W2Op", "DxOp", "reduce_kernel<W", "colsum_")
K1 = ("decode_tc_kernel", "decode_f32_kernel")


def matcher(names):
    return lambda n: any(s in n for s in names)


is_k1, is_k2, is_k3 = matcher(K1), matcher(K2), matcher(K3)
