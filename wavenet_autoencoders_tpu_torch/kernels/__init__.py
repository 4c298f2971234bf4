"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch
version and a launch counter.

- ``decode``: the fused AR decode (``csrc/decode.cu``), counterpart of the
  JAX package's ``wavenet_decode_pallas``.

The fused GLU-stack kernels of the JAX package (``kernels/glu_stack.py``)
are training-only and not ported yet (see ROADMAP.md). ``build`` compiles
``csrc/*.cu`` with ``nvcc`` at first use; importing this package needs no
CUDA toolkit.
"""
