"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch
version and a launch counter.

- ``decode``: the fused AR decode (``csrc/decode.cu``), counterpart of the
  JAX package's ``wavenet_decode_pallas``.
- ``glu_stack``: the fused residual-GLU stack for training
  (``csrc/glu_stack.cu``): K2, the forward of all layers, and K3, its exact
  backward, joined by the ``FusedGLUStack`` autograd function; counterparts
  of the JAX package's ``_fwd_pallas`` / ``_bwd_pallas``;
- ``threefry``: JAX's threefry2x32 draws (``csrc/threefry.cu``), which
  ``utils/jax_random`` makes on the card; no TPU kernel's counterpart (the
  JAX package draws through XLA).
- ``upsample``: the conditioning upsampler's stretch-and-smooth chain
  (``csrc/upsample.cu``), forward and backward joined by the ``Upsample``
  autograd function; no TPU kernel's counterpart (the JAX package leaves
  the upsampler to XLA).

``build`` compiles ``csrc/*.cu`` with ``nvcc`` at first use; importing this
package needs no CUDA toolkit.
"""
