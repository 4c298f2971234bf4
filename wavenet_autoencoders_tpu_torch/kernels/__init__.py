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
package needs no CUDA toolkit. Each module counts its launches in module
ints, one per call of a C entry point: ``COUNTERS`` names them all, and
``launches`` / ``add_launches`` read and move them for the train step's
CUDA graph and the tracer's levels.
"""
from __future__ import annotations

import functools
import importlib

#: every kernel launch counter, in module and attribute order, under the
#: name the tracer reports it by
COUNTERS = ("kernels.decode.LAUNCHES", "kernels.glu_stack.LAUNCHES_FWD", "kernels.glu_stack.LAUNCHES_BWD",
            "kernels.glu_stack.LAUNCHES_GATE_WG", "kernels.glu_stack.LAUNCHES_DX_WG", "kernels.threefry.LAUNCHES",
            "kernels.upsample.LAUNCHES_FWD", "kernels.upsample.LAUNCHES_BWD")


@functools.cache
def _counter(name: str):
    # imported at first use, not with the package: decode imports ops, which
    # imports utils/jax_random, which imports this package's threefry
    _, module, attr = name.split(".")
    return importlib.import_module(f"{__name__}.{module}"), attr


def launches() -> dict[str, int]:
    """{counter name: launches so far}, in ``COUNTERS``' order."""
    return {name: getattr(*_counter(name)) for name in COUNTERS}


def add_launches(counts: dict[str, int]) -> None:
    """Adds ``counts`` ({counter name: n}, n < 0 to take away) to the counters."""
    for name, n in counts.items():
        module, attr = _counter(name)
        setattr(module, attr, getattr(module, attr) + n)
