"""Weight-normalized 1-D convolutions, channels-last at the interface.

Counterpart of ``wavenet_autoencoders_tpu/ops/conv.py``. Parameters keep the
JAX package's names and layouts so weights carry across unchanged:

- ``WNConv1d``: ``g`` (Cout,), ``v`` (K, Cin, Cout), optional ``b`` (Cout,);
  w = g·v/max(‖v‖, 1e-12) with the norm over (K, Cin) per output channel
  (torch ``weight_norm(dim=0)`` on an (out, in, k) weight);
- ``Conv1d``: plain ``w`` (K, Cin, Cout) and optional ``b``;
- ``Linear``: ``w`` (Cin, Cout) and optional ``b``.

Each layer draws its weights from a JAX key (``utils.jax_random``) on the
key's device, as the JAX package's ``*_init`` draws them from that key.

Inputs and outputs are (B, T, C); the transpose to (B, C, T) happens only
around ``F.conv1d``.

``dtype`` is the compute dtype, cast where the JAX package casts (no
autocast): the folded weight and the input are cast to it, the product
accumulates in f32 but its result stays in ``dtype`` (bf16 under bf16), and
the f32 bias added after it promotes the output to f32. Parameters stay f32.

Tensor parallelism (``parallel.mesh``) marks a sharded layer with ``tp``:
``"col"`` (output channels sharded; the caller passes the replicated input
through ``copy_to_model``) or ``"row"`` (input channels sharded: the
partial products, in f32, are summed over the model group and rounded to
``dtype`` once, then the replicated bias is added once). A row-parallel
weight norm takes its norm over the sharded (K, Cin) as the sum of the
ranks' partial sums of squares.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from wavenet_autoencoders_tpu_torch.parallel.distributed import copy_to_model, reduce_from_model
from wavenet_autoencoders_tpu_torch.utils import jax_random as jr


def _kaiming_normal(key, k, cin, cout):
    # torch kaiming_normal_(nonlinearity='relu'), fan_in = cin * k
    std = math.sqrt(2.0) / math.sqrt(cin * k)
    return std * jr.normal(key, (k, cin, cout))


class WNConv1d(nn.Module):
    """Weight-normed conv (JAX ``conv1d_init``). Init: Kaiming-normal(relu)
    weight drawn from ``key``, zero bias, then g = ‖w‖, v = w."""

    def __init__(self, cin: int, cout: int, k: int, bias: bool = True, *, key: torch.Tensor):
        super().__init__()
        w = _kaiming_normal(key, k, cin, cout)
        self.g = nn.Parameter(w.square().sum((0, 1)).sqrt())
        self.v = nn.Parameter(w)
        self.b = nn.Parameter(torch.zeros(cout, device=key.device)) if bias else None


class Conv1d(nn.Module):
    """Un-normalized conv with torch nn.Conv1d default init
    (U(±1/sqrt(fan_in))), drawn as JAX ``plain_conv1d_init`` draws it: the
    weight from the first of two keys split from ``key``, the bias from the
    second."""

    def __init__(self, cin: int, cout: int, k: int, bias: bool = True, *, key: torch.Tensor):
        super().__init__()
        bound = 1.0 / math.sqrt(cin * k)
        kw, kb = jr.split(key)
        self.w = nn.Parameter(jr.uniform(kw, (k, cin, cout), -bound, bound))
        self.b = nn.Parameter(jr.uniform(kb, (cout,), -bound, bound)) if bias else None

    @classmethod
    def of(cls, w: torch.Tensor, b: torch.Tensor | None) -> "Conv1d":
        """A plain conv holding copies of ``w`` (K, Cin, Cout) and ``b``."""
        self = cls.__new__(cls)
        nn.Module.__init__(self)
        self.w = nn.Parameter(w.detach().clone())
        self.b = None if b is None else nn.Parameter(b.detach().clone())
        return self


class Linear(nn.Module):
    """torch nn.Linear default init, weight stored (Cin, Cout), drawn as
    JAX ``linear_init`` draws it."""

    def __init__(self, cin: int, cout: int, bias: bool = True, *, key: torch.Tensor):
        super().__init__()
        bound = 1.0 / math.sqrt(cin)
        kw, kb = jr.split(key)
        self.w = nn.Parameter(jr.uniform(kw, (cin, cout), -bound, bound))
        self.b = nn.Parameter(jr.uniform(kb, (cout,), -bound, bound)) if bias else None


def _is_row(p: nn.Module) -> bool:
    return getattr(p, "tp", None) == "row"


def wn_fold(g: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """w = g·v/max(‖v‖, 1e-12), the norm over (K, Cin) per output channel."""
    norm = v.square().sum((0, 1), keepdim=True).sqrt()
    return g[None, None, :] * v / norm.clamp_min(1e-12)


def conv1d_weight(p: nn.Module, dtype=None) -> torch.Tensor:
    """Fold (g, v) -> w (K, Cin, Cout), cast to ``dtype`` when given. For
    plain convs returns w. A row-parallel fold is this rank's rows of the
    full fold."""
    if isinstance(p, WNConv1d):
        if _is_row(p):
            norm = reduce_from_model(p.v.square().sum((0, 1))).sqrt()
            # g and the norm act on every rank's rows: their gradients sum over the ranks
            g, norm = copy_to_model(torch.stack([p.g, norm]))
            w = g[None, None, :] * p.v / norm.clamp_min(1e-12)[None, None, :]
        else:
            w = wn_fold(p.g, p.v)
    else:
        w = p.w
    return w if dtype is None else w.to(dtype)


def _row_sum(y: torch.Tensor, dtype) -> torch.Tensor:
    """A row-parallel layer's partial products (f32) summed over the model
    group, then rounded to ``dtype`` once, as one process rounds its whole
    product."""
    y = reduce_from_model(y)
    return y if dtype is None else y.to(dtype)


def conv1d_apply(
    p: nn.Module,
    x: torch.Tensor,
    *,
    dilation: int = 1,
    stride: int = 1,
    padding="SAME",
    dtype=None,
) -> torch.Tensor:
    """Conv over (B, T, Cin) -> (B, T', Cout).

    padding: 'SAME' | 'VALID' | 'CAUSAL' | explicit [(lo, hi)]. 'CAUSAL'
    left-pads (k-1)*dilation.
    """
    w = conv1d_weight(p, dtype)
    if dtype is not None:
        x = x.to(dtype)
        if _is_row(p):
            x, w = x.float(), w.float()
    k = w.shape[0]
    if k == 1 and stride == 1:
        y = x @ w[0]
    else:
        if padding == "CAUSAL":
            lo, hi = (k - 1) * dilation, 0
        elif padding == "SAME":
            total = (k - 1) * dilation
            lo, hi = total // 2, total - total // 2
        elif padding == "VALID":
            lo, hi = 0, 0
        else:
            ((lo, hi),) = padding
        xt = F.pad(x.transpose(1, 2), (lo, hi))
        y = F.conv1d(xt, w.permute(2, 1, 0), stride=stride, dilation=dilation)
        y = y.transpose(1, 2)
    if _is_row(p):
        y = _row_sum(y, dtype)
    if p.b is not None:
        y = y + p.b
    return y


def causal_conv1d_apply(p, x, *, dilation=1, dtype=None):
    return conv1d_apply(p, x, dilation=dilation, padding="CAUSAL", dtype=dtype)


def linear_apply(p: Linear, x: torch.Tensor, dtype=None) -> torch.Tensor:
    w = p.w
    if dtype is not None:
        x, w = x.to(dtype), w.to(dtype)
        if _is_row(p):
            x, w = x.float(), w.float()
    y = x @ w
    if _is_row(p):
        y = _row_sum(y, dtype)
    if p.b is not None:
        y = y + p.b
    return y


def receptive_field_size(
    total_layers: int, num_cycles: int, kernel_size: int, dilation=lambda x: 2**x
) -> int:
    assert total_layers % num_cycles == 0
    layers_per_cycle = total_layers // num_cycles
    dilations = [dilation(i % layers_per_cycle) for i in range(total_layers)]
    return (kernel_size - 1) * sum(dilations) + 1
