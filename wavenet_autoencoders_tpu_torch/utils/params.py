"""Weights carried across between the JAX package and the port.

The port names its parameters after the JAX params-tree paths
(``wavenet.layers.3.conv.g`` is ``params["wavenet"]["layers"][3]["conv"]["g"]``)
with the same shapes, so the mapping is the identity on '/'-joined paths —
the key format of the JAX package's npz checkpoints
(``params/<path>``, ``train/checkpoint.py``).
"""
from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch
from torch import nn


def flatten_params(model: nn.Module) -> dict[str, torch.Tensor]:
    """{'/'-joined tree path: tensor} for every parameter of ``model``."""
    return {name.replace(".", "/"): p for name, p in model.named_parameters()}


def _flatten_tree(tree, prefix="") -> dict:
    if isinstance(tree, Mapping):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix[:-1]: tree}
    out = {}
    for k, v in items:
        out.update(_flatten_tree(v, f"{prefix}{k}/"))
    return out


def load_flat_params(model: nn.Module, flat: Mapping, prefix: str = "") -> None:
    """Copy ``flat[prefix + path]`` into every parameter of ``model``.
    Raises on a missing key or a shape mismatch; extra keys are ignored."""
    with torch.no_grad():
        for path, p in flatten_params(model).items():
            key = prefix + path
            if key not in flat:
                raise KeyError(f"missing parameter {key}")
            arr = np.asarray(flat[key])
            if tuple(arr.shape) != tuple(p.shape):
                raise ValueError(f"{key}: shape {arr.shape} vs the port's {tuple(p.shape)}")
            p.copy_(torch.tensor(arr, dtype=p.dtype))


def load_jax_params(model: nn.Module, tree) -> None:
    """Fill ``model`` from a JAX params tree given as nested dicts/lists of
    numpy arrays (``jax.tree.map(np.asarray, params)``)."""
    load_flat_params(model, _flatten_tree(tree))
