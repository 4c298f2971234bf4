"""Weights carried across between the JAX package and the port.

The port names its parameters after the JAX params-tree paths
(``wavenet.layers.3.conv.g`` is ``params["wavenet"]["layers"][3]["conv"]["g"]``)
with the same shapes, so the mapping is the identity on '/'-joined paths —
the key format of the JAX package's npz checkpoints
(``params/<path>``, ``train/checkpoint.py``).

The optimizer state and the EMA shadow are keyed the same way, under the
paths optax gives the JAX package's ``inject_hyperparams(adam)`` state:
``opt_state/count``, ``opt_state/hyperparams/lr``,
``opt_state/inner_state/0/count`` and
``opt_state/inner_state/0/{mu,nu}/<path>``.
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


def flatten_opt_state(mu: Mapping, nu: Mapping, count: int, lr: float) -> dict[str, np.ndarray]:
    """Adam moments (keyed by tree path), update count and last LR ->
    flat ``opt_state/...`` leaves as the JAX package's checkpoints hold them."""
    flat = {
        "opt_state/count": np.int32(count),
        "opt_state/hyperparams/lr": np.float32(lr),
        "opt_state/inner_state/0/count": np.int32(count),
    }
    for name, tree in (("mu", mu), ("nu", nu)):
        for k, v in tree.items():
            flat[f"opt_state/inner_state/0/{name}/{k}"] = _host(v)
    return flat


def unflatten_opt_state(flat: Mapping, like: Mapping):
    """Inverse of :func:`flatten_opt_state` for the paths of ``like`` (a
    {path: tensor} dict giving shapes, dtypes and the device). Returns
    (mu, nu, count, lr); raises on a missing key or a shape mismatch."""
    out = {}
    for name in ("mu", "nu"):
        out[name] = {k: _tensor(flat, f"opt_state/inner_state/0/{name}/{k}", t) for k, t in like.items()}
    count = int(np.asarray(flat["opt_state/inner_state/0/count"]))
    return out["mu"], out["nu"], count, float(np.asarray(flat["opt_state/hyperparams/lr"]))


def flatten_tensors(tree: Mapping, prefix: str = "") -> dict[str, np.ndarray]:
    """{path: tensor} -> {prefix + path: host array}, e.g. the EMA shadow
    under ``params/``."""
    return {prefix + k: _host(v) for k, v in tree.items()}


def unflatten_tensors(flat: Mapping, like: Mapping, prefix: str = "") -> dict[str, torch.Tensor]:
    """{prefix + path: array} -> {path: tensor} for the paths of ``like``."""
    return {k: _tensor(flat, prefix + k, t) for k, t in like.items()}


def _host(v) -> np.ndarray:
    return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def _tensor(flat: Mapping, key: str, like: torch.Tensor) -> torch.Tensor:
    if key not in flat:
        raise KeyError(f"checkpoint missing {key}")
    arr = np.asarray(flat[key])
    if tuple(arr.shape) != tuple(like.shape):
        raise ValueError(f"{key}: shape {arr.shape} vs the port's {tuple(like.shape)}")
    return torch.tensor(arr, dtype=like.dtype, device=like.device)
