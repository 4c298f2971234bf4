"""Weights carried across between the JAX package and the port.

The port names its parameters after the JAX params-tree paths
(``wavenet.layers.3.conv.g`` is ``params["wavenet"]["layers"][3]["conv"]["g"]``)
with the same shapes, so the mapping is the identity on '/'-joined paths —
the key format of the JAX package's npz checkpoints
(``params/<path>``, ``train/checkpoint.py``).

Model state that is not a parameter (EMA codebooks and their statistics,
code usage) lives in buffers named after the JAX ``model_state`` paths
(``vq.codebooks.0`` is ``model_state["vq"]["codebooks"][0]``), stored as
``model_state/<path>``.

The optimizer state and the EMA shadow are keyed the same way, under the
paths optax gives the JAX package's ``inject_hyperparams(adam)`` state:
``opt_state/count``, ``opt_state/hyperparams/lr``,
``opt_state/inner_state/0/count`` and
``opt_state/inner_state/0/{mu,nu}/<path>``.

Under tensor parallelism each rank holds shards of some leaves
(``parallel.mesh``): ``shard_params`` cuts a rank's shards out of the full
layout and ``gather_params`` (a collective over the model group) puts them
back together, for parameters, Adam moments and the EMA shadow alike.
"""
from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch
from torch import nn

from wavenet_autoencoders_tpu_torch.parallel import distributed as dist
from wavenet_autoencoders_tpu_torch.parallel.mesh import leaf_shard, local_slice, model_axis, tp_shards


def flatten_params(model: nn.Module) -> dict[str, torch.Tensor]:
    """{'/'-joined tree path: tensor} for every parameter of ``model``."""
    return {name.replace(".", "/"): p for name, p in model.named_parameters()}


def flatten_state(model: nn.Module) -> dict[str, torch.Tensor]:
    """{'/'-joined JAX ``model_state`` path: buffer} for every buffer of
    ``model``."""
    return {name.replace(".", "/"): b for name, b in model.named_buffers()}


def load_flat_state(model: nn.Module, flat: Mapping, prefix: str = "model_state/") -> None:
    """Copy ``flat[prefix + path]`` into every buffer of ``model``; raises on
    a missing key or a shape mismatch."""
    with torch.no_grad():
        for path, b in flatten_state(model).items():
            b.copy_(_tensor(flat, prefix + path, b))


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


def load_jax_params(model: nn.Module, tree, state=None) -> None:
    """Fill ``model`` from a JAX params tree given as nested dicts/lists of
    numpy arrays (``jax.tree.map(np.asarray, params)``), and its buffers
    from the JAX ``model_state`` tree when given."""
    load_flat_params(model, _flatten_tree(tree))
    if state is not None:
        load_flat_state(model, _flatten_tree(state), prefix="")


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


def shard_params(flat_full: Mapping, cfg, coords: tuple[int, int]) -> dict:
    """{path: tensor} in the full layout -> the shards of the rank at
    ``coords`` (data index, model index) on ``cfg``'s model axis; the
    replicated leaves are returned as they are. Raises ``ValueError`` on a
    dimension the model axis does not divide."""
    n, m = model_axis(cfg), coords[1]
    shards = tp_shards({k: tuple(v.shape) for k, v in flat_full.items()}, n)
    return {k: local_slice(v, shards[k], n, m) if k in shards else v for k, v in flat_full.items()}


def gather_params(local: Mapping) -> dict:
    """{path: this rank's tensor} -> {path: tensor} in the full JAX layout
    (the gate leaves' halves in their order), gathered over the model group
    in one collective: every rank of the group calls it. The identity
    without a model axis."""
    if dist.model_size() == 1:
        return dict(local)
    keys = [k for k, v in local.items() if leaf_shard(k, v.shape) is not None]
    with torch.no_grad():
        full = dist.gather_shards([local[k].detach() for k in keys], [leaf_shard(k, local[k].shape) for k in keys])
    return {**local, **dict(zip(keys, full))}
