"""The JAX package's ('data', 'model') device mesh, as processes
(counterpart of ``wavenet_autoencoders_tpu/parallel/mesh.py``).

One rank is one device. The ``model`` axis comes from
``cfg.mesh_shape["model"]``; the ``data`` axis is the largest divisor of
the batch that fits the ranks left (``make_mesh_for_batch``). Rank r sits
at (data index, model index) = ``divmod(r, model)``, the order of the JAX
package's ``np.asarray(devices).reshape(data, model)``. The process groups
of both axes live in ``parallel.distributed``.

The ``model`` axis is Megatron tensor parallelism, by the 13 rules of the
JAX package (``_TP_RULES``), matched with ``re.search`` on the port's
'/'-joined parameter names (the JAX tree paths): the gate conv, ``cproj``,
``gproj`` and ``post1`` are column-parallel (output channels sharded), the
``out``/``skip`` 1x1s and ``post2`` row-parallel (input channels sharded),
the encoder's conv chain column-parallel and its ``lin`` row-parallel. The
Adam moments and the EMA shadow are sharded like their parameters.

Two differences from the JAX package's layout, both forced by running the
layers rank by rank instead of through XLA's partitioner:

- the gate leaves (``conv``, ``cproj``, ``gproj``) are sharded per half:
  their output channels are [tanh half | sigmoid half], and rank m holds
  columns [m·G/2n, (m+1)·G/2n) of each half (a contiguous shard would give
  rank 0 every tanh column); the matching rows of ``out.v`` and ``skip.v``
  are then a contiguous shard;
- a sharded dimension the model axis does not divide raises ``ValueError``
  (the JAX partitioner pads uneven shards).
"""
from __future__ import annotations

import re
from typing import NamedTuple


def data_axis(batch_size: int, devices: int) -> int:
    """The JAX rule: the largest divisor of ``batch_size`` that fits
    ``devices``."""
    return max(d for d in range(1, min(devices, batch_size) + 1) if batch_size % d == 0)


def model_axis(cfg) -> int:
    return int((getattr(cfg, "mesh_shape", None) or {}).get("model", 1) or 1)


def mesh_axes(cfg, world: int, batch_size: int | None = None) -> tuple[int, int]:
    """(data, model) of ``world`` ranks for ``cfg``: model from
    ``mesh_shape``, data the largest divisor of the batch that fits
    ``world // model`` (``make_mesh_for_batch``). Raises ``ValueError``
    unless data x model == world."""
    model = model_axis(cfg)
    if model < 1 or world % model:
        raise ValueError(f"mesh_shape model={model} does not divide {world} processes")
    bs = int(cfg.batch_size if batch_size is None else batch_size)
    data = data_axis(bs, world // model)
    if data * model != world:
        raise ValueError(
            f"{world} processes cannot split batch_size={bs} with model={model}: the data axis would be "
            f"{data} of {world // model} (each data rank needs an equal slice)"
        )
    return data, model


def coords(rank: int, model: int) -> tuple[int, int]:
    """(data index, model index) of ``rank``."""
    return divmod(rank, model)


# (rule, sharded axis, halves, spec length): the JAX package's _TP_RULES,
# the axis its PartitionSpec names "model", for the gate leaves the
# per-half layout, and the number of dimensions the spec needs
_TP_RULES = [
    (re.compile(r"layers/\d+/conv/v$"), 2, 2, 3),
    (re.compile(r"layers/\d+/conv/g$"), 0, 2, 1),
    (re.compile(r"layers/\d+/conv/b$"), 0, 2, 1),
    (re.compile(r"layers/\d+/[cg]proj/v$"), 2, 2, 3),
    (re.compile(r"layers/\d+/[cg]proj/g$"), 0, 2, 1),
    (re.compile(r"layers/\d+/(out|skip)/v$"), 1, 1, 3),
    (re.compile(r"wavenet/post1/v$"), 2, 1, 3),
    (re.compile(r"wavenet/post1/g$"), 0, 1, 1),
    (re.compile(r"wavenet/post1/b$"), 0, 1, 1),
    (re.compile(r"wavenet/post2/v$"), 1, 1, 3),
    (re.compile(r"encoder/blocks/\d+/w$"), 2, 1, 3),
    (re.compile(r"encoder/blocks/\d+/b$"), 0, 1, 1),
    (re.compile(r"encoder/lin/w$"), 0, 1, 2),
]


class Shard(NamedTuple):
    """A leaf's sharded ``axis``; ``halves`` 2 for the per-half gate layout."""

    axis: int
    halves: int = 1


def leaf_shard(path: str, shape) -> Shard | None:
    """The sharded axis of the leaf at ``path`` ('/'- or '.'-joined) under a
    model axis > 1, or None when it is replicated: the first rule that
    matches and, as in the JAX package, whose PartitionSpec has no more
    dimensions than the leaf."""
    path = path.replace(".", "/")
    for rx, axis, halves, ndim in _TP_RULES:
        if rx.search(path) and ndim <= len(shape):
            return Shard(axis, halves)
    return None


def tp_shards(shapes: dict, model: int) -> dict:
    """{path: Shard} of the sharded leaves among ``shapes`` ({path: shape} of
    the full layout); empty when ``model`` is 1. Raises ``ValueError`` when
    a sharded dimension (each half of a gate leaf) does not divide by
    ``model``."""
    if model == 1:
        return {}
    out = {}
    for path, shape in shapes.items():
        sh = leaf_shard(path, shape)
        if sh is None:
            continue
        size = shape[sh.axis] // sh.halves
        if size * sh.halves != shape[sh.axis] or size % model:
            what = "each half of " if sh.halves == 2 else ""
            raise ValueError(f"{path}: {what}dimension {sh.axis} ({size}) does not divide by mesh_shape "
                             f"model={model}; the port refuses uneven shards")
        out[path] = sh
    return out


def _blocks(t, sh: Shard, n: int):
    """View ``t`` with its sharded axis split as (halves, n, size)."""
    a = sh.axis
    return t.reshape(*t.shape[:a], sh.halves, n, t.shape[a] // (sh.halves * n), *t.shape[a + 1:])


def local_slice(full, sh: Shard, n: int, m: int):
    """Rank ``m``'s shard (of ``n``) of the full-layout tensor ``full``: the
    m-th of n blocks of each half along the sharded axis (a copy)."""
    a = sh.axis
    blk = _blocks(full, sh, n).select(a + 1, m)
    return blk.reshape(*full.shape[:a], -1, *full.shape[a + 1:]).clone()


def place_local(buf, local, sh: Shard, n: int, m: int) -> None:
    """Write rank ``m``'s shard ``local`` into the full-layout ``buf`` in
    place (the inverse of ``local_slice``)."""
    a = sh.axis
    loc = local.reshape(*local.shape[:a], sh.halves, local.shape[a] // sh.halves, *local.shape[a + 1:])
    _blocks(buf, sh, n).select(a + 1, m).copy_(loc)


def check_mesh(cfg, world: int, batches: tuple[str, ...] = ("batch_size",), shapes: dict | None = None) -> None:
    """Raise ``ValueError`` unless ``world`` ranks can train ``cfg``: the
    model axis divides the ranks, the JAX rule puts the rest on the data
    axis of each batch size named in ``batches``, and (given the model's
    {path: shape}) every sharded dimension divides by the model axis."""
    for name in batches:
        mesh_axes(cfg, world, int(getattr(cfg, name)))
    if shapes is not None:
        tp_shards(shapes, model_axis(cfg))


def shard_module(module, n: int, m: int) -> dict:
    """Replace every sharded parameter of ``module`` (in the full layout) by
    rank ``m``'s shard of ``n``, in place, and mark the layers that own
    them: ``tp`` "col" (output channels sharded) or "row" (input channels
    sharded), ``tp_shards`` {leaf: Shard}. Returns {path: Shard}."""
    shards = tp_shards({k.replace(".", "/"): tuple(p.shape) for k, p in module.named_parameters()}, n)
    for path, sh in shards.items():
        owner_path, leaf = path.rsplit("/", 1)
        owner = module.get_submodule(owner_path.replace("/", "."))
        p = getattr(owner, leaf)
        p.data = local_slice(p.data, sh, n, m)
        owner.tp_shards = {**getattr(owner, "tp_shards", {}), leaf: sh}
        if leaf in ("v", "w"):
            owner.tp = "col" if sh.axis == p.ndim - 1 else "row"
    return shards
