"""The data axis of the JAX package's device mesh, as processes
(counterpart of ``wavenet_autoencoders_tpu/parallel/mesh.py:27-66``).

In the JAX package the mesh's ``data`` axis is the largest divisor of the
batch that fits the devices (``make_mesh_for_batch``), and batches and
state are placed on it (``shard_batch``, ``shard_state``). Here the data
axis is the process group (``parallel.distributed``): each rank holds a
full replica of the state and loads its own slice of the batch, so what is
left of the rule is the check that the ranks divide the batch.

The ``model`` axis (the tensor-parallel rules of the JAX package's
``mesh.py:69-139``) is not ported: a config asking for it raises.
"""
from __future__ import annotations


def data_axis(batch_size: int, devices: int) -> int:
    """The JAX rule: the largest divisor of ``batch_size`` that fits
    ``devices``."""
    return max(d for d in range(1, min(devices, batch_size) + 1) if batch_size % d == 0)


def check_mesh(cfg, world: int, batches: tuple[str, ...] = ("batch_size",)) -> None:
    """Raise unless ``world`` ranks can train ``cfg`` data-parallel: the
    config asks for no tensor parallelism, and the JAX rule would put every
    rank on the data axis of each batch size named in ``batches``."""
    model = int((getattr(cfg, "mesh_shape", None) or {}).get("model", 1) or 1)
    if model != 1:
        raise NotImplementedError(
            f"mesh_shape model={model}: tensor parallelism is not ported yet; see ROADMAP.md, "
            "queue 1, the last slice (tensor parallelism: the rules of parallel/mesh.py)"
        )
    for name in batches:
        bs = int(getattr(cfg, name))
        if data_axis(bs, world) != world:
            raise ValueError(
                f"{world} processes cannot split {name}={bs}: the data axis would be "
                f"{data_axis(bs, world)} (each rank needs an equal slice)"
            )
