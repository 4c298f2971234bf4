"""Multi-process data and tensor parallelism with ``torch.distributed``
(counterpart of ``wavenet_autoencoders_tpu/parallel/distributed.py`` and of
the collectives XLA inserts for ``parallel/mesh.py``).

One process per device (a rank). ``init_mesh(model)`` splits the ranks into
the mesh's groups (``parallel.mesh``): rank r is (data index, model index)
= divmod(r, model); a data group holds the ranks of one model index, a
model group the ranks of one data index. With model 1 (the default) the
data group is the whole process group.

Data axis: every data rank runs the same training loop on its contiguous
slice of the global batch (``host_local_batch_slice``), and the train step
reduces over the data group what the global batch defines: the masked-mean
numerators and denominators, the gradients, the EMA-codebook statistics,
the code counts behind perplexity and usage, and the reseed candidates.
With those reductions, N data ranks take the step one process takes on the
whole batch.

Model axis: Megatron's pair of autograd functions. ``copy_to_model`` is the
identity forward and sums the gradient over the model group backward (the
replicated input of a column-parallel layer); ``reduce_from_model`` sums
forward and is the identity backward (the partial products of a
row-parallel layer). Every model rank back-propagates the same replicated
loss, so a reduce whose backward summed again (as
``torch.distributed.nn.functional.all_reduce`` does) would make every
sharded gradient ``model`` times too large. ``gather_from_model`` gathers
channel shards (backward: this rank's slice), ``gather_shards`` whole
parameter shards into the JAX layout (backward: this rank's slice, no
collective, for a computation every model rank repeats in full). The
model-group collectives run whenever the model axis is > 1, in or out of
``synced()``: a sharded model computes nothing alone. ``MODEL_COLLECTIVES``
and ``MODEL_BYTES`` count them.

Collectives run only inside ``synced()`` under a process group (of any
size, one rank included): the train step and the dev pass enter it on
every rank, while rank 0's qualitative hooks (sample dump, decode) run the
same model code outside it, alone, with no collective to wait on.
``COLLECTIVES`` counts the collectives issued, ``BACKEND`` names the last
process group's backend.

The process group is NCCL on CUDA and gloo on the CPU; ``backend=``
overrides it (gloo on CUDA tensors runs two ranks on one card, which NCCL
refuses). Without arguments, ``initialize_distributed`` reads torch's
standard ``MASTER_ADDR``/``MASTER_PORT``/``WORLD_SIZE``/``RANK``.
"""
from __future__ import annotations

import contextlib
import os

import torch
import torch.distributed as dist

from wavenet_autoencoders_tpu_torch.parallel.mesh import Shard, local_slice, place_local

_synced = False
_control = None  # a gloo group for host-side flags when the main group is NCCL
_model = 1  # the mesh's model axis; 1 without init_mesh
_data_group = None  # None: the whole process group
_model_group = None
COLLECTIVES = 0
MODEL_COLLECTIVES = 0
MODEL_BYTES = 0
BACKEND: str | None = None  # of the last process group joined


def initialize_distributed(
    coordinator: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    *,
    device: str | torch.device = "cuda",
    backend: str | None = None,
) -> bool:
    """Join the process group from the arguments or the env vars. A no-op
    (returns False) for one process without a coordinator.

    ``coordinator`` is ``host:port`` (rendezvous over TCP, rank 0 listens)
    or an ``init_method`` URL (``tcp://...``, ``file://...``)."""
    if coordinator is None and os.environ.get("MASTER_ADDR"):
        coordinator = f"{os.environ['MASTER_ADDR']}:{os.environ.get('MASTER_PORT', '29500')}"
    if num_processes is None:
        num_processes = int(os.environ.get("WORLD_SIZE", "1"))
    if process_id is None:
        process_id = int(os.environ.get("RANK", "0"))
    if num_processes <= 1 and coordinator is None:
        return False
    if coordinator is None:
        raise ValueError(f"{num_processes} processes need a coordinator (host:port or MASTER_ADDR)")
    if dist.is_initialized():
        raise RuntimeError("the process group is already initialized")
    init = coordinator if "://" in coordinator else f"tcp://{coordinator}"
    dev = torch.device(device)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if dev.type == "cuda":
        torch.cuda.set_device(local_device(dev, process_id))
    dist.init_process_group(backend, init_method=init, world_size=num_processes, rank=process_id)
    global _control, BACKEND
    BACKEND = backend
    _control = dist.new_group(backend="gloo") if backend == "nccl" else None
    return True


def shutdown() -> None:
    """Leave the process group (each phase of a long-lived process that
    joined one leaves it before the next joins)."""
    global _control
    if dist.is_initialized():
        dist.destroy_process_group()
    _control = None
    _set_mesh(1, None, None)


def _set_mesh(model, data_group, model_group) -> None:
    global _model, _data_group, _model_group
    _model, _data_group, _model_group = model, data_group, model_group


def init_mesh(model: int = 1) -> tuple[int, int]:
    """Split the ranks into the mesh's data and model groups (every rank
    calls this at the same point: each creates every group, in one order).
    Returns (data, model); raises ``ValueError`` when ``model`` does not
    divide the ranks."""
    world, r = world_size(), rank()
    if model < 1 or world % model:
        raise ValueError(f"mesh_shape model={model} does not divide {world} processes")
    _set_mesh(1, None, None)
    if model > 1:
        data = world // model
        mine = {}
        for d in range(data):
            group = dist.new_group([d * model + m for m in range(model)])
            if d == r // model:
                mine["model"] = group
        for m in range(model):
            group = dist.new_group([d * model + m for d in range(data)])
            if m == r % model:
                mine["data"] = group
        _set_mesh(model, mine["data"], mine["model"])
    return world // model, model


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def model_size() -> int:
    return _model


def model_index() -> int:
    return rank() % _model


def data_size() -> int:
    return world_size() // _model


def data_index() -> int:
    return rank() // _model


def is_main_process() -> bool:
    """True on the rank that writes the config, logs and checkpoints and
    runs the qualitative hooks."""
    return rank() == 0


def local_device(device: str | torch.device = "cuda", rank_: int | None = None) -> torch.device:
    """This rank's device: ``cuda:(rank % device_count)`` for ``cuda``
    without an index, the device itself otherwise."""
    dev = torch.device(device)
    if dev.type != "cuda" or dev.index is not None:
        return dev
    r = rank() if rank_ is None else rank_
    return torch.device("cuda", r % torch.cuda.device_count())


def host_local_batch_slice(global_batch: int) -> tuple[int, int]:
    """(start, size) of this rank's slice of the global batch (the slice of
    its data index; the ranks of one model group load the same rows); the
    input pipeline loads only these items."""
    n, i = data_size(), data_index()
    assert global_batch % n == 0, f"global batch {global_batch} % processes {n} != 0"
    per = global_batch // n
    return i * per, per


def _count() -> None:
    global COLLECTIVES
    COLLECTIVES += 1


@contextlib.contextmanager
def synced():
    """Inside the block, ``all_sum`` and friends reduce over the process
    group (every rank must enter it in step); outside it, or without a
    process group, they are the identity."""
    global _synced
    prev, _synced = _synced, dist.is_initialized()
    try:
        yield
    finally:
        _synced = prev


def is_synced() -> bool:
    return _synced


def all_sum(t: torch.Tensor) -> torch.Tensor:
    """Sum of ``t`` over the data group (a new tensor), or ``t`` outside
    ``synced()``."""
    if not _synced:
        return t
    t = t.detach().clone()
    _count()
    dist.all_reduce(t, group=_data_group)
    return t


def _flat(tensors: list[torch.Tensor], collective) -> None:
    """Run ``collective`` on the tensors (of one dtype) as one flat buffer
    and copy the result back in place."""
    with torch.no_grad():
        flat = torch.cat([t.reshape(-1) for t in tensors])
        _count()
        collective(flat)
        off = 0
        for t in tensors:
            t.copy_(flat[off : off + t.numel()].view_as(t))
            off += t.numel()


def all_sum_(tensors: list[torch.Tensor]) -> None:
    """Sum the tensors (of one dtype) over the data group in place; nothing
    outside ``synced()``."""
    if _synced and tensors:
        _flat(tensors, lambda flat: dist.all_reduce(flat, group=_data_group))


def all_gather_rows(t: torch.Tensor) -> torch.Tensor:
    """The data ranks' ``t`` (equal shapes) stacked along dim 0 in data
    order, or ``t`` outside ``synced()``. Each rank writes its rows into
    zeros and the ranks sum them, which is exact and needs only
    ``all_reduce`` (gloo gathers no CUDA tensors)."""
    if not _synced:
        return t
    n, i = t.shape[0], data_index()
    out = t.new_zeros((n * data_size(), *t.shape[1:]))
    out[i * n : (i + 1) * n] = t.detach()
    _count()
    dist.all_reduce(out, group=_data_group)
    return out


def global_rows() -> tuple[int, int]:
    """(data ranks, this rank's data index) inside ``synced()``, else
    (1, 0): a rank whose local batch has B rows owns rows [index*B,
    (index+1)*B) of the global batch, so noise drawn for B*ranks rows and
    sliced there is the global batch's draw."""
    return (data_size(), data_index()) if _synced else (1, 0)


def global_batch_rows(B: int) -> tuple[int, tuple[int, int]]:
    """(the global batch's rows, this rank's rows (r0, r1)) for a local batch
    of B rows: JAX draws its noise over the global batch, and a rank draws
    the rows of its slice (``utils.jax_random``'s ``rows``)."""
    ranks, r = global_rows()
    return B * ranks, (r * B, (r + 1) * B)


def broadcast_from_main(tensors: list[torch.Tensor]) -> None:
    """Overwrite every rank's tensors (of one dtype) with rank 0's, in place
    (the initial or resumed training state in the full layout, so that all
    replicas start equal before they are sharded); nothing without a
    process group."""
    if dist.is_initialized() and tensors:
        _flat(tensors, lambda flat: dist.broadcast(flat, src=0))


def any_rank(flag: bool) -> bool:
    """True on every rank when ``flag`` is true on any rank: a collective
    (all ranks call it at the same point) on host tensors, so it does not
    wait for the device."""
    if not dist.is_initialized():
        return flag
    t = torch.tensor([1.0 if flag else 0.0])
    _count()
    dist.all_reduce(t, group=_control)
    return bool(t.item() > 0)


# ---- the model axis ----


def _model_sum(t: torch.Tensor) -> torch.Tensor:
    """A new tensor: ``t`` summed over the model group (16-bit tensors are
    summed in f32 and rounded once)."""
    global MODEL_COLLECTIVES, MODEL_BYTES
    out = t.float() if t.dtype in (torch.bfloat16, torch.float16) else t.clone()
    _count()
    MODEL_COLLECTIVES += 1
    MODEL_BYTES += out.numel() * out.element_size()
    dist.all_reduce(out, group=_model_group)
    return out.to(t.dtype)


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _model_sum(g.contiguous())


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return _model_sum(x.contiguous())

    @staticmethod
    def backward(ctx, g):
        return g


class _GatherShards(torch.autograd.Function):
    @staticmethod
    def forward(ctx, shards, *local):
        ctx.shards = shards
        dtypes = {t.dtype for t in local}
        if len(dtypes) != 1:
            raise ValueError(f"gather_shards takes tensors of one dtype, not {sorted(map(str, dtypes))}")
        n, m = _model, model_index()
        shapes = [t.shape[:sh.axis] + (t.shape[sh.axis] * n,) + t.shape[sh.axis + 1:] for t, sh in zip(local, shards)]
        sizes = [s.numel() for s in shapes]
        flat = local[0].new_zeros(sum(sizes))
        for buf, t, sh, shape in zip(flat.split(sizes), local, shards, shapes):
            place_local(buf.view(shape), t.detach(), sh, n, m)
        # every rank writes its shards into zeros, so the sum is the gather (gloo gathers no CUDA tensors)
        return tuple(buf.view(shape).clone() for buf, shape in zip(_model_sum(flat).split(sizes), shapes))

    @staticmethod
    def backward(ctx, *grads):
        n, m = _model, model_index()
        return (None, *(None if g is None else local_slice(g, sh, n, m) for g, sh in zip(grads, ctx.shards)))


def copy_to_model(x: torch.Tensor) -> torch.Tensor:
    """The replicated input of a column-parallel layer: the identity, whose
    gradient is summed over the model group."""
    return _CopyToModel.apply(x) if _model > 1 else x


def reduce_from_model(x: torch.Tensor) -> torch.Tensor:
    """The sum of a row-parallel layer's partial products over the model
    group; the gradient passes through."""
    return _ReduceFromModel.apply(x) if _model > 1 else x


def gather_from_model(x: torch.Tensor) -> torch.Tensor:
    """The model ranks' channel shards (last axis) side by side; the
    gradient of this rank's slice comes back."""
    if _model == 1:
        return x
    return _GatherShards.apply((Shard(x.ndim - 1),), x)[0]


def gather_shards(local: list[torch.Tensor], shards: list[Shard]) -> list[torch.Tensor]:
    """Each model rank's shards (one dtype) gathered into the full layout in
    one collective. Backward keeps this rank's slice of each gradient, with
    no collective: for a computation that every model rank repeats in full
    on replicated inputs, whose gradient is the same on every rank."""
    if _model == 1 or not local:
        return list(local)
    return list(_GatherShards.apply(tuple(shards), *local))


def model_sum(t: torch.Tensor) -> torch.Tensor:
    """``t`` summed over the model group (a new tensor; no autograd)."""
    return _model_sum(t.detach()) if _model > 1 else t
