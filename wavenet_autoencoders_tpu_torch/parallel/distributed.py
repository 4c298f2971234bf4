"""Multi-process data parallelism with ``torch.distributed`` (counterpart of
``wavenet_autoencoders_tpu/parallel/distributed.py``).

One process per device (a rank). Every rank runs the same training loop on
its contiguous slice of the global batch (``host_local_batch_slice``), and
the train step reduces what the global batch defines: the masked-mean
numerators and denominators, the gradients, the EMA-codebook statistics,
the code counts behind perplexity and usage, and the reseed candidates.
With those reductions, N ranks take the step one process takes on the
whole batch.

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

_synced = False
_control = None  # a gloo group for host-side flags when the main group is NCCL
COLLECTIVES = 0
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


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


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
    """(start, size) of this rank's slice of the global batch; the input
    pipeline loads only these items."""
    n, i = world_size(), rank()
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
    """Sum of ``t`` over the ranks (a new tensor), or ``t`` outside
    ``synced()``."""
    if not _synced:
        return t
    t = t.detach().clone()
    _count()
    dist.all_reduce(t)
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
    """Sum the tensors (of one dtype) over the ranks in place; nothing
    outside ``synced()``."""
    if _synced and tensors:
        _flat(tensors, dist.all_reduce)


def all_gather_rows(t: torch.Tensor) -> torch.Tensor:
    """The ranks' ``t`` (equal shapes) stacked along dim 0 in rank order,
    or ``t`` outside ``synced()``. Each rank writes its rows into zeros and
    the ranks sum them, which is exact and needs only ``all_reduce``
    (gloo gathers no CUDA tensors)."""
    if not _synced:
        return t
    n = t.shape[0]
    out = t.new_zeros((n * world_size(), *t.shape[1:]))
    out[rank() * n : (rank() + 1) * n] = t.detach()
    _count()
    dist.all_reduce(out)
    return out


def global_rows() -> tuple[int, int]:
    """(ranks, this rank's index) inside ``synced()``, else (1, 0): a rank
    whose local batch has B rows owns rows [index*B, (index+1)*B) of the
    global batch, so noise drawn for B*ranks rows and sliced there is the
    global batch's draw."""
    return (world_size(), rank()) if _synced else (1, 0)


def broadcast_from_main(tensors: list[torch.Tensor]) -> None:
    """Overwrite every rank's tensors (of one dtype) with rank 0's, in place
    (the initial or resumed training state, so that all replicas start
    equal); nothing without a process group."""
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
