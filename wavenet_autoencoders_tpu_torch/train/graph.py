"""The train step as one device program: a CUDA graph of the step's body,
captured once and replayed once a step. No counterpart in the JAX package,
whose step is one ``jax.jit``-compiled function with donated state
(``wavenet_autoencoders_tpu/train/step.py:make_train_step``); this is how
the port gets the same.

``GraphedStep(device)(body, state, batch)`` runs ``body(state, batch)``
(``train.step.TrainStep.body``, which reads device tensors alone):

1. the first call runs it eagerly on the caller's stream: a real step,
   which builds the kernels, sets their shared-memory attributes and warms
   cuBLAS and autograd. Not on a side stream: warmed there, the replays
   on an H100 ran ~1.2 ms a step slower, at the same clock, until a switch
   at a random later step, from tens of steps to beyond 45 s of them;
2. the second call captures it with ``torch.cuda.graph`` over static batch
   buffers (the gradients set to None first, so that autograd allocates
   them in the graph's pool; Python's collector held off, which could
   otherwise free an earlier graph during the capture and so invalidate
   it) and replays it;
3. every later call copies its batch into the static buffers and replays.

A replay writes into the tensors the capture saw: the state's parameters,
Adam moments, EMA shadow and model buffers (checked before every replay:
:class:`StatePointers` raises if one was rebound, as ``load_checkpoint``
rebinds the moments and the shadow), and its outputs, so the metrics it
returns are copies. The kernels' launch counters (``kernels.COUNTERS``)
count in Python, so they see the capture and not the replays: the
capture's change of each counter is undone and added once a replay.

The tracer (``utils.spans``) sees the eager first step (``step.warm``),
the capture (``step.capture``, ``step.captures``), each replay's launch
(``step.launch``, ``step.replays``), and the captured graph's node count
(the level ``graph.nodes``, read once a capture).
"""
from __future__ import annotations

import collections
import ctypes
import gc
import time

import torch

from wavenet_autoencoders_tpu_torch import kernels
from wavenet_autoencoders_tpu_torch.utils import spans
from wavenet_autoencoders_tpu_torch.utils.params import flatten_state


def node_count(graph) -> int:
    """The node count of a graph captured with ``keep_graph=True``: the
    CUDA driver API's ``cuGraphGetNodes`` on its ``cudaGraph_t`` (a
    ``CUgraph``)."""
    cuda = ctypes.CDLL("libcuda.so.1")
    cuda.cuGraphGetNodes.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.POINTER(ctypes.c_size_t)]
    cuda.cuGraphGetNodes.restype = ctypes.c_int
    n = ctypes.c_size_t(0)
    rc = cuda.cuGraphGetNodes(graph.raw_cuda_graph(), None, ctypes.byref(n))
    if rc != 0:
        raise RuntimeError(f"cuGraphGetNodes failed with CUresult {rc}")
    return n.value


def state_tensors(state) -> dict[str, torch.Tensor]:
    """Every tensor of a TrainState that the step updates in place, by its
    checkpoint path: parameters, model buffers, Adam moments, EMA shadow."""
    out = {f"params/{k}": p for k, p in state.params().items()}
    out.update({f"model_state/{k}": b for k, b in flatten_state(state.model).items()})
    for name, tree in (("mu", state.mu), ("nu", state.nu), ("ema", state.ema or {})):
        out.update({f"{name}/{k}": t for k, t in tree.items()})
    return out


class StatePointers:
    """The device addresses of a TrainState's tensors when a graph was
    captured over it; ``check`` raises if any tensor has been rebound since,
    as a replay over stale addresses would train tensors the state no longer
    holds while it reports losses."""

    def __init__(self, state):
        self.ptrs = self._read(state)

    @staticmethod
    def _read(state) -> dict[str, int]:
        return {k: t.data_ptr() for k, t in state_tensors(state).items()}

    def check(self, state) -> None:
        now = self._read(state)
        moved = sorted(k for k in self.ptrs.keys() | now.keys() if self.ptrs.get(k) != now.get(k))
        if moved:
            trees = collections.Counter(k.split("/", 1)[0] for k in moved)
            raise RuntimeError(f"{len(moved)} tensors of the train state were rebound after the step's graph was "
                               f"captured ({', '.join(f'{t}: {n}' for t, n in sorted(trees.items()))}; first "
                               f"{moved[0]}): restore a state in place, or before the first step")


class GraphedStep:
    """``metrics = graphed(body, state, batch)``: ``body(state, batch)`` as a
    CUDA graph on ``device`` (see the module's docstring), captured from the
    body of the second call. Batches must keep the first one's keys, shapes
    and dtypes. ``capture_s`` is the capture's host time, ``launches`` the
    launches a replay makes, {counter name: n} over ``kernels.COUNTERS``
    (0 for a kernel the step never launches). It keeps no
    reference to ``body``, whose owner holds it: no cycle keeps a dead
    graph's memory."""

    def __init__(self, device):
        self.device = device
        self.static: dict | None = None
        self.out: dict | None = None
        self.graph = None
        self.pointers: StatePointers | None = None
        self.launches: dict[str, int] | None = None
        self.capture_s: float | None = None

    def __call__(self, body, state, batch: dict) -> dict:
        if self.static is None:
            self.static = {k: v.clone() for k, v in batch.items()}
            with spans.span("step.warm"):
                return self._warm(body, state)
        self._load(batch)
        if self.graph is None:
            with spans.span("step.capture"):
                self._capture(body, state)
            spans.count("step.captures")
        else:
            self.pointers.check(state)
        self._replay()
        spans.count("step.replays")
        return {k: v.clone() for k, v in self.out.items()}

    def _load(self, batch: dict) -> None:
        if batch.keys() != self.static.keys() or any(
                v.shape != self.static[k].shape or v.dtype != self.static[k].dtype for k, v in batch.items()):
            raise ValueError("a graphed train step takes batches of its first batch's keys, shapes and dtypes: "
                             f"{ {k: (tuple(v.shape), v.dtype) for k, v in self.static.items()} }, got "
                             f"{ {k: (tuple(v.shape), v.dtype) for k, v in batch.items()} }")
        for k, v in batch.items():
            self.static[k].copy_(v)

    def _warm(self, body, state) -> dict:
        return body(state, self.static)

    def _capture(self, body, state) -> None:
        for p in state.params().values():
            p.grad = None  # autograd allocates the gradients in the graph's pool
        before = kernels.launches()
        t0 = time.perf_counter()
        graph = torch.cuda.CUDAGraph(keep_graph=True)  # kept for its node count
        # a collection inside the capture could destroy an earlier graph
        # held by dead objects, which invalidates the capture
        gc.collect()
        collecting = gc.isenabled()
        gc.disable()
        try:
            # thread_local: the loop's prefetch thread pins and copies the
            # next batch meanwhile (on another stream), which "global" refuses
            with torch.cuda.device(self.device), torch.cuda.graph(graph, capture_error_mode="thread_local"):
                self.out = body(state, self.static)
        finally:
            if collecting:
                gc.enable()
        graph.instantiate()  # here, not in the first replay
        self.graph, self.capture_s = graph, time.perf_counter() - t0
        spans.level("graph.nodes", node_count(graph))
        self.launches = {name: n - before[name] for name, n in kernels.launches().items()}
        kernels.add_launches({name: -n for name, n in self.launches.items()})  # the capture launched nothing
        self.pointers = StatePointers(state)

    def _replay(self) -> None:
        with torch.cuda.device(self.device), spans.span("step.launch"):
            self.graph.replay()
        kernels.add_launches(self.launches)
