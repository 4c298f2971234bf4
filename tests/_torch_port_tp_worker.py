"""One rank of the port's tensor-parallel CPU tests (test_torch_port_tensor_parallel.py).

    python _torch_port_tp_worker.py <init_method> <world> <rank> <inputs.npz> <out.npz>

``inputs.npz`` holds the run: ``spec`` (a JSON string: the preset, its
override string ``hparams`` and the overrides ``over``, ``mesh_shape``
included, and the ``mode``), the full-layout initial weights under
``params/<path>`` and each step's global batch under ``batch/<step>/<key>``.
The rank joins the gloo group, builds the mesh's groups, loads the
weights and cuts its shards out of them. Mode ``steps`` takes one train
step per batch on its data slice and writes each step's metrics, the
parameters, Adam moments and model state gathered back into the full
layout, and its counters (collectives of the model group, calls of K2's
plain version); mode ``grad64`` runs the first batch's training forward
and backward in float64 (loss: the logits against fixed weights, plus the
aux loss) and writes the gathered gradients. ``run`` and ``grads64`` do
the same in one process (no group), the reference. It imports only the
port.
"""
import json
import sys

import numpy as np


def load_inputs(path):
    z = np.load(path)
    spec = json.loads(str(z["spec"]))
    steps = sorted({int(k.split("/")[1]) for k in z.files if k.startswith("batch/")})
    batches = [{k.split("/")[2]: z[k] for k in z.files if k.startswith(f"batch/{i}/")} for i in steps]
    params = {k[len("params/"):]: z[k] for k in z.files if k.startswith("params/")}
    return spec, params, batches


def make_cfg(spec, **over):
    from wavenet_autoencoders_tpu_torch.config import load_preset

    return load_preset(spec["preset"], spec.get("hparams", "")).replace(**{**spec.get("over", {}), **over})


def run(inputs, rows=None, *, one_process=False, **over):
    """The steps of ``inputs`` on ``rows`` of each batch (all rows when None);
    under a process group on this rank's mesh coordinates. ``one_process``
    trains without the mesh (the config's ``mesh_shape`` set to model 1);
    ``over`` overrides more of the config (``seed``: another step key).
    Returns {name: array}."""
    import torch

    from wavenet_autoencoders_tpu_torch.kernels import glu_stack
    from wavenet_autoencoders_tpu_torch.models import build_model
    from wavenet_autoencoders_tpu_torch.parallel import distributed as dist
    from wavenet_autoencoders_tpu_torch.train.step import init_state, make_train_step, shard_state
    from wavenet_autoencoders_tpu_torch.utils.params import flatten_state, gather_params, load_flat_params

    spec, params, batches = load_inputs(inputs)
    cfg = make_cfg(spec, **over, **({"mesh_shape": {"data": -1, "model": 1}} if one_process else {}))
    model = build_model(cfg, device="cpu").train()
    load_flat_params(model, params)
    state = shard_state(cfg, init_state(cfg, model))
    step = make_train_step(cfg, model)
    out = {}
    calls = []
    orig = glu_stack.glu_stack_forward_reference

    def counted(*a, **kw):
        calls.append(1)
        return orig(*a, **kw)

    glu_stack.glu_stack_forward_reference = counted
    before = (dist.MODEL_COLLECTIVES, dist.MODEL_BYTES)
    try:
        for i, b in enumerate(batches):
            batch = {k: torch.from_numpy(v if rows is None else v[rows]) for k, v in b.items()}
            state, m = step(state, batch)
            for k, v in m.items():
                out[f"metrics/{i}/{k}"] = np.float64(v)
    finally:
        glu_stack.glu_stack_forward_reference = orig
    out["counters/model_collectives"] = np.int64(dist.MODEL_COLLECTIVES - before[0])
    out["counters/model_bytes"] = np.int64(dist.MODEL_BYTES - before[1])
    out["counters/k2_calls"] = np.int64(len(calls))
    for name, tree in (("params", state.params()), ("mu", state.mu), ("nu", state.nu)):
        for k, v in gather_params(tree).items():
            out[f"{name}/{k}"] = v.detach().numpy().copy()
    for k, v in flatten_state(model).items():
        out[f"model_state/{k}"] = v.numpy().copy()
    return out


def grads64(inputs, rows=None, *, one_process=False):
    """The first batch's forward and backward in float64 on ``rows``:
    {path: gradient} in the full layout and the loss."""
    import torch

    from wavenet_autoencoders_tpu_torch.models import build_model
    from wavenet_autoencoders_tpu_torch.train.step import init_state, shard_state
    from wavenet_autoencoders_tpu_torch.utils.params import flatten_params, gather_params, load_flat_params

    spec, params, batches = load_inputs(inputs)
    cfg = make_cfg(spec, **({"mesh_shape": {"data": -1, "model": 1}} if one_process else {}))
    model = build_model(cfg, device="cpu").train()
    load_flat_params(model, params)
    shard_state(cfg, init_state(cfg, model.double()))
    b = {k: torch.from_numpy(v if rows is None else v[rows]) for k, v in batches[0].items()}
    y, aux, _ = model(b["x"].long(), b["c"].double(), b["g"], train=True)
    weights = torch.from_numpy(np.random.default_rng(5).standard_normal(tuple(y.shape)))
    loss = (y * weights).sum() + aux
    loss.backward()
    grads = gather_params({k: torch.zeros_like(p) if p.grad is None else p.grad
                           for k, p in flatten_params(model).items()})
    return {"loss": np.float64(loss.detach()), **{f"grad/{k}": v.numpy() for k, v in grads.items()}}


def main():
    init, world, rank, inputs, out_path = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5]
    import torch

    torch.set_num_threads(1)
    from wavenet_autoencoders_tpu_torch.parallel import distributed as dist
    from wavenet_autoencoders_tpu_torch.parallel.mesh import mesh_axes

    dist.initialize_distributed(init, world, rank, device="cpu")
    try:
        spec, _, batches = load_inputs(inputs)
        cfg = make_cfg(spec)
        data, model = mesh_axes(cfg, world, len(batches[0]["x"]))
        dist.init_mesh(model)
        start, n = dist.host_local_batch_slice(len(batches[0]["x"]))
        rows = slice(start, start + n)
        res = grads64(inputs, rows) if spec.get("mode") == "grad64" else run(inputs, rows)
        res["coords"] = np.array([dist.data_index(), dist.model_index(), data, model])
        np.savez(out_path, **res)
    finally:
        dist.shutdown()


if __name__ == "__main__":
    main()
