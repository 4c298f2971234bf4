"""One rank of the port's data-parallel CPU tests (test_torch_port_distributed.py).

    python _torch_port_dp_worker.py <init_method> <world> <rank> <out.npz>

Joins the gloo process group, builds the tiny svqwae of ``dp_config`` on
the CPU and takes ``STEPS`` train steps on its slice of ``dp_batch``'s
global batch, then writes each step's metrics, the parameters, the model
state (EMA codebooks, usage) and the Adam moments to ``out.npz``. The
one-process reference runs the same functions on the whole batch. It
imports only the port.
"""
import sys
from pathlib import Path

import numpy as np

STEPS = 2
GLOBAL_B = 4


def dp_config():
    from wavenet_autoencoders_tpu_torch.config import load_preset

    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from _torch_port_util import TINY_SVQWAE

    return load_preset("svqwae", TINY_SVQWAE).replace(
        upsample_params={"upsample_scales": [2, 2]}, batch_size=GLOBAL_B, clip_thresh=1.0,
        ema=True, vq_reseed=True, vq_reseed_start=0, vq_reseed_thresh=0.9, vq_reseed_decay=0.5,
        time_jitter=True, vq_drop=True, drop_dim=2,
    )


def dp_batch(step, T=32):
    """The global batch of a step; its rows have other lengths, so the ranks'
    mask counts differ."""
    rng = np.random.default_rng(100 + step)
    return {
        "x": rng.integers(0, 32, (GLOBAL_B, T)).astype(np.int32),
        "y": rng.integers(0, 32, (GLOBAL_B, T, 1)).astype(np.int32),
        "c": rng.standard_normal((GLOBAL_B, T, 39)).astype(np.float32),
        "g": np.array([1, 5, 2, 7], np.int32),
        "lengths": np.array([T, T - 13, T - 2, 9], np.int32),
    }


def run(rows: slice):
    """STEPS train steps of the tiny model on ``rows`` of each global batch;
    returns {name: array} of metrics and final state."""
    import torch

    from wavenet_autoencoders_tpu_torch.models import build_model
    from wavenet_autoencoders_tpu_torch.train.step import init_state, make_train_step
    from wavenet_autoencoders_tpu_torch.utils.params import flatten_state

    cfg = dp_config()
    model = build_model(cfg, device="cpu").train()
    state = init_state(cfg, model)
    step = make_train_step(cfg, model)
    out = {}
    for i in range(STEPS):
        batch = {k: torch.from_numpy(v[rows]) for k, v in dp_batch(i).items()}
        state, m = step(state, batch)
        for k, v in m.items():
            out[f"metrics/{i}/{k}"] = np.float64(v)
    for k, v in state.params().items():
        out[f"params/{k}"] = v.detach().numpy().copy()
        out[f"mu/{k}"] = state.mu[k].numpy().copy()
    for k, v in flatten_state(model).items():
        out[f"model_state/{k}"] = v.numpy().copy()
    return out


def main():
    init, world, rank, out_path = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
    import torch

    torch.set_num_threads(1)
    from wavenet_autoencoders_tpu_torch.parallel import distributed as dist

    dist.initialize_distributed(init, world, rank, device="cpu")
    try:
        start, n = dist.host_local_batch_slice(GLOBAL_B)
        np.savez(out_path, **run(slice(start, start + n)))
    finally:
        dist.shutdown()


if __name__ == "__main__":
    main()
