"""Learning-rate schedules (copy of
``wavenet_autoencoders_tpu/train/schedule.py:11-47``): plain functions of
the step counter, selected by name through ``get_schedule``. Returned as
Python floats."""
from __future__ import annotations

import math


def noam_learning_rate_decay(init_lr, global_step, warmup_steps=4000):
    warmup_steps = float(warmup_steps)
    step = float(global_step) + 1.0
    return init_lr * warmup_steps**0.5 * min(step * warmup_steps**-1.5, step**-0.5)


def step_learning_rate_decay(init_lr, global_step, anneal_rate=0.98, anneal_interval=100000):
    return init_lr * anneal_rate ** (int(global_step) // anneal_interval)


def cyclic_cosine_annealing(init_lr, global_step, T, M):
    TdivM = T // M
    return init_lr / 2.0 * (math.cos(math.pi * ((int(global_step) - 1) % TdivM) / TdivM) + 1.0)


_SCHEDULES = {
    "noam_learning_rate_decay": noam_learning_rate_decay,
    "step_learning_rate_decay": step_learning_rate_decay,
    "cyclic_cosine_annealing": cyclic_cosine_annealing,
}


def get_schedule(name: str | None, init_lr: float, kwargs: dict):
    """Returns step -> lr."""
    if name is None or name == "none":
        return lambda step: float(init_lr)
    fn = _SCHEDULES[name]
    return lambda step: fn(init_lr, step, **kwargs)
