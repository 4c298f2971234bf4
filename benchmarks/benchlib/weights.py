"""A model's weights drawn from the run's seed, by parameter name.

The names are the port's JAX tree paths (``wavenet/layers/3/conv/g``); the
benchmark lists them from the port's model and hands the same tensors to
the program (copied into its parameters) and to the reference. Every leaf
is cut from two draws made in one call each on the device, a standard
normal and a uniform, and scaled by its kind at the scales of the models'
initialisation:

- a weight-normed conv's direction ``v`` (K, Cin, Cout): Kaiming normal;
  its gain ``g`` (Cout,): the direction's expected column norm ± 10 %; its
  bias: N(0, 0.05²);
- an upsampler's smoothing kernel ``v``: the mean filter ± 10 %, its scalar
  ``g`` the filter's norm ± 5 %;
- a plain conv's or linear's ``w`` and ``b``: U(±1/√fan_in);
- the speaker table: N(0, 0.1²); a VQ codebook: U(±1/K).
"""
from __future__ import annotations

import math

import torch


def _kind(name: str, shapes: dict) -> str:
    parent, leaf = name.rsplit("/", 1)
    if name.endswith("embed/table"):
        return "table"
    if "/codebooks/" in f"/{name}" or parent.endswith("codebooks"):
        return "codebook"
    wn = f"{parent}/v" in shapes
    if wn and len(shapes[f"{parent}/v"]) == 4:
        return {"v": "smooth_v", "g": "smooth_g"}[leaf]
    if wn:
        return {"v": "wn_v", "g": "wn_g", "b": "wn_b"}[leaf]
    return {"w": "plain_w", "b": "plain_b"}[leaf]


def draw(shapes: dict[str, tuple], seed: int, device) -> dict[str, torch.Tensor]:
    """{name: f32 tensor on ``device``} for ``shapes`` ({name: shape}), the
    same for the same seed."""
    names = sorted(shapes)
    sizes = [math.prod(shapes[n]) for n in names]
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 63))
    normal = torch.randn(sum(sizes), generator=gen, device=device)
    uniform = torch.rand(sum(sizes), generator=gen, device=device) * 2.0 - 1.0
    out, at = {}, 0
    for name, n in zip(names, sizes):
        shape = tuple(shapes[name])
        z, u = normal[at : at + n].view(shape), uniform[at : at + n].view(shape)
        at += n
        kind = _kind(name, shapes)
        parent = name.rsplit("/", 1)[0]
        if kind == "wn_v":
            k, cin = shape[0], shape[1]
            t = z * math.sqrt(2.0 / (k * cin))
        elif kind == "wn_g":
            t = math.sqrt(2.0) * (1.0 + 0.1 * u)
        elif kind == "wn_b":
            t = 0.05 * z
        elif kind == "smooth_v":
            t = (1.0 + 0.1 * u) / shape[-1]
        elif kind == "smooth_g":
            t = (1.0 + 0.05 * u) / math.sqrt(shapes[f"{parent}/v"][-1])
        elif kind == "plain_w":
            fan_in = math.prod(shape[:-1])
            t = u / math.sqrt(fan_in)
        elif kind == "plain_b":
            w = shapes[f"{parent}/w"]
            t = u / math.sqrt(math.prod(w[:-1]))
        elif kind == "table":
            t = 0.1 * z
        else:  # codebook (K, D)
            t = u / shape[0]
        out[name] = t.contiguous()
    return out
