"""Device selection for the port's entry points.

Entry points default to ``"cuda"``. When no CUDA device exists they raise
instead of running on the CPU; the CPU is used only when asked for.
"""
from __future__ import annotations

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU"
        )
    return dev


def check_on(module: torch.nn.Module, device: str | torch.device) -> torch.device:
    """Resolve ``device`` and require that ``module`` lives there; returns
    the module's device."""
    dev = resolve_device(device)
    have = next(module.parameters()).device
    if have.type != dev.type or (dev.index is not None and have.index != dev.index):
        raise RuntimeError(f"model is on {have}, but device={dev} was asked for")
    return have
