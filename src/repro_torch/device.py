"""Where the port's entry points run: on the card unless asked otherwise."""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means the CUDA card, and raises where there is none: the
    port never falls back to the CPU on its own.  Pass ``device="cpu"`` to
    run there on purpose (the tests do)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass device='cpu' to run the "
                               "port on the CPU")
        return torch.device("cuda")
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{device} requested but no CUDA device is "
                           "available")
    return device


def require_on(device: torch.device, tokens: torch.Tensor) -> None:
    """A step bound to ``device`` refuses tokens that lie elsewhere rather
    than quietly running there."""
    if tokens.device.type != device.type:
        raise ValueError(f"step bound to {device}, tokens on "
                         f"{tokens.device}")
