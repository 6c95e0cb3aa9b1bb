"""Explicit device resolution.

Callers name the device they want; nothing here picks "cuda if available".
A request for CUDA on a host without a usable card is an error, not a silent
move to the CPU.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device) -> torch.device:
    """'cpu' | 'cuda' | 'cuda:N' | torch.device -> torch.device.

    Raises RuntimeError for a CUDA device when torch sees no card, and
    ValueError for any other device type (the port runs on these two)."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {dev} requested but torch sees no CUDA card")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}; use 'cpu' or 'cuda'")
    return dev
