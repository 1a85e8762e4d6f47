"""Device selection for the port's entry points.

Entry points run on the card unless the caller asks for another device.
There is no silent fallback: asking for CUDA on a machine without a CUDA
device is an error.
"""
from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``None`` means ``"cuda"``; a CUDA device must exist."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path on the CPU")
    return dev
