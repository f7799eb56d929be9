"""Device selection for the port's entry points: CUDA unless the caller
asks for the CPU, and never a quiet fallback to the CPU."""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """`None` means "cuda". A CUDA device without a card raises, naming the
    way to run on the CPU instead."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {dev} requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run repro_torch on the CPU")
    return dev
