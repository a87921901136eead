"""Device selection for the port's entry points: CUDA unless the caller
asks for the CPU, and an error — never a silent CPU run — when CUDA is
asked for and absent."""
from __future__ import annotations

import torch


def resolve(device="cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but CUDA is not "
                           f"available; pass device='cpu' to run the plain "
                           f"PyTorch path")
    return dev
