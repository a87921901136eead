"""Device selection for the port's entry points: CUDA unless the caller
asks for the CPU, and an error — never a silent CPU run — when CUDA is
asked for and absent; and the rollout engines' CUDA stream on each card."""
from __future__ import annotations

import threading
from typing import Dict, Optional

import torch

# the rollout engines' CUDA stream on each card, made at first use
_STREAMS: Dict[int, torch.cuda.Stream] = {}
_STREAMS_LOCK = threading.Lock()


def resolve(device="cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but CUDA is not "
                           f"available; pass device='cpu' to run the plain "
                           f"PyTorch path")
    return dev


def engine_stream(device: torch.device) -> Optional[torch.cuda.Stream]:
    """The CUDA stream every rollout engine on ``device`` (the paged
    engines and the group Sampler) issues its work on: one a card, shared
    by its engines (PyTorch keeps a cuBLAS workspace per stream for the
    process's life, so a stream per engine would grow memory with every
    engine built); None on the CPU."""
    if device.type != "cuda":
        return None
    idx = torch.cuda.current_device() if device.index is None \
        else device.index
    with _STREAMS_LOCK:
        if idx not in _STREAMS:
            _STREAMS[idx] = torch.cuda.Stream(idx)
        return _STREAMS[idx]


def to_device(a, device: torch.device) -> torch.Tensor:
    """A host (numpy) array on ``device``, copied from page-locked memory
    without waiting for the device (on the CPU: the array itself)."""
    t = torch.from_numpy(a)
    if device.type == "cuda":
        t = t.pin_memory()
    return t.to(device, non_blocking=True)
