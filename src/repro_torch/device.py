"""Device selection for the port's entry points: CUDA unless the caller
asks for the CPU, and an error — never a silent CPU run — when CUDA is
asked for and absent; and the rollout engines' CUDA stream on each card."""
from __future__ import annotations

import threading
from typing import Callable, Dict, Optional, TypeVar

import torch

# the rollout engines' CUDA stream on each card, made at first use
_STREAMS: Dict[int, torch.cuda.Stream] = {}
_STREAMS_LOCK = threading.Lock()
_R = TypeVar("_R")


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


def tree_leaves(tree: dict):
    """The leaves of a nested dict of tensors (a parameter tree)."""
    for v in tree.values():
        yield from (tree_leaves(v) if isinstance(v, dict) else (v,))


def on_engine_stream(stream: Optional[torch.cuda.Stream], params: dict,
                     fn: Callable[[], _R]) -> _R:
    """``fn()`` on a rollout engine's ``stream``, with the edges every
    engine keeps to its caller (on the CPU, where ``stream`` is None,
    just ``fn()``): the stream first waits for the caller's, where the
    weights ``params`` were written; every leaf of ``params`` is kept from
    reuse until the stream's kernels have run (``record_stream``: a store
    may drop its last reference to a tree mid-call, at an off-policy
    flip); the caller's stream then waits for the engine's, and every
    tensor of a tuple result is kept from reuse until the caller's work on
    it has run. Returns what ``fn`` returned."""
    if stream is None:
        return fn()
    caller = torch.cuda.current_stream(stream.device)
    stream.wait_stream(caller)
    with torch.cuda.stream(stream):
        out = fn()
    for leaf in tree_leaves(params):
        leaf.record_stream(stream)
    caller.wait_stream(stream)
    if isinstance(out, tuple):
        for t in out:
            if isinstance(t, torch.Tensor):
                t.record_stream(caller)
    return out
