"""One engine step captured as a CUDA graph and replayed (the port's
counterpart of a jitted step function: one replay launches every kernel of
the step with no per-op host work).

A step function reads its host-built inputs from one static device buffer
(``StaticInputs``: the caller uploads each call's arrays into it) and the
engine's own state (weights, page pool, logits), and returns its outputs.
``StepGraph`` warms it up once on the current stream (the paged engine's
own, a side stream), captures it, and at every ``replay`` copies the
outputs to page-locked host memory on the same stream and records an
event the caller waits on before reading them.

Graphs exist only for CUDA tensors; on the CPU the caller runs the same
step function eagerly (as a kernel wrapper picks its route by device). A
capture or a replay that fails raises: nothing falls back to eager
execution on the card.

Both the upload and the output copies alternate between two host buffers,
so a buffer is written again only two calls later. The caller must have
waited in between on the event of the call that used it (the paged
engine's drain does: it reads block n before it dispatches block n + 2),
and the upload, the replay and that event must be issued on one stream
(the paged engine's own, which its ``_run_step`` checks).
"""
from __future__ import annotations

import contextlib
import math
import time
from typing import Callable, Dict, Tuple

import numpy as np
import torch

from repro_torch.kernels import add_launches, recording


class StaticInputs:
    """Named int64 arrays packed in one device buffer: one host-to-device
    copy per call, from page-locked memory on the card."""

    def __init__(self, shapes: Dict[str, tuple], device: torch.device):
        self.layout = {}
        n = 0
        for name, shape in shapes.items():
            size = math.prod(shape)
            self.layout[name] = (n, size, shape)
            n += size
        self.buffer = torch.zeros(n, dtype=torch.int64, device=device)
        pinned = device.type == "cuda"
        self._host = [torch.zeros(n, dtype=torch.int64, pin_memory=pinned)
                      for _ in range(2 if pinned else 1)]
        self._turn = 0

    def __getitem__(self, name: str) -> torch.Tensor:
        off, size, shape = self.layout[name]
        return self.buffer[off:off + size].view(shape)

    def upload(self, arrays: Dict[str, np.ndarray]) -> None:
        """Copy every named array (all of them, each call) to the device
        on the current stream, without waiting for the device."""
        if arrays.keys() != self.layout.keys():
            raise ValueError(f"upload needs exactly {sorted(self.layout)}, "
                             f"got {sorted(arrays)}")
        host = self._host[self._turn]
        self._turn = (self._turn + 1) % len(self._host)
        flat = host.numpy()
        for name, a in arrays.items():
            off, size, _ = self.layout[name]
            flat[off:off + size] = np.asarray(a).reshape(-1)
        self.buffer.copy_(host, non_blocking=True)


class StepGraph:
    """``fn`` (no arguments, returns a tuple of tensors) captured on
    ``device``. The warm-up call runs ``fn`` once for real (its kernel
    launches count as eager ones); the captured kernels' launch tally is
    added to ``kernels.LAUNCHES`` at every replay."""

    def __init__(self, fn: Callable[[], Tuple[torch.Tensor, ...]],
                 device: torch.device):
        if device.type != "cuda":
            raise ValueError(f"CUDA graphs need a CUDA device, got {device}")
        t0 = time.perf_counter()
        fn()                     # lazy set-up: cuBLAS, kernel builds, plans
        torch.cuda.synchronize(device)
        t1 = time.perf_counter()
        self.graph = torch.cuda.CUDAGraph()
        # thread_local: another thread (the trainer) may allocate on the
        # card while this one captures
        with recording() as tally, torch.cuda.graph(
                self.graph, capture_error_mode="thread_local"):
            outputs = fn()
        torch.cuda.synchronize(device)
        self.warmup_ms = (t1 - t0) * 1e3
        self.capture_ms = (time.perf_counter() - t1) * 1e3
        self.tally = dict(tally)
        self.outputs = tuple(outputs)
        self._host = [tuple(torch.empty(o.shape, dtype=o.dtype,
                                        pin_memory=True)
                            for o in self.outputs) for _ in range(2)]
        self._turn = 0
        self._timed = None       # (start, end) event pairs while timing

    @contextlib.contextmanager
    def timing(self):
        """While open, record a pair of CUDA timing events around each
        replay; yields the list of (start, end) pairs."""
        self._timed = pairs = []
        try:
            yield pairs
        finally:
            self._timed = None

    def replay(self) -> Tuple[Tuple[torch.Tensor, ...], torch.cuda.Event]:
        """Launch the graph on the current stream and queue the copies of
        its outputs to the host there; the event and any timing events are
        recorded on that stream too. Returns (host outputs, their
        event)."""
        if self._timed is None:
            self.graph.replay()
        else:
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            start.record()
            self.graph.replay()
            end.record()
            self._timed.append((start, end))
        add_launches(self.tally)
        host = self._host[self._turn]
        self._turn ^= 1
        for h, o in zip(host, self.outputs):
            h.copy_(o, non_blocking=True)
        ready = torch.cuda.Event()
        ready.record()
        return host, ready
