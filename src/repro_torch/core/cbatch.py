"""Continuous-batching slot scheduling (paper §4.2.1: the inference
service "processes them efficiently via continuous batching"): the
admission/eviction policy the paged engine (``core/paged.py``) runs, and
the completion record it emits. Requests leave their slot the step they
finish, so the engine emits in completion order, never submission order.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Callable, List, Optional

import numpy as np


@dataclasses.dataclass
class Completed:
    request_id: int
    response_ids: np.ndarray     # (n,) int32, includes EOS if hit
    finish_step: int             # engine step at completion (completion order)


class SlotScheduler:
    """Admission/eviction bookkeeping for a fixed pool of decode slots —
    the host-side policy of the paged-pool engine in ``core/paged.py``.

    Requests join a FIFO; each engine step fills free slots from the front
    (an optional ``gate`` refuses admission while a resource — e.g. the KV
    page freelist — is exhausted, without reordering the FIFO), and
    completed requests leave their slot the step they finish, so the engine
    emits in completion order, never submission order."""

    def __init__(self, num_slots: int):
        self.num_slots = num_slots
        self.slot_req: List[Optional[object]] = [None] * num_slots
        self._pending: deque = deque()
        self.step = 0

    # -- queue state --------------------------------------------------------
    def submit(self, req) -> None:
        self._pending.append(req)

    @property
    def num_pending(self) -> int:
        return len(self._pending)

    def active_slots(self) -> List[int]:
        return [s for s in range(self.num_slots)
                if self.slot_req[s] is not None]

    @property
    def idle(self) -> bool:
        return not self._pending and not any(
            r is not None for r in self.slot_req)

    # -- admission / eviction ----------------------------------------------
    def admit(self, gate: Optional[Callable] = None,
              limit: Optional[int] = None) -> List[tuple]:
        """Fill free slots from the FIFO; returns [(slot, request), ...].
        ``gate(req) -> bool`` may refuse the request at the FIFO's front,
        which stops admission this step (strict FIFO, no overtaking).
        ``limit`` caps admissions per call — engines whose gate depends on
        resources consumed by admission itself (the paged engine's page
        freelist) admit one at a time so the gate never reads stale state."""
        out = []
        for s in range(self.num_slots):
            if limit is not None and len(out) >= limit:
                break
            if self.slot_req[s] is not None or not self._pending:
                continue
            if gate is not None and not gate(self._pending[0]):
                break
            req = self._pending.popleft()
            self.slot_req[s] = req
            out.append((s, req))
        return out

    def evict(self, slot: int):
        """Free a slot (completion or preemption); returns its request."""
        req = self.slot_req[slot]
        self.slot_req[slot] = None
        return req

    def tick(self) -> int:
        self.step += 1
        return self.step
