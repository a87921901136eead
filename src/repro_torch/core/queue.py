"""The shared rollout queue (paper Figure 1, Algorithm 1 line 1).

Producer coroutines enqueue completed rollout *groups* (one prompt, G
responses, rewards); the consumer (main thread) dequeues in completion-time
order. Every item is tagged with the weight version that generated it so the
on-policy invariant (Proposition 1) can be asserted, not assumed.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Optional

import numpy as np


@dataclasses.dataclass
class RolloutGroup:
    uid: int                       # problem uid
    prompt_ids: np.ndarray         # (Lp,) int32
    response_ids: np.ndarray       # (G, T) int32, PAD after EOS
    response_len: np.ndarray       # (G,) int32
    rewards: np.ndarray            # (G,) float32
    weight_version: int            # policy iteration t that generated this
    # (G, T) float32 rollout-captured log p(sampled id) under the raw model
    # distribution — the behavior/old-policy logprobs the trainer would
    # otherwise recompute (DESIGN.md §Tri-model-capture). None when the
    # producing instance does not capture (scripted/simulated).
    response_logprobs: Optional[np.ndarray] = None
    answer: Optional[int] = None
    meta: Optional[dict] = None


class RolloutQueue:
    """Thread-safe FIFO with wait-empty support (Algorithm 1 line 3)."""

    def __init__(self, maxsize: int = 0):
        self._q: queue.Queue = queue.Queue(maxsize=maxsize)
        self._outstanding = 0
        self._lock = threading.Condition()

    def register_pending(self, n: int = 1) -> None:
        """Producer declares n groups that WILL be enqueued — wait_empty
        blocks until they are consumed, closing the enqueue race."""
        with self._lock:
            self._outstanding += n
            self._lock.notify_all()

    def put(self, item: RolloutGroup) -> None:
        self._q.put(item)

    def put_error(self, exc: BaseException) -> None:
        """Producer-side failure: unblocks the consumer, which re-raises —
        a dead producer must not deadlock the pipeline."""
        self._q.put(exc)

    def get(self, timeout: Optional[float] = None) -> RolloutGroup:
        item = self._q.get(timeout=timeout)
        with self._lock:
            self._outstanding -= 1
            self._lock.notify_all()
        if isinstance(item, BaseException):
            raise item
        return item

    def wait_empty(self, timeout: Optional[float] = None) -> bool:
        """Blocks until all registered groups have been consumed."""
        with self._lock:
            return self._lock.wait_for(lambda: self._outstanding == 0,
                                       timeout=timeout)

    @property
    def outstanding(self) -> int:
        with self._lock:
            return self._outstanding

    def qsize(self) -> int:
        return self._q.qsize()
