"""Inference service: a pool of independent engine instances with
iteration-boundary weight synchronisation (the decoupled deployment of
paper §4.1), the port of ``src/repro/core/engine.py``.

Two execution modes per instance:
  * paged — token-level continuous batching over a paged KV cache
            (core/paged.py): concurrent group requests from the generator's
            workers decode together one token per step, short rollouts free
            their slots early, and the GRPO group's prompt is stored once.
            Worker threads drive the engine convoy-style: whoever waits on a
            group steps the engine under the instance lock, so no dedicated
            decode thread exists and the engine goes quiet exactly when no
            requests are in flight (weight sync stays an iteration-boundary
            event — Proposition 1 intact);
  * scripted — the instance returns scripted responses: the trainer's-eye
            view of a remote inference deployment, which the tests use for
            deterministic rollouts.
The JAX package's group-at-a-time ``Sampler`` engine is not ported
(``configs.base.engine_support``).

Weights live in a :class:`~repro_torch.transfer.service.VersionedParamStore`
per instance: readers take an atomic (params, version) snapshot, and the
weight-plane streams versioned buckets into the store's back buffer.

The producer threads and the trainer share one card and PyTorch's default
stream: the device runs their work in the order it was issued, so producer
and consumer do not overlap on the device in this slice.
"""
from __future__ import annotations

import threading
import time
from typing import Callable, List, Optional

import numpy as np

from repro_torch.configs.base import ModelConfig
from repro_torch.core.paged import PagedGroupEngine
from repro_torch.transfer.service import VersionedParamStore


class InferenceInstance:
    def __init__(self, inst_id: int, cfg: ModelConfig, *,
                 scripted_fn: Optional[Callable] = None,
                 paged_engine: Optional[PagedGroupEngine] = None):
        if (paged_engine is None) == (scripted_fn is None):
            raise ValueError("an instance runs either a paged engine or a "
                             "scripted_fn (the group engine is not ported)")
        self.inst_id = inst_id
        self.cfg = cfg
        self.scripted_fn = scripted_fn
        self.paged_engine = paged_engine
        # the paged engine refuses a weight swap while decoding, so its
        # flips are DEFERRED to the scheduler's boundary (after the queue
        # drain) instead of landing from the stream thread
        self.store = VersionedParamStore(
            name=f"inst{inst_id}",
            on_flip=(None if paged_engine is None else paged_engine.set_params),
            defer_flip=paged_engine is not None)
        self._lock = threading.Lock()  # one engine step / request at a time
        self._busy_lock = threading.Lock()
        self.busy_time = 0.0

    def _charge(self, seconds: float) -> None:
        with self._busy_lock:
            self.busy_time += seconds

    def generate_group(self, prompts: List[np.ndarray], key,
                       min_version: Optional[int] = None) -> tuple:
        """Returns (RolloutBatch, weight_version).

        ``min_version`` is the rollout-side half of the weight-plane's
        version gate: the request blocks until the store's ACTIVE buffer
        holds at least that version, so overlapped bucket streaming can
        never hand an iteration-t request pre-flip weights."""
        if self.paged_engine is not None:
            return self._generate_group_paged(prompts, key, min_version)
        with self._lock:
            # gate BEFORE the busy clock starts: time blocked on the flip
            # is the boundary's sync-gap, not inference occupancy
            _, version = self.store.wait_version(min_version)
            t0 = time.perf_counter()
            out = self.scripted_fn(prompts, key)
            self._charge(time.perf_counter() - t0)
            return out, version

    def _generate_group_paged(self, prompts: List[np.ndarray], key,
                              min_version: Optional[int] = None) -> tuple:
        """Token-level path: submit the group, then help drive the shared
        engine until it completes. Concurrent callers' groups share decode
        steps — the instance lock serialises single steps, not groups."""
        eng = self.paged_engine
        if len(prompts) != eng.G:
            raise ValueError(f"group size {len(prompts)} != engine "
                             f"group_size {eng.G}")
        # the paged engine stores ONE physical prompt per group
        if not all(np.array_equal(p, prompts[0]) for p in prompts[1:]):
            raise ValueError("paged engine serves GRPO groups: all prompts "
                             "in a group must be identical")
        # the engine holds the flipped params and refuses a swap while
        # decoding, so the version cannot change while this group runs
        _, version = self.store.wait_version(min_version)
        handle = eng.submit(prompts[0], key)
        while not handle.done():
            with self._lock:
                if handle.done():
                    break
                t0 = time.perf_counter()
                eng.step()
                self._charge(time.perf_counter() - t0)
        return handle.result(), version


class InferencePool:
    """Evenly distributes incoming prompt groups across instances (paper
    §4.2.1)."""

    def __init__(self, instances: List[InferenceInstance]):
        self.instances = instances
        self._rr = 0
        self._rr_lock = threading.Lock()

    def __len__(self) -> int:
        return len(self.instances)

    def pick(self) -> InferenceInstance:
        with self._rr_lock:
            inst = self.instances[self._rr % len(self.instances)]
            self._rr += 1
            return inst

    def generate_group(self, prompts, key, min_version: Optional[int] = None):
        return self.pick().generate_group(prompts, key, min_version)

    def engine_stats(self) -> dict:
        """Aggregated paged-engine counters (zeros without a paged engine),
        so callers can diff snapshots unconditionally."""
        agg = {"decode_steps": 0, "generated_tokens": 0, "prefills": 0}
        for inst in self.instances:
            if inst.paged_engine is not None:
                for k, v in inst.paged_engine.stats_snapshot().items():
                    agg[k] += v
        return agg

    @property
    def busy_time(self) -> float:
        """Aggregate producer busy-time across instances (the quantity
        ``IterationStats.infer_time`` reports)."""
        total = 0.0
        for inst in self.instances:
            with inst._busy_lock:
                total += inst.busy_time
        return total
