"""The temporary data generator — the paper's core new component (§4.2),
the port of ``src/repro/core/generator.py``: a background thread running
parallel workers that dispatch prompts to the inference service, score
returned rollouts with the reward module, and enqueue (rewards, rollout)
into the shared queue.
"""
from __future__ import annotations

import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, List, Optional

import numpy as np

from repro_torch.core.engine import InferencePool
from repro_torch.core.queue import RolloutGroup, RolloutQueue


class TemporaryDataGenerator:
    def __init__(self, pool: InferencePool, queue: RolloutQueue,
                 reward_fn: Callable, group_size: int,
                 num_workers: Optional[int] = None):
        self.pool = pool
        self.queue = queue
        self.reward_fn = reward_fn
        self.group_size = group_size
        # scripted instances serve one request at a time, so one worker per
        # instance saturates the pool; paged instances decode concurrent
        # groups together, so enough workers to fill every decode slot
        # (ceil(slots/group) groups, +1 so a group waits when another
        # drains) turn into deeper continuous batches
        def _workers_for(inst) -> int:
            eng = inst.paged_engine
            return 1 if eng is None else -(-eng.B // eng.G) + 1
        per_inst = max(_workers_for(i) for i in pool.instances)
        self.num_workers = num_workers or max(2, per_inst * len(pool))
        self._threads: list = []

    # ------------------------------------------------------------------
    def submit_batch(self, batch: List[tuple], base_key: tuple,
                     weight_version: int) -> None:
        """batch: list of (problem, prompt_ids). Registers all groups with
        the queue *before* the background thread starts, then dispatches
        asynchronously (Algorithm 1 line 5). Group i samples under the key
        ``base_key + (i,)``."""
        self.queue.register_pending(len(batch))
        keys = [tuple(base_key) + (i,) for i in range(len(batch))]

        def produce_one(item, key):
            problem, prompt_ids = item
            prompts = [prompt_ids] * self.group_size          # G rollouts/group
            try:
                # version gate: the request blocks until the instance's
                # active buffer holds at least the iteration's weights
                out, version = self.pool.generate_group(
                    prompts, key, min_version=weight_version)
                # repro: allow(host-sync): completed-rollout readback for
                # host-side reward scoring, once per finished group
                resp = np.asarray(out.response_ids)
                # repro: allow(host-sync): same completed-group readback
                lens = np.asarray(out.response_len)
                lps = getattr(out, "response_logprobs", None)
                lps = None if lps is None else np.asarray(lps, np.float32)
                rewards = np.asarray(
                    [self.reward_fn(resp[g, : lens[g]], problem.answer)
                     for g in range(self.group_size)], np.float32)
                self.queue.put(RolloutGroup(
                    uid=problem.uid, prompt_ids=np.asarray(prompt_ids, np.int32),
                    response_ids=resp, response_len=lens, rewards=rewards,
                    weight_version=version, response_logprobs=lps,
                    answer=problem.answer))
            except BaseException as exc:  # surface in the consumer, no deadlock
                self.queue.put_error(exc)
                raise

        def run():
            with ThreadPoolExecutor(max_workers=self.num_workers) as ex:
                futures = [ex.submit(produce_one, item, k)
                           for item, k in zip(batch, keys)]
                for f in futures:
                    # produce_one already forwarded a failure to the consumer
                    f.exception()

        th = threading.Thread(target=run, daemon=True)
        self._threads.append(th)
        th.start()

    def join(self, timeout: Optional[float] = None) -> bool:
        """Wait for outstanding producer threads. Returns True when every
        thread has drained, False on timeout (one overall deadline)."""
        deadline = None if timeout is None else time.monotonic() + timeout
        for th in self._threads:
            th.join(timeout=None if deadline is None
                    else max(0.0, deadline - time.monotonic()))
        self._threads = [t for t in self._threads if t.is_alive()]
        return not self._threads
