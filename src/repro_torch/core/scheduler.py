"""Periodic-asynchrony scheduler — Algorithm 1 of the paper, the port of
``src/repro/core/scheduler.py``.

Modes:
  * ``sync``            — synchronous decoupled baseline: dispatch all
                          rollouts, wait for the full batch, then train in the
                          original prompt order (Figure 3a).
  * ``async``           — periodic asynchrony: the consumer trains on rollouts
                          in completion order while the producer is still
                          generating; weights sync only at iteration
                          boundaries (Figure 3b). Strictly on-policy —
                          asserted at runtime per group.
  * ``async_offpolicy`` — AReaL-like baseline with staleness threshold eta:
                          the producer runs up to eta iterations ahead, so
                          consumed rollouts may be stale (the group
                          Sampler or scripted instances: a paged engine
                          needs quiescence at a flip).

TPSPD (tokens trained per second per device) is the paper's primary metric.

On the card the paged engines decode on their stream (one a card) and the
trainer works on its thread's stream, so each side's busy time is its own:
``infer_time`` waits only on the engine's stream and ``train_time`` only on
the trainer's (``_settle``). The two sides run at once, so ``infer_time
+ train_time`` may exceed ``wall_time``: the difference is the host time
both were busy, which holds either side's waits for the card (the device's
own overlap needs a profile).
The JAX package's trace spans and registry metrics (its obs plane) are not
ported yet.
"""
from __future__ import annotations

import dataclasses
import time
from typing import List

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, RLConfig
from repro_torch.core.generator import TemporaryDataGenerator
from repro_torch.core.onpolicy import OnPolicyMonitor
from repro_torch.core.queue import RolloutGroup, RolloutQueue
from repro_torch.core.spa import PAD, pack_plain, pack_spa
from repro_torch.core.trimodel import TriModelState
from repro_torch.optim.accumulate import GradAccumulator
from repro_torch.rl.grpo import (MicroBatch, group_advantages,
                                 make_apply_update, make_grad_step,
                                 make_grad_step_captured, to_device)
from repro_torch.transfer.service import WeightTransferService


@dataclasses.dataclass
class IterationStats:
    iteration: int
    wall_time: float
    infer_time: float   # producer busy-time summed over pool instances
    # consumer BUSY-time: grad micro-steps + the boundary update only (time
    # blocked on queue.get() waiting for the producer is excluded)
    train_time: float
    trained_tokens: int
    reward_mean: float
    tpspd: float
    max_staleness: int
    metrics: dict


def _pad_rows(mb: MicroBatch, m: int) -> MicroBatch:
    """Pad a micro-batch to exactly m rows (dummy rows carry zero weight)."""
    have = mb.tokens.shape[0]
    if have == m:
        return mb
    pad_n = m - have
    S = mb.tokens.shape[1]
    z_i = np.zeros((pad_n, S), np.int32)
    z_f = np.zeros((pad_n, S), np.float32)
    return MicroBatch(
        tokens=np.concatenate([mb.tokens, np.full((pad_n, S), PAD, np.int32)]),
        labels=np.concatenate([mb.labels, z_i]),
        positions=np.concatenate([mb.positions, z_i]),
        segments=np.concatenate([mb.segments, np.full((pad_n, S), -1, np.int32)]),
        loss_mask=np.concatenate([mb.loss_mask, z_f]),
        advantages=np.concatenate([mb.advantages, z_f]),
        n_samples=mb.n_samples,
        logp_behavior=(None if mb.logp_behavior is None
                       else np.concatenate([mb.logp_behavior, z_f])),
    )


def _settle(device: torch.device) -> None:
    """Wait until the device has run the work this thread issued so far:
    its own stream only, not the paged engines' (trainer-side busy-time
    measurement; nothing to wait for on the CPU)."""
    if device.type == "cuda":
        torch.cuda.current_stream(device).synchronize()


class PeriodicAsyncScheduler:
    def __init__(self, cfg: ModelConfig, rl: RLConfig, tri: TriModelState,
                 generator: TemporaryDataGenerator, queue: RolloutQueue,
                 loader, *, device: torch.device,
                 transfer: WeightTransferService):
        self.cfg = cfg
        self.rl = rl
        self.tri = tri
        self.generator = generator
        self.queue = queue
        self.loader = loader
        self.device = device
        self.transfer = transfer
        self.grad_step = make_grad_step(cfg, rl)
        self.grad_step_captured = make_grad_step_captured(cfg, rl)
        # captured = ratio from rollout-time behavior logprobs (one ref
        # no-grad forward); recomputed = old+ref no-grad forwards (capture
        # off, or rollouts without captured logprobs, e.g. scripted)
        self.captured_micro_steps = 0
        self.recomputed_micro_steps = 0
        self.apply_update = make_apply_update(cfg, rl)
        self.monitor = OnPolicyMonitor(strict=(rl.mode != "async_offpolicy"))
        self.history: List[IterationStats] = []
        # submitted-but-unconsumed batches carried across run() calls (the
        # off-policy producer runs up to eta iterations ahead)
        self._inflight: List = []
        self._submits = 0        # rollout keys are (seed, submit index, group)
        self._train_busy = 0.0
        # set when a run() unwound mid-iteration: re-entry is refused
        self._failed = False

    # ------------------------------------------------------------------
    def _micro_batches(self, group: RolloutGroup):
        adv = group_advantages(group.rewards).numpy()
        rl = self.rl
        if rl.shared_prompt_attention:
            mb = pack_spa(group, adv, rl.max_prompt_len, rl.max_response_len,
                          responses_per_row=rl.group_size)
            if not rl.capture_logprobs:
                mb = mb._replace(logp_behavior=None)
            yield mb, float(mb.n_samples)
        else:
            mb = pack_plain([group], [adv], rl.max_prompt_len,
                            rl.max_response_len)
            if not rl.capture_logprobs:
                mb = mb._replace(logp_behavior=None)
            m = rl.micro_batch
            rows = mb.tokens.shape[0]
            for lo in range(0, rows, m):
                hi = min(lo + m, rows)
                sub = MicroBatch(
                    tokens=mb.tokens[lo:hi], labels=mb.labels[lo:hi],
                    positions=mb.positions[lo:hi],
                    segments=mb.segments[lo:hi],
                    loss_mask=mb.loss_mask[lo:hi],
                    advantages=mb.advantages[lo:hi],
                    n_samples=np.float32(hi - lo),
                    logp_behavior=(None if mb.logp_behavior is None
                                   else mb.logp_behavior[lo:hi]))
                yield _pad_rows(sub, m), float(hi - lo)

    def _train_group(self, group: RolloutGroup, acc: GradAccumulator) -> int:
        """Consumer busy work for one group, timed into ``_train_busy``."""
        tokens = 0
        t0 = time.perf_counter()
        for mb, weight in self._micro_batches(group):
            if mb.logp_behavior is not None:
                self.captured_micro_steps += 1
                step = self.grad_step_captured
            else:
                self.recomputed_micro_steps += 1
                step = self.grad_step
            grads, _ = step(self.tri.policy, self.tri.old, self.tri.ref,
                            to_device(mb, self.device))
            acc.add(grads, weight)
            del grads
            _settle(self.device)          # trainer-side busy-time barrier
            tokens += int((np.asarray(mb.tokens) != PAD).sum())
        self._train_busy += time.perf_counter() - t0
        return tokens

    def _finish_iteration(self, acc: GradAccumulator) -> None:
        t0 = time.perf_counter()
        new_params, new_opt, _ = self.apply_update(
            self.tri.policy, self.tri.opt, acc.mean())
        acc.reset()
        # the update must materialise before the version flip
        # (Proposition 1 boundary); once per iteration
        _settle(self.device)
        self.tri.apply_update(new_params, new_opt)   # line 11
        self._train_busy += time.perf_counter() - t0
        # overlap: stream the NEW version's buckets to the pool's back
        # buffers now, under the iteration tail; flips stay version-gated
        self.transfer.publish_async(self.tri.policy, self.tri.version)

    def _sync_boundary(self, submit) -> None:
        """THE iteration boundary (Algorithm 1 lines 3 + 10): drain (strict
        modes), dispatch the iteration's submissions, flip every instance
        to the policy's version through the weight-plane barrier, then old
        <- policy. Submissions version-gate on ``tri.version``, so they
        cannot sample pre-flip weights, and paged engines stay quiescent
        through their deferred flip."""
        if self.rl.mode in ("sync", "async"):
            self.queue.wait_empty()          # Algorithm 1 line 3
        submit()
        flipped = self.transfer.ensure(self.tri.policy, self.tri.version)
        self.tri.refresh_old(expected_rollout_version=flipped)   # line 10

    def _submit(self, batch) -> None:
        self.generator.submit_batch(batch, (self.rl.seed, self._submits),
                                    self.tri.version)
        self._submits += 1

    # ------------------------------------------------------------------
    def run(self, num_iterations: int) -> List[IterationStats]:
        """Run ``num_iterations`` and return THEIR stats (``history`` keeps
        every call's). Safe to call repeatedly; refuses re-entry after a
        run() that raised mid-iteration."""
        if self._failed:
            raise RuntimeError(
                "scheduler state is inconsistent: a previous run() raised "
                "mid-iteration. Rebuild the pipeline instead of retrying.")
        start = len(self.history)
        mode = self.rl.mode
        pool = self.generator.pool
        eta = self.rl.staleness_eta if mode == "async_offpolicy" else 0
        need = num_iterations + eta - len(self._inflight)
        batches = self._inflight + list(self.loader.batches(max(need, 0)))
        next_submit = len(self._inflight)
        consumed_upto = 0

        try:
            for t in range(num_iterations):
                it_start = time.perf_counter()
                busy0 = pool.busy_time
                engine0 = pool.engine_stats()
                self._train_busy = 0.0
                acc = GradAccumulator()
                rewards_seen: List[float] = []
                trained_tokens = 0
                self.monitor.max_staleness_seen = 0

                if mode in ("sync", "async"):
                    def submit():
                        nonlocal next_submit
                        self._submit(batches[t])
                        next_submit = t + 1

                    self._sync_boundary(submit)
                    n_expect = len(batches[t])
                    if mode == "sync":
                        self.generator.join()        # full-batch barrier
                    groups = []
                    for _ in range(n_expect):
                        groups.append(self.queue.get())
                        if mode == "async":
                            g = groups[-1]
                            self.monitor.check(g, self.tri.version)
                            rewards_seen.extend(g.rewards.tolist())
                            trained_tokens += self._train_group(g, acc)
                    if mode == "sync":
                        groups.sort(key=lambda g: g.uid)  # prompt order
                        for g in groups:
                            self.monitor.check(g, self.tri.version)
                            rewards_seen.extend(g.rewards.tolist())
                            trained_tokens += self._train_group(g, acc)
                else:  # async_offpolicy (AReaL-like, staleness <= eta)
                    def submit():
                        nonlocal next_submit
                        while (next_submit <= t + eta
                               and next_submit < len(batches)):
                            self._submit(batches[next_submit])
                            next_submit += 1

                    self._sync_boundary(submit)
                    for _ in range(len(batches[t])):
                        g = self.queue.get()
                        self.monitor.check(g, self.tri.version)
                        rewards_seen.extend(g.rewards.tolist())
                        trained_tokens += self._train_group(g, acc)

                self._finish_iteration(acc)
                wall = time.perf_counter() - it_start
                engine1 = pool.engine_stats()
                d = {k: engine1[k] - engine0[k] for k in engine1}
                probes = d["prefix_hit_pages"] + d["prefix_miss_pages"]
                stats = IterationStats(
                    iteration=start + t, wall_time=wall,
                    infer_time=pool.busy_time - busy0,
                    train_time=self._train_busy,
                    trained_tokens=trained_tokens,
                    reward_mean=(float(np.mean(rewards_seen))
                                 if rewards_seen else 0.0),
                    tpspd=trained_tokens / wall,      # one card
                    max_staleness=self.monitor.max_staleness_seen,
                    # boundary sync-gap: time the pool sat idle waiting for
                    # this iteration's weight flip; the engine counters of
                    # the iteration (zero without a paged engine) and the
                    # spec acceptance and prefix hit rate they give
                    metrics={"sync_gap": self.transfer.last_gap, **d,
                             "spec_acceptance": (
                                 d["accepted_tokens"] / d["drafted_tokens"]
                                 if d["drafted_tokens"] else 0.0),
                             "prefix_hit_rate": (
                                 d["prefix_hit_pages"] / probes
                                 if probes else 0.0)})
                self.history.append(stats)
                consumed_upto = t + 1
        except BaseException:
            self._failed = True
            raise
        finally:
            self._inflight = batches[consumed_upto:next_submit]
            # join any background bucket stream before unwinding; on the
            # happy path a failed stream's error surfaces here
            try:
                self.transfer.drain()
            except Exception:
                if not self._failed:
                    self._failed = True
                    raise
        self.generator.join()
        return self.history[start:]
