"""Continuous batching (paper §4.2.1: the inference service "processes
them efficiently via continuous batching"): the slot scheduler every
token-level engine shares, and the dense-slot engine
``ContinuousBatchingSampler`` (the port of ``src/repro/core/cbatch.py``).

  * ``SlotScheduler`` is the admission/eviction policy of this module's
    engine and of the paged engine (``core/paged.py``): requests leave
    their slot the step they finish, so an engine emits in completion
    order, never submission order;
  * ``ContinuousBatchingSampler`` keeps a fixed pool of B slots over ONE
    dense (or ring) cache of ``max_ctx`` slots a row: ``_admit``
    runs one prompt and splices its row into the pool at its slot,
    ``_decode_block`` advances every slot D tokens at per-row cache
    offsets (finished or empty slots ride along masked), and the host
    loop admits pending requests into freed slots between blocks. With
    ``spec_k`` it drafts k tokens a slot and commits 1..k+1 of them with
    one verify forward a step (``spec/sampler.py dense_verify_step``).
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Callable, List, Optional

import numpy as np
import torch

from repro_torch import device as _device
from repro_torch.configs.base import ModelConfig, require_engine_support
from repro_torch.data.tokenizer import Tokenizer
from repro_torch.device import engine_stream, on_engine_stream, to_device
from repro_torch.models import forward_hidden, init_caches
from repro_torch.models.attention import INVALID_POS
from repro_torch.models.layers import lm_head_weight
from repro_torch.models.transformer import prefill_slot
from repro_torch.rl.rollout import Key, _sample_token_rows, row_seed
from repro_torch.spec.draft import make_draft_provider
from repro_torch.spec.sampler import (dense_verify_step, drain_verify,
                                      pack_row_block, truncate_commit,
                                      upload_block)


@dataclasses.dataclass
class Completed:
    request_id: int
    response_ids: np.ndarray     # (n,) int32, includes EOS if hit
    finish_step: int             # engine step at completion (completion order)


class SlotScheduler:
    """Admission/eviction bookkeeping for a fixed pool of decode slots —
    the host-side policy every token-level engine here shares (this
    module's ``ContinuousBatchingSampler`` and the paged-pool engine in
    ``core/paged.py``).

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


def _request_seed(key: Key, rid: int) -> int:
    """Request ``rid`` of a call keyed ``key`` samples as row 0 of a group
    keyed ``(key, rid)``: the paged engine's ``serve`` keys it so."""
    words = [key] if isinstance(key, (int, np.integer)) else list(key)
    return row_seed(tuple(words) + (rid,), 0)


class ContinuousBatchingSampler:
    """The dense-slot continuous-batching engine (the module docstring).

    ``run`` serves a list of prompts through ``num_slots`` slots and
    returns ``Completed`` records in completion order, each with its
    engine step (``finish_step``). ``drain_interval`` D fuses D decode
    steps a block: D 1 drains every block before the next; D > 1 runs a
    one-deep pipeline (block n + 1 is dispatched before block n is read
    back), so admission happens at block boundaries. The per-slot write
    offsets, response positions and stop flags stay on the device and are
    set only at admission; which slots a block runs, and for how many
    steps (a request's cap), comes from the host's plan. One buffered
    readback a block (``_drain_run``).

    Draws are the port's counter hash: request ``rid`` of a call keyed
    ``key`` draws as row 0 of a group keyed ``(key, rid)``, its t-th
    token at counter t (lane ``DECODE_LANE``), and with ``spec_k`` its
    verify lanes at its committed length, as the paged engine draws; so
    its tokens do not depend on the slot count, D or the other requests
    (MoE off: a MoE layer's capacity follows each forward's token count).
    Under a sliding window the prefill is the JAX engine's: a prompt
    row right-padded to ``max_prompt_len`` and longer than the ring
    ring-writes its padding over the prompt's in-window keys (ROADMAP
    fact H), so windowed tokens are held to the JAX engine's, not to the
    paged engine's.

    Runs eagerly on ``device`` (CUDA unless the caller asks for the CPU);
    on the card every kernel runs on the rollout engines' stream
    (``device.engine_stream``): it waits for the caller's stream before
    it reads the weights and keeps every weight it read from reuse until
    its kernels have run (``record_stream``)."""

    def __init__(self, cfg: ModelConfig, *, num_slots: int,
                 max_prompt_len: int, max_new_tokens: int,
                 temperature: float = 1.0, top_p: float = 1.0,
                 eos_id: int = Tokenizer.EOS, pad_id: int = Tokenizer.PAD,
                 spec_k: int = 0, spec_draft: str = "prompt_lookup",
                 spec_ngram: int = 3, drain_interval: int = 1, seed: int = 0,
                 device="cuda"):
        require_engine_support(cfg, "cbatch")
        if drain_interval < 1:
            raise ValueError(f"drain_interval must be >= 1, "
                             f"got {drain_interval}")
        self.cfg = cfg
        self.B = num_slots
        self.Lp = max_prompt_len
        self.T = max_new_tokens
        self.drain = drain_interval
        self.spec_k = spec_k
        # speculative writes run up to k tokens past the frontier: the
        # cache (and a windowed ring, through ring_slack) gets that slack
        self.max_ctx = max_prompt_len + max_new_tokens + \
            (spec_k + 1 if spec_k else 0)
        self.temperature = temperature
        self.top_p = top_p
        self.eos_id = eos_id
        self.pad_id = pad_id
        self.device = _device.resolve(device)
        self.stream = engine_stream(self.device)
        if spec_k:
            require_engine_support(cfg, "spec", rollout_engine="cbatch")
            self._draft = make_draft_provider(
                spec_draft, cfg, num_slots, spec_k=spec_k, ngram=spec_ngram,
                max_prompt_len=max_prompt_len,
                max_new_tokens=max_new_tokens, pad_id=pad_id, seed=seed,
                device=self.device)
        self.steps = 0                 # the last run's engine steps
        self.reset_spec_stats()

    # -- spec stats ---------------------------------------------------------

    def reset_spec_stats(self) -> None:
        self.spec_steps = 0            # verify forwards x live slots
        self.drafted_tokens = 0
        self.accepted_tokens = 0

    @property
    def acceptance_rate(self) -> float:
        return (self.accepted_tokens / self.drafted_tokens
                if self.drafted_tokens else 0.0)

    # -- device cores -------------------------------------------------------

    def _decode_block(self, params, caches, W, st: dict, valid,
                      active) -> torch.Tensor:
        """D decode steps for every slot. A slot is live at step j when
        the host scheduled it (``active``, ``valid[j]``: its cap) and it
        has not sampled EOS (the device-carried ``st["done"]``): it
        samples from the logits in hand (keyed by its seed and response
        position), writes its K/V at its offset and computes the next
        logits; other slots decode PAD at position 0 into slot 0, over
        whatever their finished request left there (as in JAX; a slot is
        prefilled again before it is live). ``st`` (logits, offsets,
        response positions, done flags) is updated. Returns (D, B)
        tokens."""
        cfg = self.cfg
        logits, off, t, done = st["logits"], st["off"], st["t"], st["done"]
        seeds = st["seeds"]
        zero = torch.zeros_like(off)
        toks = []
        for j in range(self.drain):
            tok = _sample_token_rows(logits, seeds, t, self.temperature,
                                     self.top_p)
            live = active & ~done & valid[j]
            tok = torch.where(live, tok, self.pad_id)
            done = done | (live & (tok == self.eos_id))
            at = torch.where(live, off, zero)
            h, _ = forward_hidden(params, cfg, tok[:, None],
                                  positions=at[:, None],
                                  segments=torch.where(live, 0, -1)[:, None],
                                  caches=caches, cache_offset=at)
            logits = h[:, 0].float() @ W
            off = off + live.to(off.dtype)
            t = t + live.to(t.dtype)
            toks.append(tok)
        st.update(logits=logits, off=off, t=t, done=done)
        return torch.stack(toks)

    # -- host-side scheduler -------------------------------------------------

    def run(self, params, prompts: List[np.ndarray], key: Key,
            max_new_per_request: Optional[List[int]] = None
            ) -> List[Completed]:
        """Serve all prompts through the slot pool; returns completions in
        completion order. ``max_new_per_request`` caps each request's
        generation (a freed slot admits the next request at once)."""
        return on_engine_stream(
            self.stream, params,
            lambda: self._serve(params, prompts, key, max_new_per_request))

    def _serve(self, params, prompts, key, max_new_per_request):
        if self.spec_k:
            return self._run_spec(params, prompts, key, max_new_per_request)
        return self._run(params, prompts, key, max_new_per_request)

    def _admit(self, params, caches, W, logits, s: int, p) -> int:
        """Prefill request prompt ``p``, right-padded to Lp, into slot
        ``s`` (a one-row cache of the pool's length, ring slack k + 1 with
        spec, spliced into the slot's row) and put its last token's logits
        in hand; returns its length."""
        p = np.asarray(p, np.int64)[: self.Lp]
        row = np.full((1, self.Lp), self.pad_id, np.int64)
        row[0, : len(p)] = p
        h = prefill_slot(params, self.cfg, caches, s,
                         to_device(row, self.device), len(p), self.max_ctx,
                         ring_slack=self.spec_k + 1 if self.spec_k else 0)
        logits[s] = h.float() @ W
        return len(p)

    def _run(self, params, prompts, key, max_new_per_request):
        cfg, B, D, dev = self.cfg, self.B, self.drain, self.device
        limits = (max_new_per_request if max_new_per_request is not None
                  else [self.T] * len(prompts))
        sched = SlotScheduler(B)
        for rid, p in enumerate(prompts):
            sched.submit((rid, p))
        W = lm_head_weight(params["embed"], cfg).float()
        caches = init_caches(cfg, B, self.max_ctx, device=dev)
        # device-resident decode state, touched host-side only at
        # admission (fill_: a write of a host scalar would wait)
        st = {"logits": torch.zeros((B, cfg.vocab_size),
                                    dtype=torch.float32, device=dev),
              "off": torch.zeros((B,), dtype=torch.int64, device=dev),
              "t": torch.zeros((B,), dtype=torch.int64, device=dev),
              "done": torch.zeros((B,), dtype=torch.bool, device=dev),
              "seeds": torch.zeros((B,), dtype=torch.int64, device=dev)}
        counts = [0] * B          # host mirror: tokens SCHEDULED per slot
        caps = [0] * B
        slot_toks: List[list] = [[] for _ in range(B)]
        done: List[Completed] = []
        pending = None            # in-flight (plan, base_step, tokens)
        while not sched.idle or pending is not None:
            for s, (rid, p) in sched.admit():
                # queued after any in-flight block, which saw the slot
                # stopped
                n = self._admit(params, caches, W, st["logits"], s, p)
                st["off"][s].fill_(n)
                st["t"][s].fill_(0)
                st["done"][s].fill_(False)
                st["seeds"][s].fill_(_request_seed(key, rid))
                counts[s] = 0
                caps[s] = min(self.T, limits[rid])
                slot_toks[s] = []
            # one D-step block for every slot: the scheduler's occupancy
            # is the decode mask, the per-request cap the valid mask
            nxt = None
            plan = []
            valid = np.zeros((D, B), bool)
            active = np.zeros((B,), bool)
            for s in sched.active_slots():
                n_row = min(D, caps[s] - counts[s])
                if n_row <= 0:    # fully scheduled; awaiting its drain
                    continue
                valid[:n_row, s] = True
                active[s] = True
                plan.append((s, sched.slot_req[s], n_row))
                counts[s] += n_row
            if plan:
                base = sched.step
                sched.step += D
                flags = to_device(np.concatenate([valid, active[None]]), dev)
                toks = self._decode_block(params, caches, W, st, flags[:D],
                                          flags[D])
                nxt = (plan, base, _to_host_async(toks))
            if D == 1:
                prev = nxt
            else:
                prev, pending = pending, nxt
            if prev is not None:
                self._drain_run(prev, sched, slot_toks, limits, done)
        self.steps = sched.step
        return done

    def _drain_run(self, blk, sched, slot_toks, limits, done) -> None:
        """Commit one drained block into host bookkeeping — the only
        device->host wait of the run loop, once per D-step block (its
        copy was queued at dispatch)."""
        plan, base, (buf, ready) = blk
        if ready is not None:
            ready.synchronize()
        toks = buf.tolist()       # one readback a block, not a token
        for s, req, n_row in plan:
            if sched.slot_req[s] is not req:
                # finished in an earlier block; these optimistic steps
                # ran device-masked (its stop flag)
                continue
            rid = req[0]
            for j in range(n_row):
                tv = toks[j][s]
                slot_toks[s].append(tv)
                if (tv == self.eos_id
                        or len(slot_toks[s]) >= min(self.T, limits[rid])):
                    done.append(Completed(
                        request_id=rid,
                        response_ids=np.asarray(slot_toks[s], np.int32),
                        finish_step=base + j + 1))
                    sched.evict(s)
                    break

    def _run_spec(self, params, prompts, key, max_new_per_request):
        """The speculative run loop: each engine step every live slot
        drafts k tokens and ONE k+1-token verify forward commits 1..k+1 of
        them. A freshly admitted slot rides its first block with its
        prefill logits as p_0 (``fresh``); rejected speculative entries
        carry positions past the frontier (masked) until the next block
        overwrites them. Idle slots write pads at offset 0."""
        self.reset_spec_stats()
        cfg, B, k, dev = self.cfg, self.B, self.spec_k, self.device
        limits = (max_new_per_request if max_new_per_request is not None
                  else [self.T] * len(prompts))
        sched = SlotScheduler(B)
        for rid, p in enumerate(prompts):
            sched.submit((rid, p))
        W = lm_head_weight(params["embed"], cfg).float()
        caches = init_caches(cfg, B, self.max_ctx, device=dev,
                             ring_slack=k + 1)
        logits = torch.zeros((B, cfg.vocab_size), dtype=torch.float32,
                             device=dev)
        plen = np.zeros((B,), np.int64)
        seeds = np.zeros((B,), np.int64)
        fresh = np.zeros((B,), bool)
        slot_toks: List[list] = [[] for _ in range(B)]
        done: List[Completed] = []
        while not sched.idle:
            for s, (rid, p) in sched.admit():
                plen[s] = self._admit(params, caches, W, logits, s, p)
                seeds[s] = _request_seed(key, rid)
                fresh[s] = True
                slot_toks[s] = []
                self._draft.start(s, np.asarray(p, np.int64)[: self.Lp])
            act = sched.active_slots()
            draft = self._draft.propose(act, k)
            tokens = np.full((B, k + 1), self.pad_id, np.int64)
            positions = np.full((B, k + 1), INVALID_POS, np.int64)
            segs = np.full((B, k + 1), -1, np.int64)
            offs = np.zeros((B,), np.int64)
            rc = np.zeros((B,), np.int64)
            for s in act:
                t = len(slot_toks[s])
                delta = pack_row_block(
                    tokens[s], positions[s], segs[s], fresh[s], draft[s],
                    slot_toks[s][-1] if slot_toks[s] else 0,
                    int(plen[s]) + t, k)
                # right-padded slots: cache slot index == position
                offs[s] = plen[s] + t + delta
                rc[s] = t
            blk = upload_block(tokens, positions, segs, offs, fresh, draft,
                               seeds, rc, dev)
            out = dense_verify_step(cfg, self.temperature, self.top_p, False,
                                    params, caches, W, *blk[:4], logits,
                                    *blk[4:])
            self._commit_spec_rows(act, out, sched, slot_toks, limits,
                                   fresh, done)
        self.steps = sched.step
        return done

    def _commit_spec_rows(self, act, out, sched, slot_toks, limits, fresh,
                          done) -> None:
        """Read one verify block back and commit its rows — the host half
        of the spec step, one frame below the run loop; after the read the
        walk touches only host lists."""
        k = self.spec_k
        ctoks, _, count = drain_verify(out, False)
        step = sched.tick()
        for s in list(act):
            rid = sched.slot_req[s][0]
            n = count[s]
            self.spec_steps += 1
            self.drafted_tokens += k
            self.accepted_tokens += n - 1
            cap = min(self.T, limits[rid])
            ct, _, row_done = truncate_commit(
                ctoks[s][:n], [0.0] * n, cap - len(slot_toks[s]),
                self.eos_id)
            slot_toks[s].extend(ct)
            self._draft.commit(s, ct)
            fresh[s] = False
            if row_done:
                done.append(Completed(
                    request_id=rid,
                    response_ids=np.asarray(slot_toks[s], np.int32),
                    finish_step=step))
                sched.evict(s)
                self._draft.stop(s)


def _to_host_async(t: torch.Tensor):
    """Queue a copy of ``t`` to pinned host memory and an event after it
    (the read waits on the event alone): (host tensor, event); on the CPU
    (t, None)."""
    if t.device.type != "cuda":
        return t, None
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    ready = torch.cuda.Event()
    ready.record()
    return host, ready
