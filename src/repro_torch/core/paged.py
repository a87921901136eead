"""Token-level paged continuous-batching decode engine (the port of
``src/repro/core/paged.py``).

The engine decodes ONE token per step for a pool of slots that mixes rows
from many GRPO groups, admitting pending rows the step a slot frees (the
admission/eviction policy is ``core/cbatch.py``'s ``SlotScheduler``).

The KV cache is paged (``models/attention.py PagedCacheBackend``):

  * one physical page pool per layer, stitched into logical sequences by a
    per-slot page table;
  * a GRPO group's G rows list the SAME prompt pages, so the shared prompt
    is stored (and prefilled) once per group; prompt pages are refcounted
    (one reference per row) and free when the whole group has finished,
    response pages free when their row finishes;
  * response pages are allocated LAZILY, one page as the write cursor
    crosses into it, against a per-row page *credit* reserved at
    admission — the admission gate reads ``free - outstanding_credit``, so
    an admitted row can always take its next page (no mid-decode stall, no
    deadlock).

Page 0 is the null page (pos 2^30, masked everywhere), page 1 the trash
page inactive slots write into.

Each step runs on the device in order: sample every slot's token from the
logits in hand, write its K/V into the pool, attend over its pages (the
paged flash-decode kernel on CUDA), and compute the next logits; the
host then reads the step's tokens once (``_drain_block``). A prompt is
prefilled by ``forward_hidden`` over a dense temporary cache (the SPA
kernel on CUDA) and spliced into its pages. This slice drains every step
(the JAX engine's ``drain_interval=1``); sliding windows, speculative
decode and the radix prefix cache are refused at construction through
``require_engine_support``.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch import device as _device
from repro_torch.configs.base import ModelConfig, require_engine_support
from repro_torch.core.cbatch import Completed, SlotScheduler
from repro_torch.data.tokenizer import Tokenizer
from repro_torch.models import forward_hidden, init_caches, init_paged_caches
from repro_torch.models.attention import INVALID_POS, cache_streams
from repro_torch.models.layers import lm_head_weight
from repro_torch.rl.rollout import (Key, RolloutBatch, _sample_token_rows,
                                    row_generator, sampled_token_logprob)

NULL_PAGE = 0
TRASH_PAGE = 1
FIRST_PAGE = 2


class PageAllocator:
    """Host-side freelist + refcounts over the physical page pool.

    Prompt pages are allocated with refcount G (one per group row) and
    release once per row at its completion; response pages are
    single-owner."""

    def __init__(self, num_pages: int):
        if num_pages <= FIRST_PAGE:
            raise ValueError("page pool smaller than its reserves")
        self._free = list(range(num_pages - 1, FIRST_PAGE - 1, -1))
        self._ref: Dict[int, int] = {}
        self.min_free = len(self._free)      # high-water occupancy marker

    @property
    def num_free(self) -> int:
        return len(self._free)

    @property
    def num_live(self) -> int:
        """Pages currently referenced (freelist + live == capacity)."""
        return len(self._ref)

    def alloc(self, n: int, refcount: int = 1) -> Optional[List[int]]:
        if len(self._free) < n:
            return None
        pages = [self._free.pop() for _ in range(n)]
        for p in pages:
            self._ref[p] = refcount
        self.min_free = min(self.min_free, len(self._free))
        return pages

    def release(self, pages: List[int]) -> int:
        """Drop one reference per page; returns how many pages went back
        to the freelist (a shared prompt page frees with its last ref)."""
        freed = 0
        for p in pages:
            if self._ref.get(p, 0) <= 0:
                raise RuntimeError(f"release of dead page {p}")
            self._ref[p] -= 1
            if self._ref[p] == 0:
                del self._ref[p]
                self._free.append(p)
                freed += 1
        return freed


@dataclasses.dataclass
class _Group:
    gid: int
    prompt: np.ndarray               # (Lp,) int32, already truncated
    G: int
    key: Key                         # sampling key of the group's rows
    max_new: int
    prompt_pages: Optional[List[int]] = None
    prompt_logits: Optional[torch.Tensor] = None   # (V,) f32 on device
    # streaming delivery: on_token(row_idx, token_id) for every committed
    # token, in commit order (launch/serve.py RequestDriver)
    on_token: Optional[object] = None
    done_rows: Dict[int, np.ndarray] = dataclasses.field(default_factory=dict)
    done_lps: Dict[int, np.ndarray] = dataclasses.field(default_factory=dict)
    finish_step: int = 0


@dataclasses.dataclass
class _Row:
    group: _Group
    idx: int                         # row index within the group
    toks: list = dataclasses.field(default_factory=list)
    lps: list = dataclasses.field(default_factory=list)
    pages: list = dataclasses.field(default_factory=list)  # resp page k -> id
    credit: int = 0                  # future page allocations reserved
    gen: Optional[torch.Generator] = None   # sampling generator (None: greedy)


@dataclasses.dataclass
class _Block:
    """One dispatched decode step: the slots it ran and its device-side
    (B,) token / logprob buffers, read back by ``_drain_block``."""
    plan: list                       # [(slot, row), ...]
    base: int                        # engine step counter at dispatch
    toks: torch.Tensor
    lps: Optional[torch.Tensor]


class GroupHandle:
    """Future for a submitted group; resolves to a RolloutBatch."""

    def __init__(self, group: _Group):
        self._group = group
        self._event = threading.Event()
        self._result: Optional[RolloutBatch] = None

    def done(self) -> bool:
        return self._event.is_set()

    def result(self, timeout: Optional[float] = None) -> RolloutBatch:
        if not self._event.wait(timeout):
            raise TimeoutError(f"group {self._group.gid} not complete")
        return self._result

    def host_rows(self) -> List[np.ndarray]:
        """Per-row committed tokens as host numpy arrays (row order) — what
        the RolloutBatch was assembled from. Completed groups only."""
        g = self._group
        return [g.done_rows[i] for i in range(g.G)]

    @property
    def finish_step(self) -> int:
        return self._group.finish_step


class PagedGroupEngine:
    """Continuous-batching decode over a shared paged KV pool.

    Thread-safe: ``submit`` registers a group's rows; any thread may drive
    ``step``, so concurrently submitted groups batch together at token
    level. Runs on ``device`` (CUDA unless the caller asks for the CPU)."""

    def __init__(self, cfg: ModelConfig, *, num_slots: int, page_size: int,
                 num_pages: int, max_prompt_len: int, max_new_tokens: int,
                 group_size: int, temperature: float = 1.0, top_p: float = 1.0,
                 eos_id: int = Tokenizer.EOS, pad_id: int = Tokenizer.PAD,
                 capture_logprobs: bool = True, spec_k: int = 0,
                 prefix_cache: bool = False, device="cuda"):
        if num_slots < 1 or page_size < 1:
            raise ValueError(f"paged engine needs num_slots >= 1 and "
                             f"page_size >= 1, got {num_slots}/{page_size}")
        require_engine_support(cfg, "paged")
        if spec_k:
            require_engine_support(cfg, "spec")
        if prefix_cache:
            require_engine_support(cfg, "prefix")
        self.cfg = cfg
        self.device = _device.resolve(device)
        self.B = num_slots
        self.page = page_size
        self.Lp = max_prompt_len
        self.T = max_new_tokens
        self.G = group_size
        self.temperature = temperature
        self.top_p = top_p
        self.eos_id = eos_id
        self.pad_id = pad_id
        self.capture_logprobs = capture_logprobs
        self.n_prompt_pages = -(-max_prompt_len // page_size)
        self.n_resp_pages = -(-max_new_tokens // page_size)
        self.n_max = self.n_prompt_pages + self.n_resp_pages
        if num_pages == 0:      # auto-size: two full groups resident
            num_pages = FIRST_PAGE + 2 * (self.n_prompt_pages + group_size
                                          * self._row_budget(max_new_tokens))
        self.P = num_pages
        if FIRST_PAGE + self.n_prompt_pages + 1 > num_pages:
            raise ValueError(
                f"page pool too small: {num_pages} pages cannot hold one "
                f"max-length prompt ({self.n_prompt_pages} pages) + one "
                f"response page + {FIRST_PAGE} reserved")

        self.params = None
        self.caches = None           # built lazily at first set_params
        self.logits = None           # (B, V) f32 per-slot next-token logits
        self._w_head = None          # (d, V) f32 LM head
        self.alloc = PageAllocator(num_pages)
        self.sched = SlotScheduler(num_slots)
        self._ptab = np.zeros((num_slots, self.n_max), np.int32)  # NULL rows
        self._mutex = threading.RLock()
        self._next_gid = 0
        self._handles: Dict[int, GroupHandle] = {}
        self._outstanding = 0        # sum of row credits; free >= this always
        self.decode_steps = 0
        self.generated_tokens = 0
        self.prefills = 0

    def stats_snapshot(self) -> dict:
        """Atomic copy of the engine counters (one mutex hold)."""
        with self._mutex:
            return {"decode_steps": self.decode_steps,
                    "generated_tokens": self.generated_tokens,
                    "prefills": self.prefills}

    # -- page geometry ------------------------------------------------------

    def _row_budget(self, max_new: int) -> int:
        """Response pages a row writes over its whole decode — the page
        credit the admission gate reserves (no window: every written page
        stays resident until the row finishes)."""
        return -(-max_new // self.page)

    # -- device cores -------------------------------------------------------

    def _prefill_group(self, params, caches, row: torch.Tensor, length: int,
                       dest_pages: torch.Tensor) -> torch.Tensor:
        """Run the shared prompt ONCE (row: (1, n_pp * page) right-padded)
        over a dense temporary cache and splice its per-layer K/V into the
        pool at ``dest_pages`` — one physical prompt copy serves every row
        of the group. Returns the last prompt token's logits (V,) f32.

        The temporary cache spans the prompt's own pages, not
        ``max_prompt_len`` (the JAX engine pads to the maximum to keep one
        jit trace): real tokens never see padding (segment -1), so the
        result is the same and a short prompt costs only its own length."""
        cfg = self.cfg
        S = row.shape[1]
        ar = torch.arange(S, dtype=torch.int32, device=self.device)[None]
        real = ar < length
        positions = torch.where(real, ar, 0)
        segments = torch.where(real, 0, -1).to(torch.int32)
        tmp = init_caches(cfg, 1, S, device=self.device)
        h, tmp = forward_hidden(params, cfg, row, positions=positions,
                                segments=segments, caches=tmp, cache_offset=0)
        logits = h[0, length - 1].float() @ self._w_head
        n_pp = dest_pages.shape[0]
        pools, t = caches["layers"]["kv"], tmp["layers"]["kv"]
        for name, shp in cache_streams(cfg):
            pools[name + "_pages"][:, dest_pages] = t[name][:, 0].reshape(
                (cfg.num_layers, n_pp, self.page) + shp)
        pos_write = torch.where(real[0], ar[0], INVALID_POS)
        pools["pos_pages"][:, dest_pages] = pos_write.reshape(n_pp, self.page)
        return logits

    def _decode_block(self, params, caches, logits, gens, live, wslots, pos,
                      ptab):
        """One decode step for every slot: sample from the logits in hand,
        write each live slot's K/V at its flat slot, attend through the
        page table, and compute the next logits. Inactive slots decode PAD
        at pos 2^30 into the trash page. Returns ((B,) tokens, (B,) raw
        logprobs or None, next logits)."""
        tok = _sample_token_rows(logits, gens, self.temperature, self.top_p)
        tok = torch.where(live, tok, self.pad_id)
        lp = (torch.where(live, sampled_token_logprob(logits, tok), 0.0)
              if self.capture_logprobs else None)
        seg = torch.where(live, 0, -1).to(torch.int32)
        h, _ = forward_hidden(params, self.cfg, tok[:, None],
                              positions=pos[:, None], segments=seg[:, None],
                              caches=caches, cache_offset=wslots,
                              page_table=ptab)
        return tok, lp, h[:, 0].float() @ self._w_head

    def _invalidate_pages(self, pages: List[int]) -> None:
        """Mark freshly allocated response pages invalid — they may hold a
        previous sequence's stale (pos, kv) entries, which would otherwise
        pass the causal mask."""
        idx = torch.as_tensor(pages, dtype=torch.long, device=self.device)
        self.caches["layers"]["kv"]["pos_pages"][:, idx] = INVALID_POS

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(self.device)

    # -- host API -----------------------------------------------------------

    def set_params(self, params) -> None:
        """Swap weights (iteration-boundary sync). Must be quiescent."""
        with self._mutex:
            if not self.sched.idle:
                raise RuntimeError("weight sync while rollouts are in flight "
                                   "breaks Proposition 1")
            self.params = params
            # f32 LM head, as the JAX engine computes next-token logits
            # (an f32 copy for bf16 weights: 1.5 GB at llama3.2-3b width)
            self._w_head = lm_head_weight(params["embed"], self.cfg).float()
            if self.caches is None:
                self.caches = init_paged_caches(self.cfg, self.P, self.page,
                                                device=self.device)
                self.logits = torch.zeros((self.B, self.cfg.vocab_size),
                                          dtype=torch.float32,
                                          device=self.device)

    def submit(self, prompt, key: Key, *, max_new: Optional[int] = None,
               on_token=None) -> GroupHandle:
        """Register one GRPO group (G rollouts of one prompt) sampled under
        ``key`` (an int or a sequence of ints). Returns a handle; drive
        ``step`` until it resolves. Raises immediately when the group could
        never be admitted.

        ``on_token(row_idx, token_id)`` streams every committed token in
        commit order; it runs under the engine mutex, so keep it cheap."""
        p = np.asarray(prompt, np.int32)[-self.Lp:]   # keep the tail
        if len(p) == 0:
            raise ValueError("empty prompt")
        max_new = self.T if max_new is None else min(max_new, self.T)
        n_pp = -(-len(p) // self.page)
        need = n_pp + self._row_budget(max_new)
        avail = self.P - FIRST_PAGE
        if need > avail:
            raise ValueError(
                f"group can never be admitted: prompt of {len(p)} tokens "
                f"needs {n_pp} pages + {self._row_budget(max_new)} response "
                f"pages per row = {need}, but the pool only ever frees "
                f"{avail} of its {self.P} pages")
        with self._mutex:
            if self.params is None:
                raise RuntimeError("set_params before submit")
            g = _Group(gid=self._next_gid, prompt=p, G=self.G, key=key,
                       max_new=max_new, on_token=on_token)
            self._next_gid += 1
            h = GroupHandle(g)
            self._handles[g.gid] = h
            for i in range(self.G):
                self.sched.submit(_Row(group=g, idx=i))
            return h

    @property
    def idle(self) -> bool:
        with self._mutex:
            return self.sched.idle

    @property
    def peak_pages_used(self) -> int:
        """High-water physical page occupancy (excludes the reserves)."""
        return (self.P - FIRST_PAGE) - self.alloc.min_free

    def reset_stats(self) -> None:
        with self._mutex:
            self.decode_steps = 0
            self.generated_tokens = 0
            self.prefills = 0
            self.alloc.min_free = self.alloc.num_free

    # -- engine step --------------------------------------------------------

    def _admission_gate(self, row: _Row) -> bool:
        """The freelist must cover this row's response pages (and, for a
        group's first row, its prompt pages) ON TOP of every admitted row's
        outstanding credit."""
        need = self._row_budget(row.group.max_new)
        if row.group.prompt_pages is None:
            need += -(-len(row.group.prompt) // self.page)
        return self.alloc.num_free - self._outstanding >= need

    def _admit_row(self, slot: int, row: _Row) -> None:
        g = row.group
        if g.prompt_pages is None:
            n_pp = -(-len(g.prompt) // self.page)
            pages = self.alloc.alloc(n_pp, refcount=g.G)
            assert pages is not None, \
                "admission gate let a row in without pages for its prompt"
            g.prompt_pages = pages
            row_arr = np.full((1, n_pp * self.page), self.pad_id, np.int64)
            row_arr[0, : len(g.prompt)] = g.prompt
            g.prompt_logits = self._prefill_group(
                self.params, self.caches, self._to_device(row_arr),
                len(g.prompt), self._to_device(np.asarray(pages, np.int64)))
            self.prefills += 1
        row.pages = []
        row.credit = self._row_budget(g.max_new)
        self._outstanding += row.credit
        tab = np.zeros((self.n_max,), np.int32)        # NULL padding
        tab[: len(g.prompt_pages)] = g.prompt_pages
        self._ptab[slot] = tab
        self.logits[slot] = g.prompt_logits
        row.toks = []
        row.lps = []
        row.gen = (row_generator(g.key, row.idx, self.device)
                   if self.temperature > 0 else None)

    def _alloc_resp_page(self, slot: int, row: _Row, k: int) -> int:
        """Lazily take response page k (the write cursor just crossed a
        page boundary) out of the row's reserved credit."""
        g = row.group
        assert row.credit > 0, "page-credit invariant violated: row " \
            "admitted without budget for its next page"
        pages = self.alloc.alloc(1)
        assert pages is not None, "freelist below outstanding credit"
        row.credit -= 1
        self._outstanding -= 1
        pid = pages[0]
        row.pages.append(pid)
        self._ptab[slot, len(g.prompt_pages) + k] = pid
        return pid

    def _finish_row(self, slot: int, row: _Row, step: int) -> None:
        g = row.group
        g.done_rows[row.idx] = np.asarray(row.toks, np.int32)
        if self.capture_logprobs:
            g.done_lps[row.idx] = np.asarray(row.lps, np.float32)
        g.finish_step = step
        # the row's response pages + its reference on the shared prompt pages
        self.alloc.release(row.pages + g.prompt_pages)
        row.pages = []
        self._outstanding -= row.credit
        row.credit = 0
        row.gen = None
        self.sched.evict(slot)
        self._ptab[slot] = NULL_PAGE
        if len(g.done_rows) == g.G:
            resp = np.full((g.G, self.T), self.pad_id, np.int32)
            lens = np.zeros((g.G,), np.int32)
            lps = np.zeros((g.G, self.T), np.float32)
            for i, r in g.done_rows.items():
                resp[i, : len(r)] = r
                lens[i] = len(r)
                if self.capture_logprobs:
                    lps[i, : len(r)] = g.done_lps[i]
            h = self._handles.pop(g.gid)
            h._result = RolloutBatch(
                response_ids=torch.from_numpy(resp),
                response_len=torch.from_numpy(lens),
                response_logprobs=(torch.from_numpy(lps)
                                   if self.capture_logprobs else None))
            h._event.set()

    def step(self) -> bool:
        """One admission pass + one decode step for every slot, drained
        before returning. Returns False (and does nothing) when idle."""
        with self._mutex:
            # admit one row at a time: _admit_row consumes pages, and the
            # gate must see the freelist as it actually is for the NEXT row
            while True:
                admitted = self.sched.admit(self._admission_gate, limit=1)
                if not admitted:
                    break
                self._admit_row(*admitted[0])
            act = self.sched.active_slots()
            blk = self._dispatch_block(act) if act else None
            if blk is not None:
                self._drain_block(blk)
            return blk is not None

    def _dispatch_block(self, act: List[int]) -> _Block:
        """Schedule one decode step for the active slots — page bookkeeping
        stays host-side; the device receives (B,) write slots, positions
        and live masks plus the page table."""
        B, page = self.B, self.page
        wsl = np.full((B,), TRASH_PAGE * page, np.int64)
        pos = np.full((B,), INVALID_POS, np.int32)
        live = np.zeros((B,), bool)
        gens: List[Optional[torch.Generator]] = [None] * B
        fresh = []
        plan = []
        for s in act:
            row = self.sched.slot_req[s]
            t = len(row.toks)
            k = t // page
            if k == len(row.pages):       # crossed a page boundary
                fresh.append(self._alloc_resp_page(s, row, k))
            wsl[s] = row.pages[k] * page + t % page
            pos[s] = len(row.group.prompt) + t
            live[s] = True
            gens[s] = row.gen
            plan.append((s, row))
        if fresh:
            self._invalidate_pages(fresh)
        base = self.sched.step
        self.sched.tick()
        toks, lps, self.logits = self._decode_block(
            self.params, self.caches, self.logits, gens,
            self._to_device(live), self._to_device(wsl),
            self._to_device(pos), self._to_device(self._ptab))
        self.decode_steps += 1
        return _Block(plan=plan, base=base, toks=toks, lps=lps)

    def _drain_block(self, blk: _Block) -> None:
        """Commit one decode step into host bookkeeping — the ONLY
        device->host read of the decode path, one frame below ``step``:
        one (B,) token list (and logprob list) per step."""
        toks = blk.toks.tolist()
        lps = blk.lps.tolist() if blk.lps is not None else None
        for s, row in blk.plan:
            g = row.group
            tv = toks[s]
            row.toks.append(tv)
            if lps is not None:
                row.lps.append(lps[s])
            self.generated_tokens += 1
            if g.on_token is not None:
                g.on_token(row.idx, tv)
            if tv == self.eos_id or len(row.toks) >= g.max_new:
                self._finish_row(s, row, blk.base + 1)

    # -- standalone serving -------------------------------------------------

    def serve(self, params, prompts: List[np.ndarray], seed: int
              ) -> List[Completed]:
        """Serve independent requests (engine built with group_size=1;
        request i is its own group, keyed (seed, i)). Returns completions
        in completion order."""
        if self.G != 1:
            raise ValueError("serve() treats each request as a 1-row group; "
                             "build the engine with group_size=1")
        self.set_params(params)
        handles = [self.submit(p, (seed, i)) for i, p in enumerate(prompts)]
        while self.step():
            pass
        done = []
        for rid, h in enumerate(handles):
            h.result(timeout=0)       # completion check (raises if not)
            done.append(Completed(request_id=rid,
                                  response_ids=h.host_rows()[0],
                                  finish_step=h.finish_step))
        done.sort(key=lambda c: c.finish_step)
        return done
