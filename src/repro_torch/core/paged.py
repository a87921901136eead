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
    deadlock);
  * a sliding-window config RECLAIMS out-of-window pages: once a row's
    query position is a whole window past a page's last token
    (``q_pos - last_pos >= window``) the page leaves the row's table and
    the row's reference returns to the allocator (a prompt page that
    another row still sees stays resident through its refcount), so a
    row holds O(window) pages, not O(context). Prompt pages that are
    already out of the first response query's window are never
    allocated (on a prefix-cache engine, those more than a window before
    it: ``_cold_first_page``). Each row keeps its live pages in logical
    order
    (``_Row.live``); reclamation runs on the host at each decode block's
    (or verify step's) first query position, and only rewrites the page
    table the step reads.

Page 0 is the null page (pos 2^30, masked everywhere), page 1 the trash
page inactive slots write into.

Each decode step runs on the device in order: sample every slot's token
from the logits in hand, write its K/V into the pool, attend over its
pages (the paged flash-decode kernel on CUDA), and compute the next
logits. ``drain_interval`` D fuses D such steps into one block (the
device-resident decode loop of the JAX engine): the host schedules each
slot's next D steps from its frontier (``_Row.sched_t``), allocating the
pages they write, and reads the block's (D, B) tokens once
(``_drain_block``). A row that samples EOS inside a block sets its
device-resident ``done`` flag, and its remaining steps decode PAD into the
trash page. D 1 drains every step; D > 1 runs a one-deep pipeline: block
n + 1 is dispatched before block n is drained. On the card one block is
one CUDA-graph replay (``core/graphs.py``), captured at the first
``set_params``; on the CPU the same step function runs eagerly. A prompt
is prefilled by ``forward_hidden`` over a dense temporary cache (the SPA
kernel on CUDA) and spliced into its pages, eagerly (its length varies).

On the card the engine issues all its device work on the paged engines'
CUDA stream (``stream``: one a card, shared by the engines on it,
``engine_stream``), whichever thread calls it: ``step`` (admission,
prefills, uploads, replays) and ``set_params`` enter it, so the rollout
producer's kernels can run beside the trainer's, whose work stays on its
threads' stream. A finished row's pages return to the freelist while a later block may still
be in flight; that is safe because that block runs the row masked and the
next admission's prefill, splice and invalidation run after it on the same
stream (``_run_step`` raises if a step is issued on another). Hand-offs
from other streams are ordered by events: ``set_params`` waits for the
caller's stream before it reads the weights and makes the caller's stream
wait for the copy; a caller's tree freed afterwards is kept from reuse
until the copy has run (``record_stream``). Rollouts leave the engine as
host arrays. On the CPU there is no stream (``stream`` is None).

Two planes layer on the pool:

  * ``spec_k > 0``, speculative decode (``spec/``): each step drafts k
    tokens per row (prompt lookup, or with ``spec_draft="model"`` a
    resident draft model over a dense cache of its own, whose calls run
    eagerly on the engine's stream before the verify step's inputs are
    built, never inside its graph), pre-allocates the block's
    speculative pages against the row's credit, runs ONE k+1-token
    verify forward through the paged-verify kernel (one graph replay on
    the card), commits 1..k+1
    tokens per row by rejection sampling (``_spec_step``), and rolls pages
    that hold only rejected drafts back to the freelist
    (``_rollback_row``). Spec engines drain every verify step, whatever
    ``drain_interval`` says (as the JAX engine does);
  * ``prefix_cache=True``, the radix prefix cache (``core/radix.py``):
    admission walks the tree for the longest cached page-aligned prefix,
    retains the matched pages into the group's table, prefills ONLY the
    uncached suffix into private pages through the same multi-token paged
    route (``_warm_prefill``), and inserts the complete prompt pages back;
    idle cached pages are LRU-evicted by the admission gate on a deficit.

A MoE config's layers route each forward's tokens with a capacity sized
from that forward's token count (``models/moe.py``), as in the JAX
engine: a decode step routes all ``num_slots`` rows (idle ones decode
PAD), a verify step B x (k + 1) tokens, a radix suffix prefill its
bucketed block, a cold prefill ``n_prompt_pages x page`` tokens. Where an
expert overflows, a token's output depends on the other tokens of its
forward, so MoE tokens are held to the JAX engine at the same slots, D
and spec settings; the engine's other invariances (slot count, D, warm
== cold, spec greedy == plain greedy) hold for MoE only where nothing is
dropped.

SSM/hybrid, enc-dec and VLM configs are refused at construction
(``require_engine_support``).
"""
from __future__ import annotations

import dataclasses
import threading
from collections import deque
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch import device as _device
from repro_torch.device import engine_stream, on_engine_stream, to_device
from repro_torch.configs.base import ModelConfig, require_engine_support
from repro_torch.core.cbatch import Completed, SlotScheduler
from repro_torch.core.graphs import StaticInputs, StepGraph
from repro_torch.core.radix import RadixCache
from repro_torch.data.tokenizer import Tokenizer
from repro_torch.models import forward_hidden, init_caches, init_paged_caches
from repro_torch.models.attention import INVALID_POS, cache_streams
from repro_torch.models.layers import lm_head_weight
from repro_torch.rl.rollout import (Key, RolloutBatch, _sample_token_rows,
                                    row_seed, sampled_token_logprob)
from repro_torch.spec import (commit_block, make_draft_provider,
                              pack_row_block, truncate_commit, verify_block)

NULL_PAGE = 0
TRASH_PAGE = 1
FIRST_PAGE = 2


class PageAllocator:
    """Host-side freelist + refcounts over the physical page pool.

    Prompt pages are allocated with refcount G (one per group row) and
    release once per row at its completion; response pages are
    single-owner; the radix cache holds one more reference per cached
    page."""

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

    def retain(self, pages: List[int], n: int = 1) -> None:
        """Add ``n`` references to live pages: the radix cache shares a
        cached prompt page into a group's table (one reference per row,
        plus the tree's own at insert)."""
        for p in pages:
            if p not in self._ref:
                raise RuntimeError(f"retain of dead page {p}")
            self._ref[p] += n

    def refcount(self, page: int) -> int:
        return self._ref.get(page, 0)

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
    # the prompt pages of the group's table (window-visible ones, and on a
    # prefix-cache engine those a warm start needs) and each one's last
    # token position
    prompt_pages: Optional[List[int]] = None
    prompt_last: Optional[List[int]] = None
    prompt_logits: Optional[torch.Tensor] = None   # (V,) f32 on device
    # radix match stashed by the admission gate for _admit_row: (jt, m,
    # pages), the table's first prompt page and pages jt..m-1 already
    # cached as ``pages`` (``_radix_match``)
    match: Optional[tuple] = None
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
    # live pages in logical order: (last_pos, table_idx, page_id, is_prompt)
    live: deque = dataclasses.field(default_factory=deque)
    seed: int = 0                    # sampling seed (rl/rollout.py row_seed)
    # response positions dispatched: the committed length plus the steps
    # of a block still in flight
    sched_t: int = 0
    # spec decode: a fresh row still holds its prefill logits in hand; a
    # steady row's last committed token is unfed and rides into the next
    # verify block
    fresh: bool = True


@dataclasses.dataclass
class _Block:
    """One dispatched decode block: what it scheduled and its (D, B)
    token / logprob buffers, read back by ``_drain_block`` once ``ready``
    (the event after their copy to the host; None on the CPU) has
    passed."""
    plan: list                       # [(slot, row, t0, n_steps), ...]
    base: int                        # engine step counter at dispatch
    out: tuple                       # (toks (D, B) int64, lps (D, B) f32)
    ready: Optional[torch.cuda.Event]


def _tree_clone(tree: dict) -> dict:
    return {k: _tree_clone(v) if isinstance(v, dict) else v.clone()
            for k, v in tree.items()}


def _tree_copy(dst: dict, src: dict) -> None:
    """Copy ``src``'s leaves into ``dst``'s, which must match exactly
    (``copy_`` would broadcast or cast silently)."""
    if dst.keys() != src.keys():
        raise ValueError(f"parameter tree keys changed: {sorted(dst)} vs "
                         f"{sorted(src)}")
    for k, d in dst.items():
        v = src[k]
        if isinstance(d, dict):
            _tree_copy(d, v)
        elif d.shape != v.shape or d.dtype != v.dtype:
            raise ValueError(f"parameter {k}: {tuple(v.shape)} {v.dtype} "
                             f"where the engine holds {tuple(d.shape)} "
                             f"{d.dtype}")
        else:
            d.copy_(v)


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
    level. Runs on ``device`` (CUDA unless the caller asks for the CPU).
    ``drain_interval`` is the decode block length D (the module
    docstring)."""

    def __init__(self, cfg: ModelConfig, *, num_slots: int, page_size: int,
                 num_pages: int, max_prompt_len: int, max_new_tokens: int,
                 group_size: int, temperature: float = 1.0, top_p: float = 1.0,
                 eos_id: int = Tokenizer.EOS, pad_id: int = Tokenizer.PAD,
                 capture_logprobs: bool = True, spec_k: int = 0,
                 spec_draft: str = "prompt_lookup", spec_ngram: int = 3,
                 prefix_cache: bool = False, drain_interval: int = 1,
                 seed: int = 0, device="cuda"):
        if num_slots < 1 or page_size < 1:
            raise ValueError(f"paged engine needs num_slots >= 1 and "
                             f"page_size >= 1, got {num_slots}/{page_size}")
        if drain_interval < 1:
            raise ValueError(f"drain_interval must be >= 1, "
                             f"got {drain_interval}")
        require_engine_support(cfg, "paged")
        self.drain = drain_interval
        self.spec_k = spec_k
        self.cfg = cfg
        self.device = _device.resolve(device)
        if spec_k:
            require_engine_support(cfg, "spec")
            # the draft model (spec_draft "model", its weights from
            # ``seed``) keeps its own weights: set_params leaves them be
            self._draft = make_draft_provider(
                spec_draft, cfg, num_slots, spec_k=spec_k, ngram=spec_ngram,
                max_prompt_len=max_prompt_len,
                max_new_tokens=max_new_tokens, pad_id=pad_id, seed=seed,
                device=self.device)
        if prefix_cache:
            require_engine_support(cfg, "prefix")
        # every device op of the engine runs on this stream (the module
        # docstring); None on the CPU
        self.stream = engine_stream(self.device)
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
        self.window = cfg.sliding_window
        self._prefix_cache = prefix_cache
        self.n_prompt_pages = -(-max_prompt_len // page_size)
        self.n_resp_pages = -(-max_new_tokens // page_size)
        self.n_max = self.n_prompt_pages + self.n_resp_pages
        live_pp_max = self.n_prompt_pages - self._cold_first_page(
            max_prompt_len)
        if num_pages == 0:      # auto-size: two full groups resident
            num_pages = FIRST_PAGE + 2 * (live_pp_max + group_size
                                          * self._row_budget(max_new_tokens))
        self.P = num_pages
        if FIRST_PAGE + live_pp_max + 1 > num_pages:
            raise ValueError(
                f"page pool too small: {num_pages} pages cannot hold one "
                f"max-length prompt ({live_pp_max} window-visible pages) + "
                f"one response page + {FIRST_PAGE} reserved")

        # device state, built at the first set_params (on the card later
        # calls copy new weights in: the captured graph reads these
        # addresses)
        self.params = None
        self.caches = None
        self.logits = None           # (B, V) f32 per-slot next-token logits
        self.done = None             # (B,) bool: the slot's row stopped
        self._w_head = None          # (d, V) f32 LM head
        self._inputs: Optional[StaticInputs] = None
        self._graph: Optional[StepGraph] = None      # CUDA only
        self._pending: Optional[_Block] = None       # in-flight block
        # fresh pages one step invalidates, padded with the trash page:
        # a row's D (or k + 1) positions span at most n // page + 2 pages
        span = spec_k + 1 if spec_k else drain_interval
        self._n_fresh = num_slots * (span // page_size + 2)
        self.alloc = PageAllocator(num_pages)
        self.radix = RadixCache(page_size, self.alloc) if prefix_cache \
            else None
        self.sched = SlotScheduler(num_slots)
        self._ptab = np.zeros((num_slots, self.n_max), np.int32)  # NULL rows
        self._mutex = threading.RLock()
        self._next_gid = 0
        self._handles: Dict[int, GroupHandle] = {}
        self._outstanding = 0        # sum of row credits; free >= this always
        self.decode_steps = 0
        self.generated_tokens = 0
        self.prefills = 0            # cold prompt prefills (dense, SPA)
        self.warm_prefills = 0       # radix suffix prefills (paged verify)
        self.graph_replays = 0       # blocks (or verify steps) replayed
        # decode steps (verify steps) the graph's warm-up ran: real kernel
        # launches outside any request
        self.warmup_steps = 0
        # pages the window slid past that went back to the freelist (a
        # shared prompt page counts once, when its last row drops it)
        self.reclaimed_pages = 0
        self.reset_spec_stats()
        self.reset_prefix_stats()

    def reset_spec_stats(self) -> None:
        with self._mutex:   # counters race with step() from other threads
            self.spec_steps = 0          # verify forwards x live rows
            self.drafted_tokens = 0      # drafts proposed
            self.accepted_tokens = 0     # drafts that survived verify
            self.rolled_back_pages = 0   # speculative pages returned

    def reset_prefix_stats(self) -> None:
        with self._mutex:
            self.prefix_hit_pages = 0       # prompt pages from the tree
            self.prefix_miss_pages = 0      # prompt pages prefilled
            self.prefix_inserted_pages = 0  # pages newly cached
            self.prefix_evicted_pages = 0   # cached pages reclaimed

    @property
    def acceptance_rate(self) -> float:
        with self._mutex:
            return (self.accepted_tokens / self.drafted_tokens
                    if self.drafted_tokens else 0.0)

    @property
    def prefix_hit_rate(self) -> float:
        """Fraction of cacheable prompt pages served from the radix tree."""
        with self._mutex:
            tot = self.prefix_hit_pages + self.prefix_miss_pages
            return self.prefix_hit_pages / tot if tot else 0.0

    def stats_snapshot(self) -> dict:
        """Atomic copy of the engine counters (one mutex hold)."""
        with self._mutex:
            return {"decode_steps": self.decode_steps,
                    "generated_tokens": self.generated_tokens,
                    "prefills": self.prefills,
                    "warm_prefills": self.warm_prefills,
                    "graph_replays": self.graph_replays,
                    "warmup_steps": self.warmup_steps,
                    "reclaimed_pages": self.reclaimed_pages,
                    "spec_steps": self.spec_steps,
                    "drafted_tokens": self.drafted_tokens,
                    "accepted_tokens": self.accepted_tokens,
                    "rolled_back_pages": self.rolled_back_pages,
                    "prefix_hit_pages": self.prefix_hit_pages,
                    "prefix_miss_pages": self.prefix_miss_pages,
                    "prefix_evicted_pages": self.prefix_evicted_pages}

    # -- page geometry ------------------------------------------------------

    def _n_total(self, max_new: int) -> int:
        """Response pages a row writes over its whole decode."""
        return -(-max_new // self.page)

    def _row_budget(self, max_new: int) -> int:
        """Worst-case simultaneously resident response pages of one row —
        the page credit the admission gate reserves. Without a window
        every written page stays until the row finishes (spec positions
        past ``max_new`` go to the trash page, so speculation adds none).
        With one, reclamation at each step's first query position bounds
        the live span to ``window`` positions, which straddle at most
        window // page + 2 pages (+1 for the step's new page). A spec
        block writes up to k tokens past that position, which widens the
        budget by ceil(k / page) + 1, and a D-step block up to D - 1,
        which widens it by (D - 1) // page + 1; never past the total."""
        n = self._n_total(max_new)
        if self.window is None:
            return n
        spec = -(-self.spec_k // self.page) + 1 if self.spec_k else 0
        look = (self.drain - 1) // self.page + 1 if self.drain > 1 else 0
        return min(n, self.window // self.page + 3 + spec + look)

    def _prompt_page_range(self, plen: int):
        """(j0, n_pp): prompt pages j0..n_pp-1 are window-visible to at
        least the first response query (q_pos = plen); pages before j0 are
        dead on arrival and never allocated (j0 is 0 without a window)."""
        n_pp = -(-plen // self.page) if plen else 0
        j0 = 0 if self.window is None else max(0, (plen - self.window)
                                               // self.page)
        return j0, n_pp

    def _cold_first_page(self, plen: int) -> int:
        """The first prompt page a cold prefill allocates: j0, or, on a
        prefix-cache engine under a window, one window of pages before j0
        (from page 0 on for a prompt under two windows). Those pages are
        cached with the rest and reclaimed from the row at its first
        decode step: a later prompt that shares them prefills its suffix
        warm, and that suffix's first query sees a whole window back,
        below its own j0 (``_radix_match``)."""
        j0, _ = self._prompt_page_range(plen)
        if not self._prefix_cache or self.window is None:
            return j0
        return max(0, j0 - self.window // self.page)

    def _radix_match(self, prompt: np.ndarray, j0: int):
        """(jt, m, pages): the group's table starts at prompt page jt, and
        pages jt..m-1 come from the radix tree as ``pages``; m == jt means
        no usable match (a cold prefill from ``_cold_first_page``).

        Without a window the match starts at j0 (0). Under one, a warm
        suffix prefill's first query, at position m * page, sees keys a
        window back, which may lie below j0 (that page is dead only for
        the response). The match is then usable only when the tree holds
        every page from that query's first visible page on; those pages
        join the table, and the row's first decode step reclaims them.
        The JAX engine's match starts at j0 whatever the suffix, so its
        suffix queries there miss the keys below j0 and its warm tokens
        differ from its cold ones."""
        m, pages = self.radix.lookup(prompt, j0=j0)
        if m > j0 and self.window is not None:
            lo = max(0, (m * self.page - self.window + 1) // self.page)
            if lo < j0:
                m2, pages2 = self.radix.lookup(prompt, j0=lo)
                if m2 < m:             # a page the suffix sees is not cached
                    m = j0
                else:
                    return lo, m, pages2
        if m == j0:
            jt = self._cold_first_page(len(prompt))
            return jt, jt, []
        return j0, m, pages

    def _suffix_bucket(self, n_sfx_pages: int) -> int:
        """Pad a radix-miss suffix to a power-of-two page count (as the JAX
        engine does to bound its traces): a warm hit still prefills
        genuinely fewer tokens than a cold start."""
        b = 1
        while b < n_sfx_pages:
            b *= 2
        return min(b, self.n_prompt_pages)

    # -- device cores -------------------------------------------------------

    def _prefill_group(self, params, caches, row: torch.Tensor, length: int,
                       dest_pages: torch.Tensor) -> torch.Tensor:
        """Run the shared prompt ONCE (row: (1, n_pp * page) right-padded)
        over a dense temporary cache and splice its per-layer K/V into the
        pool at ``dest_pages`` — one physical prompt copy serves every row
        of the group. Returns the last prompt token's logits (V,) f32.

        ``dest_pages`` holds the prompt's last pages, those from the
        group's first table page on: with a sliding window the leading
        pages that the first response query cannot see
        (``_prompt_page_range``; on a prefix-cache engine, those a window
        before them, ``_cold_first_page``) are computed (later prompt
        tokens attend to them) but never spliced. The JAX engine writes
        them all into the trash page; here nothing is written there, so
        its positions stay invalid.

        The temporary cache spans the prompt's own pages, not
        ``max_prompt_len`` (the JAX engine pads to the maximum to keep one
        jit trace), so a short prompt costs only its own length. Attention
        is unchanged by that: real tokens never see padding (segment -1).
        A MoE layer is not: its expert capacity grows with the forward's
        token count, so it is sized from the JAX engine's padded length
        (``capacity_tokens``). Padding is routed after every real token,
        so it takes no capacity a real token would have had, and the real
        tokens keep exactly the choices the JAX engine keeps."""
        cfg = self.cfg
        S = row.shape[1]
        ar = torch.arange(S, dtype=torch.int32, device=self.device)[None]
        real = ar < length
        positions = torch.where(real, ar, 0)
        segments = torch.where(real, 0, -1).to(torch.int32)
        tmp = init_caches(cfg, 1, S, device=self.device, ring=False)
        h, tmp = forward_hidden(params, cfg, row, positions=positions,
                                segments=segments, caches=tmp, cache_offset=0,
                                capacity_tokens=self.n_prompt_pages
                                * self.page)
        logits = h[0, length - 1].float() @ self._w_head
        n_pp = dest_pages.shape[0]
        live = slice(S - n_pp * self.page, S)
        pools, t = caches["layers"]["kv"], tmp["layers"]["kv"]
        for name, shp in cache_streams(cfg):
            pools[name + "_pages"][:, dest_pages] = t[name][
                :, 0, live].reshape((cfg.num_layers, n_pp, self.page) + shp)
        pos_write = torch.where(real[0], ar[0], INVALID_POS)[live]
        pools["pos_pages"][:, dest_pages] = pos_write.reshape(n_pp, self.page)
        return logits

    def _decode_block(self):
        """D fused decode steps for every slot, reading the block's inputs
        from ``self._inputs`` (the captured step on the card). Per step j a
        slot is LIVE when the host scheduled it (``active``, ``valid[j]``)
        and its ``done`` flag is clear: it samples from the logits in hand
        (its draw keyed by its seed and response position t0 + j), sets
        ``done`` on EOS, writes its K/V at its flat slot, attends through
        the page table and computes the next logits; other slots decode
        PAD at pos 2^30 into the trash page. Fresh pages are invalidated
        first. ``logits`` and ``done`` are updated in place. Returns ((D,
        B) tokens, (D, B) raw logprobs, zeros when capture is off)."""
        x = self._inputs
        ptab = x["ptab"].to(torch.int32)
        self._invalidate(x["fresh"])
        valid, active = x["valid"].bool(), x["active"].bool()
        pos0, t0, seeds, wsl = x["pos0"], x["t0"], x["seeds"], x["wsl"]
        logits, done = self.logits, self.done
        toks, lps = [], []
        for j in range(self.drain):
            tok = _sample_token_rows(logits, seeds, t0 + j, self.temperature,
                                     self.top_p)
            live = active & ~done & valid[j]
            tok = torch.where(live, tok, self.pad_id)
            if self.capture_logprobs:
                lps.append(torch.where(
                    live, sampled_token_logprob(logits, tok), 0.0))
            done = done | (live & (tok == self.eos_id))
            seg = torch.where(live, 0, -1).to(torch.int32)
            h, _ = forward_hidden(
                self.params, self.cfg, tok[:, None],
                positions=torch.where(live, pos0 + j, INVALID_POS)[:, None],
                segments=seg[:, None], caches=self.caches,
                cache_offset=torch.where(live, wsl[j],
                                         TRASH_PAGE * self.page),
                page_table=ptab)
            logits = h[:, 0].float() @ self._w_head
            toks.append(tok)
        self.logits.copy_(logits)
        self.done.copy_(done)
        lps = (torch.stack(lps) if lps else
               torch.zeros((self.drain, self.B), dtype=torch.float32,
                           device=self.device))
        return torch.stack(toks), lps

    def _prefill_suffix(self, params, caches, tokens, positions, segs,
                        wslots, ptab, last: int) -> torch.Tensor:
        """Prefill ONLY a prompt's uncached suffix through the paged pool
        (radix warm admission): the (1, S) block writes into the group's
        private pages at its flat write slots while attending through the
        page table, which already lists the matched cached pages, so the
        suffix conditions on the shared prefix as a cold prefill would
        (the S > 1 paged route: on CUDA the paged-verify kernel, or the
        MLA kernel's verify wrapper over latent pages). Returns the last
        real token's logits (V,) f32."""
        h, _ = forward_hidden(params, self.cfg, tokens, positions=positions,
                              segments=segs, caches=caches,
                              cache_offset=wslots, page_table=ptab)
        return h[0, last].float() @ self._w_head

    def _verify_step(self):
        """One k+1-token spec verify forward for every slot, reading its
        inputs from ``self._inputs`` (the captured step on the card): the
        block (the unfed committed token + k drafts, or k drafts + a masked
        pad slot for fresh rows) writes into its speculative pages and
        attends through the pool; fresh rows use their prefill logits as
        p_0. Masked slots point at the trash page with pos 2^30. The
        commit walk runs on the device (``commit_block``), so the step
        returns one (B, k+1) commit buffer, its logprobs (zeros when
        capture is off) and (B,) counts."""
        x = self._inputs
        self._invalidate(x["fresh"])
        h, _ = forward_hidden(self.params, self.cfg, x["tokens"],
                              positions=x["positions"], segments=x["segs"],
                              caches=self.caches, cache_offset=x["wslots"],
                              page_table=x["ptab"].to(torch.int32))
        out = h.float() @ self._w_head                         # (B, k+1, V)
        p = torch.where(x["fresh_rows"].bool()[:, None, None],
                        torch.cat([self.logits[:, None], out[:, :-1]], dim=1),
                        out)
        draft = x["draft"]
        accept, alt, lp_d, lp_a = verify_block(
            p, draft, x["seeds"], x["rc"], temperature=self.temperature,
            top_p=self.top_p, capture=self.capture_logprobs)
        return commit_block(accept, alt, draft, lp_d, lp_a)

    def _input_shapes(self) -> Dict[str, tuple]:
        """The host-built inputs of the engine's step: the spec verify
        step's or the decode block's."""
        B, k = self.B, self.spec_k
        common = {"ptab": (B, self.n_max), "seeds": (B,),
                  "fresh": (self._n_fresh,)}
        if k:
            return {**common, "tokens": (B, k + 1), "positions": (B, k + 1),
                    "segs": (B, k + 1), "wslots": (B, k + 1),
                    "fresh_rows": (B,), "draft": (B, k), "rc": (B,)}
        D = self.drain
        return {**common, "wsl": (D, B), "valid": (D, B), "pos0": (B,),
                "active": (B,), "t0": (B,)}

    def _blank_inputs(self) -> Dict[str, np.ndarray]:
        """Inputs with every slot inactive (the graph's warm-up)."""
        fill = {"ptab": NULL_PAGE, "fresh": TRASH_PAGE, "pos0": INVALID_POS,
                "positions": INVALID_POS, "segs": -1,
                "tokens": self.pad_id, "wsl": TRASH_PAGE * self.page,
                "wslots": TRASH_PAGE * self.page}
        return {name: np.full(shape, fill.get(name, 0), np.int64)
                for name, shape in self._input_shapes().items()}

    def _run_step(self, fn, inputs: Dict[str, np.ndarray]):
        """Upload a step's inputs and run it: one graph replay on the card
        (outputs copied to the host, with their event), the step function
        itself on the CPU. Returns (outputs, event or None).

        The upload, the replay and its event must share the engine's
        stream: page reuse and the alternating host buffers are ordered by
        it alone."""
        if self.stream is not None and \
                torch.cuda.current_stream(self.device) != self.stream:
            raise RuntimeError("paged engine step issued off the engine's "
                               "stream")
        self._inputs.upload(inputs)
        if self._graph is None:
            return fn(), None
        self.graph_replays += 1
        return self._graph.replay()

    def _invalidate(self, pages: torch.Tensor) -> None:
        """Mark freshly allocated pages invalid — they may hold a previous
        sequence's stale (pos, kv) entries, which would otherwise pass the
        causal mask. ``pages`` is a device index tensor (a fill, not an
        indexed assignment: that would copy a host scalar, which a graph
        capture refuses)."""
        self.caches["layers"]["kv"]["pos_pages"].index_fill_(1, pages,
                                                             INVALID_POS)

    # -- host API -----------------------------------------------------------

    def set_params(self, params) -> dict:
        """Swap weights (iteration-boundary sync). Must be quiescent.
        Returns the tree the engine decodes with.

        On the CPU the engine holds ``params`` as they are. On the card the
        step is a CUDA graph, which reads fixed addresses: the first call
        clones the weights into engine-owned tensors, builds the page pool
        and captures the graph (``capture_ms``); every later call copies
        the new weights into the same tensors, which costs far less than a
        recapture (PERF.md). The clone is not an alias of the caller's tree
        because that tree may be one the caller goes on reading unchanged
        (the trainer's policy, the reference model). A caller that hands
        the weights over keeps the returned tree instead of its own, so the
        card holds them once (the weight-plane's flip does; the serve entry
        points drop theirs).

        The radix tree is dropped: its pages hold K/V written under the
        previous weights, and a warm admission under the new ones would
        attend to them (the JAX engine keeps its tree across a swap; the
        port departs from it here on purpose).

        On the card the copy runs on the engine's stream, after the
        caller's current stream (which must be the one that wrote
        ``params``, or one ordered after it), and the caller's stream
        waits for the copy before anything it issues next."""
        with self._mutex:
            if not self.sched.idle:
                raise RuntimeError("weight sync while rollouts are in flight "
                                   "breaks Proposition 1")
            if self.radix is not None and self.radix.cached_pages:
                # quiescent: the tree holds each cached page's only reference
                self.prefix_evicted_pages += self.alloc.release(
                    self.radix.pages())
                self.radix = RadixCache(self.page, self.alloc)
            # params were written on the caller's stream (the trainer's,
            # the weight-plane's unpack), which may free them once this
            # returns (the store drops a landed tree); the caller reads
            # the returned tree after the copy
            return on_engine_stream(self.stream, params,
                                    lambda: self._load_params(params))

    def _load_params(self, params) -> dict:
        """``set_params``' device work, on the engine's stream on the
        card: the copy into the engine's tensors, or at the first call the
        clone, the pool and the graph."""
        if self._graph is not None:
            if params is not self.params:
                _tree_copy(self.params, params)
                head = lm_head_weight(self.params["embed"], self.cfg)
                if head.data_ptr() != self._w_head.data_ptr():
                    self._w_head.copy_(head)     # its own f32 copy
            return self.params
        first = self.params is None
        self.params = (_tree_clone(params) if self.device.type == "cuda"
                       else params)
        # f32 LM head, as the JAX engine computes next-token logits: a
        # view of f32 weights, an f32 copy of bf16 ones (1.5 GB at
        # llama3.2-3b width)
        self._w_head = lm_head_weight(self.params["embed"],
                                      self.cfg).float()
        if not first:
            return self.params
        self.caches = init_paged_caches(self.cfg, self.P, self.page,
                                        device=self.device)
        self.logits = torch.zeros((self.B, self.cfg.vocab_size),
                                  dtype=torch.float32, device=self.device)
        self.done = torch.zeros((self.B,), dtype=torch.bool,
                                device=self.device)
        self._inputs = StaticInputs(self._input_shapes(), self.device)
        if self.device.type == "cuda":
            # the warm-up runs with every slot inactive (trash page,
            # pos 2^30); logits and done flags start clean after it
            self._inputs.upload(self._blank_inputs())
            self._graph = StepGraph(
                self._verify_step if self.spec_k else self._decode_block,
                self.device)
            self.warmup_steps += 1 if self.spec_k else self.drain
            self.logits.zero_()
            self.done.zero_()
        return self.params

    @property
    def capture_ms(self) -> Optional[dict]:
        """The graph's warm-up and capture host times (ms) and the launch
        tally each replay adds to ``kernels.LAUNCHES``, or None."""
        with self._mutex:
            if self._graph is None:
                return None
            return {"warmup_ms": self._graph.warmup_ms,
                    "capture_ms": self._graph.capture_ms,
                    "launch_tally": dict(self._graph.tally)}

    def time_replays(self):
        """Context manager: while it is open, every replay of the engine's
        graph records a pair of CUDA timing events around it; it yields
        the list of (start, end) pairs. Card only."""
        with self._mutex:
            if self._graph is None:
                raise RuntimeError("no captured graph: time_replays needs a "
                                   "CUDA engine after its first set_params")
            return self._graph.timing()

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
        _, n_pp = self._prompt_page_range(len(p))
        n_prompt = n_pp - self._cold_first_page(len(p))
        need = n_prompt + self._row_budget(max_new)
        avail = self.P - FIRST_PAGE
        if need > avail:
            raise ValueError(
                f"group can never be admitted: prompt of {len(p)} tokens "
                f"needs {n_prompt} pages + {self._row_budget(max_new)} "
                f"response pages per row = {need}, but the pool only ever "
                f"frees {avail} of its {self.P} pages")
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
        with self._mutex:   # RLock: the nested resets re-enter
            self.decode_steps = 0
            self.generated_tokens = 0
            self.prefills = 0
            self.warm_prefills = 0
            self.graph_replays = 0
            self.warmup_steps = 0
            self.reclaimed_pages = 0
            self.alloc.min_free = self.alloc.num_free
            self.reset_spec_stats()
            self.reset_prefix_stats()

    # -- engine step --------------------------------------------------------

    def _admission_gate(self, row: _Row) -> bool:
        """The freelist must cover this row's response pages (and, for a
        group's first row, its uncached prompt pages) ON TOP of every
        admitted row's outstanding credit.

        With the radix cache, matched pages cost nothing (they are
        retained, not allocated; the gate stashes the match on the group
        for ``_admit_row``, which runs right after it under the mutex), and
        a deficit first evicts idle cached pages."""
        g = row.group
        need = self._row_budget(g.max_new)
        mpages = []
        if g.prompt_pages is None:
            j0, n_pp = self._prompt_page_range(len(g.prompt))
            m = self._cold_first_page(len(g.prompt))
            if self.radix is not None:
                g.match = self._radix_match(g.prompt, j0)
                _, m, mpages = g.match
            need += n_pp - m
        free = self.alloc.num_free - self._outstanding
        if free < need and self.radix is not None:
            evicted = self.radix.evict(need - free, protect=set(mpages))
            self.prefix_evicted_pages += len(evicted)
            free = self.alloc.num_free - self._outstanding
        return free >= need

    def _warm_prefill(self, g: _Group, m: int, new: List[int],
                      jt: int, n_pp: int) -> None:
        """Prefill a radix-hit prompt's uncached tail (page indices
        ``m..n_pp-1``) into its freshly allocated private pages ``new``,
        attending through the matched cached pages via the group's page
        table (prompt pages jt..n_pp-1). The block is padded to a
        power-of-two page count (``_suffix_bucket``); pad slots are masked
        (segment -1) and write to the trash page, never into a live
        page."""
        page = self.page
        m_tok = m * page
        sfx = g.prompt[m_tok:]
        S = max(2, self._suffix_bucket(len(new)) * page)
        ar = np.arange(S)
        real = ar < len(sfx)
        toks = np.full((1, S), self.pad_id, np.int64)
        toks[0, : len(sfx)] = sfx
        pos = np.where(real, m_tok + ar, 0).astype(np.int32)[None]
        segs = np.where(real, 0, -1).astype(np.int32)[None]
        wsl = np.full((1, S), TRASH_PAGE * page, np.int64)
        for t in range(len(sfx)):
            a = m_tok + t
            wsl[0, t] = new[a // page - m] * page + a % page
        tab = np.zeros((1, self.n_max), np.int32)
        tab[0, : n_pp - jt] = g.prompt_pages
        # fresh pages may hold a previous sequence's stale (pos, kv)
        self._invalidate(to_device(np.asarray(new, np.int64), self.device))
        dev = self.device
        g.prompt_logits = self._prefill_suffix(
            self.params, self.caches, to_device(toks, dev),
            to_device(pos, dev), to_device(segs, dev), to_device(wsl, dev),
            to_device(tab, dev), len(sfx) - 1)

    def _admit_row(self, slot: int, row: _Row) -> None:
        g = row.group
        if g.prompt_pages is None:
            j0, n_pp = self._prompt_page_range(len(g.prompt))
            if g.match is None:
                jt = m = self._cold_first_page(len(g.prompt))
                mpages = []
            else:
                jt, m, mpages = g.match
            g.match = None
            if m > jt:
                # radix warm start: the matched cached pages join the
                # group's table with one reference per row; only the
                # uncached suffix is prefilled, into private pages
                self.alloc.retain(mpages, n=g.G)
                new = self.alloc.alloc(n_pp - m, refcount=g.G)
                assert new is not None, "admission gate let a row in " \
                    "without pages for its prompt suffix"
                g.prompt_pages = list(mpages) + new
                self.prefix_hit_pages += m - j0
                self.prefix_miss_pages += n_pp - m
                self._warm_prefill(g, m, new, jt, n_pp)
                self.warm_prefills += 1
            else:
                pages = self.alloc.alloc(n_pp - jt, refcount=g.G)
                assert pages is not None, \
                    "admission gate let a row in without pages for its prompt"
                g.prompt_pages = pages
                if self.radix is not None:
                    self.prefix_miss_pages += n_pp - j0
                row_arr = np.full((1, n_pp * self.page), self.pad_id,
                                  np.int64)
                row_arr[0, : len(g.prompt)] = g.prompt
                g.prompt_logits = self._prefill_group(
                    self.params, self.caches, to_device(row_arr, self.device),
                    len(g.prompt),
                    to_device(np.asarray(pages, np.int64), self.device))
                self.prefills += 1
            g.prompt_last = [min((j + 1) * self.page, len(g.prompt)) - 1
                             for j in range(jt, n_pp)]
            if self.radix is not None:
                # cache every COMPLETE prompt page, cold and warm alike
                # (insert skips spans already cached); a trailing partial
                # page is row-private and never enters the tree
                self.prefix_inserted_pages += self.radix.insert(
                    g.prompt, {j: g.prompt_pages[j - jt]
                               for j in range(jt, len(g.prompt) // self.page)})
        row.pages = []
        row.credit = self._row_budget(g.max_new)
        self._outstanding += row.credit
        row.live = deque((last, i, pid, True) for i, (last, pid)
                         in enumerate(zip(g.prompt_last, g.prompt_pages)))
        tab = np.zeros((self.n_max,), np.int32)        # NULL padding
        tab[: len(g.prompt_pages)] = g.prompt_pages
        self._ptab[slot] = tab
        # both land after any in-flight block in the engine's stream
        # order: that block saw this slot masked (its previous row's done
        # flag), the next one samples from the prompt logits, flag clear.
        # A fill, not ``done[slot] = False``: that copies a host scalar,
        # which waits for the stream to drain (a host sync in ``step``)
        self.logits[slot] = g.prompt_logits
        self.done[slot].fill_(False)
        row.toks = []
        row.lps = []
        row.fresh = True
        row.sched_t = 0
        row.seed = row_seed(g.key, row.idx)
        if self.spec_k:
            self._draft.start(slot, g.prompt)

    def _alloc_resp_page(self, slot: int, row: _Row, k: int) -> int:
        """Lazily take response page k (the write cursor, or a spec block's
        speculative write, just crossed a page boundary) out of the row's
        reserved credit. Allocation takes one credit, ``_rollback_row`` and
        ``_reclaim_row`` give one back. The row's last page returns the
        rest early (it is nonzero only under a window, whose budget the
        re-armed credit keeps full), except on a spec engine: there a
        speculative last page may be rolled back and taken again, so the
        credit stays symmetric until the row finishes."""
        g = row.group
        assert row.credit > 0, "page-credit invariant violated: row " \
            "admitted without budget for its next page"
        pages = self.alloc.alloc(1)
        assert pages is not None, "freelist below outstanding credit"
        row.credit -= 1
        self._outstanding -= 1
        pid = pages[0]
        row.pages.append(pid)
        ti = len(g.prompt_pages) + k
        self._ptab[slot, ti] = pid
        row.live.append((len(g.prompt) + (k + 1) * self.page - 1, ti, pid,
                         False))
        if not self.spec_k and len(row.pages) == self._n_total(g.max_new):
            self._outstanding -= row.credit
            row.credit = 0
        return pid

    def _rollback_row(self, slot: int, row: _Row, vf_rp: int) -> None:
        """Return speculative response pages holding ONLY rejected drafts
        to the freelist: after a commit that fed through response position
        ``vf_rp``, a page whose first slot is past it holds nothing a
        present or future query may see. Pop it off the row's table,
        release it and re-arm the row's credit (the exact inverse of
        ``_alloc_resp_page``). Partially valid pages stay: their stale
        tail slots are overwritten by the next verify block before any
        query reads them."""
        keep = vf_rp // self.page if vf_rp >= 0 else -1
        while len(row.pages) - 1 > keep:
            pid = row.pages.pop()
            _, ti, pid_live, is_prompt = row.live.pop()
            assert pid_live == pid and not is_prompt, \
                "rollback must pop the most recent speculative page"
            self._ptab[slot, ti] = NULL_PAGE
            self.alloc.release([pid])
            row.credit += 1
            self._outstanding += 1
            self.rolled_back_pages += 1

    def _reclaim_row(self, slot: int, row: _Row, q_pos: int) -> None:
        """Sliding-window page reclamation: positions only grow, so once
        ``q_pos - last_pos >= window`` no present or future query of this
        row can see the page. Drop it from the row's table and release the
        row's reference (a prompt page shared with rows that still see it
        stays resident through its refcount). A block still in flight may
        read the page; whoever reuses it writes on the engine's stream,
        after that block."""
        n_total = self._n_total(row.group.max_new)
        while row.live and q_pos - row.live[0][0] >= self.window:
            _, ti, pid, is_prompt = row.live.popleft()
            self._ptab[slot, ti] = NULL_PAGE
            self.reclaimed_pages += self.alloc.release([pid])
            if not is_prompt and len(row.pages) < n_total:
                # the freed page re-arms this row's credit: resident +
                # credit stays the admission-time budget
                row.credit += 1
                self._outstanding += 1

    def _finish_row(self, slot: int, row: _Row, step: int) -> None:
        g = row.group
        g.done_rows[row.idx] = np.asarray(row.toks, np.int32)
        if self.capture_logprobs:
            g.done_lps[row.idx] = np.asarray(row.lps, np.float32)
        g.finish_step = step
        # the row's live response pages + its reference on the live shared
        # prompt pages; a block in flight may still touch them, so whoever
        # reuses them writes on the engine's stream, after that block
        self.alloc.release([pid for _, _, pid, _ in row.live])
        row.live.clear()
        row.pages = []
        self._outstanding -= row.credit
        row.credit = 0
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
        """One admission pass + one D-step decode block for every slot (a
        spec engine verifies a k+1-token block instead). Returns False
        (and does nothing) when the engine is idle and no block is in
        flight.

        D 1 dispatches and drains synchronously, one drain per token step.
        D > 1 runs the one-deep pipeline: block n + 1 is built and
        dispatched BEFORE block n is drained, so block n's copy to the host
        overlaps block n + 1's build and compute. The dispatch assumes no
        row stopped inside the in-flight block; the device-resident
        ``done`` flags make that exact (a stopped row's extra steps run
        masked into the trash page), and the drain skips plan entries
        whose slot was re-assigned.

        On the card everything runs on the engine's stream, whichever
        thread calls (a no-op context on the CPU)."""
        with self._mutex, torch.cuda.stream(self.stream):
            # admit one row at a time: _admit_row consumes pages, and the
            # gate must see the freelist as it actually is for the NEXT row
            while True:
                admitted = self.sched.admit(self._admission_gate, limit=1)
                if not admitted:
                    break
                self._admit_row(*admitted[0])
            act = self.sched.active_slots()
            if self.spec_k:
                return self._spec_step(act) if act else False
            nxt = self._dispatch_block(act) if act else None
            if self.drain == 1:
                if nxt is not None:
                    self._drain_block(nxt)
                return nxt is not None
            prev, self._pending = self._pending, nxt
            if prev is not None:
                self._drain_block(prev)
            return nxt is not None or prev is not None

    def _dispatch_block(self, act: List[int]) -> Optional[_Block]:
        """Build one D-step decode block for the active slots and dispatch
        it: per slot, schedule up to D steps from its frontier
        (``row.sched_t``, not the committed length, which lags while a
        block is in flight), allocating the response pages those steps
        write and reclaiming out-of-window pages at the block's first query
        position. Page bookkeeping stays host-side; the device receives (D,
        B) write slots and valid masks, (B,) first positions, response
        positions and seeds, the fresh pages and the page table."""
        B, D, page = self.B, self.drain, self.page
        wsl = np.full((D, B), TRASH_PAGE * page, np.int64)
        valid = np.zeros((D, B), np.int64)
        pos0 = np.full((B,), INVALID_POS, np.int64)
        active = np.zeros((B,), np.int64)
        t0s = np.zeros((B,), np.int64)
        seeds = np.zeros((B,), np.int64)
        fresh = np.full((self._n_fresh,), TRASH_PAGE, np.int64)
        n_fresh = 0
        plan = []
        for s in act:
            row = self.sched.slot_req[s]
            g = row.group
            t0 = row.sched_t
            if t0 >= g.max_new:      # fully scheduled; awaiting its drain
                continue
            if self.window is not None:
                self._reclaim_row(s, row, len(g.prompt) + t0)
            n_row = min(D, g.max_new - t0)
            for t in range(t0, t0 + n_row):
                k = t // page
                if k == len(row.pages):       # crossed a page boundary
                    fresh[n_fresh] = self._alloc_resp_page(s, row, k)
                    n_fresh += 1
                wsl[t - t0, s] = row.pages[k] * page + t % page
                valid[t - t0, s] = 1
            pos0[s] = len(g.prompt) + t0
            active[s] = 1
            t0s[s] = t0
            seeds[s] = row.seed
            row.sched_t = t0 + n_row
            plan.append((s, row, t0, n_row))
        if not plan:
            return None
        base = self.sched.step
        self.sched.step += D
        out, ready = self._run_step(self._decode_block, {
            "ptab": self._ptab, "seeds": seeds, "fresh": fresh, "wsl": wsl,
            "valid": valid, "pos0": pos0, "active": active, "t0": t0s})
        self.decode_steps += D
        return _Block(plan=plan, base=base, out=out, ready=ready)

    def _drain_block(self, blk: _Block) -> None:
        """Commit one decode block into host bookkeeping — the ONLY
        device->host wait of the decode path, one frame below ``step``:
        one (D, B) token list (and logprob list) per block. A row that
        finished in an earlier block (its slot evicted or re-assigned)
        ran these steps masked and is skipped."""
        if blk.ready is not None:
            blk.ready.synchronize()
        toks = blk.out[0].tolist()
        lps = blk.out[1].tolist() if self.capture_logprobs else None
        for s, row, t0, n_row in blk.plan:
            if self.sched.slot_req[s] is not row:
                continue
            g = row.group
            assert len(row.toks) == t0, "drain out of order"
            for j in range(n_row):
                tv = toks[j][s]
                row.toks.append(tv)
                if lps is not None:
                    row.lps.append(lps[j][s])
                self.generated_tokens += 1
                if g.on_token is not None:
                    g.on_token(row.idx, tv)
                if tv == self.eos_id or len(row.toks) >= g.max_new:
                    self._finish_row(s, row, blk.base + j + 1)
                    break

    # -- spec plane ---------------------------------------------------------

    def _spec_step(self, act: List[int]) -> bool:
        """One spec-decode step under the mutex, ``act`` the live slots:
        draft k tokens per row, pre-allocate the block's speculative pages
        against the row credits, run ONE k+1-token verify forward whose
        device-side commit walk yields 1..k+1 tokens per row, then commit
        them and roll rejected speculative pages back (one frame below)."""
        B, k, page = self.B, self.spec_k, self.page
        drafts = self._draft.propose(act, k)
        tokens = np.full((B, k + 1), self.pad_id, np.int64)
        positions = np.full((B, k + 1), INVALID_POS, np.int32)
        segs = np.full((B, k + 1), -1, np.int32)
        wslots = np.full((B, k + 1), TRASH_PAGE * page, np.int64)
        fresh_m = np.zeros((B,), np.int64)
        seeds = np.zeros((B,), np.int64)
        rcs = np.zeros((B,), np.int64)
        fresh = np.full((self._n_fresh,), TRASH_PAGE, np.int64)
        n_fresh = 0
        for s in act:
            row = self.sched.slot_req[s]
            g = row.group
            rc = len(row.toks)
            if self.window is not None:
                # the block's first query: a fresh row's first draft, a
                # steady row's unfed last committed token
                self._reclaim_row(s, row, len(g.prompt) + rc
                                  - (0 if row.fresh else 1))
            delta = pack_row_block(tokens[s], positions[s], segs[s],
                                   row.fresh, drafts[s],
                                   row.toks[-1] if rc else self.pad_id,
                                   len(g.prompt) + rc, k)
            for j in range(k + 1):
                rp = rc + delta + j
                if segs[s, j] != 0 or rp >= g.max_new:
                    # a fresh row's pad slot, or a position past max_new:
                    # masked, written to the trash page
                    tokens[s, j] = self.pad_id
                    positions[s, j] = INVALID_POS
                    segs[s, j] = -1
                    continue
                while rp // page >= len(row.pages):
                    fresh[n_fresh] = self._alloc_resp_page(s, row,
                                                           len(row.pages))
                    n_fresh += 1
                wslots[s, j] = row.pages[rp // page] * page + rp % page
            fresh_m[s] = row.fresh
            seeds[s] = row.seed
            rcs[s] = rc
        out, ready = self._run_step(self._verify_step, {
            "ptab": self._ptab, "seeds": seeds, "fresh": fresh,
            "tokens": tokens, "positions": positions, "segs": segs,
            "wslots": wslots, "fresh_rows": fresh_m, "draft": drafts,
            "rc": rcs})
        self._commit_spec_rows(act, out, ready)
        return True

    def _drain_verify(self, out, ready):
        """Read one verify block's commit buffers back — the ONLY
        device->host wait of the spec path, one frame below the hot
        ``_spec_step``: one (B, k+1) token list (and logprob list) and the
        (B,) counts per step."""
        if ready is not None:
            ready.synchronize()
        ctoks, clps, count = out
        return (ctoks.tolist(),
                clps.tolist() if self.capture_logprobs else None,
                count.tolist())

    def _commit_spec_rows(self, act, out, ready) -> None:
        """Commit one verify block's rows on the host: cap each row at its
        budget and first EOS, stream and record the tokens, feed them to
        the draft, finish rows that stopped, and roll back speculative
        pages past every other row's fed frontier."""
        k = self.spec_k
        ctoks, clps, count = self._drain_verify(out, ready)
        step = self.sched.tick()
        self.decode_steps += 1
        for s in act:
            row = self.sched.slot_req[s]
            g = row.group
            rc = len(row.toks)
            n = count[s]
            self.spec_steps += 1
            self.drafted_tokens += k
            self.accepted_tokens += n - 1
            ct, cl, row_done = truncate_commit(
                ctoks[s][:n], clps[s][:n] if clps is not None else [0.0] * n,
                g.max_new - rc, self.eos_id)
            row.toks.extend(ct)
            if self.capture_logprobs:
                row.lps.extend(cl)
            if g.on_token is not None:
                for tv in ct:
                    g.on_token(row.idx, tv)
            self._draft.commit(s, ct)
            self.generated_tokens += len(ct)
            row.fresh = False
            if row_done:
                self._finish_row(s, row, step)
                self._draft.stop(s)
            else:
                # the cache now holds every committed token but the last
                self._rollback_row(s, row, len(row.toks) - 2)

    # -- standalone serving -------------------------------------------------

    def serve(self, params, prompts: List[np.ndarray], seed: int
              ) -> List[Completed]:
        """Serve independent requests (engine built with group_size=1;
        request i is its own group, keyed (seed, i)). Returns completions
        in completion order. Its device work is ``set_params``' and
        ``step``'s, each on the engine's stream."""
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
