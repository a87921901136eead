"""Draft providers of the spec-decode plane (the port of
``src/repro/spec/draft.py``): prompt lookup and the resident draft model.

Providers are deterministic (point-mass proposals), which is what makes
``spec/verify.py``'s accept-with-probability-p rule exact. The API is
slot-oriented, so every spec engine (the paged engine, the dense slot
engine and the SpecSampler) shares it:

    start(slot, prompt_ids)   row admitted into a decode slot
    commit(slot, tokens)      tokens the verify step committed for the slot
    stop(slot)                row finished / evicted
    propose(slots, k)         (num_slots, k) int32 drafts for active slots

Correctness never depends on draft quality: a bad draft is rejected and
costs only the verify block's extra positions.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.data.tokenizer import Tokenizer
from repro_torch.device import to_device
from repro_torch.models import forward_hidden, init, init_caches
from repro_torch.models.attention import INVALID_POS
from repro_torch.models.layers import lm_head_weight
from repro_torch.models.transformer import prefill_slot


class PromptLookupDraft:
    """Prompt-lookup n-gram drafting: propose the k tokens that followed
    the most recent earlier occurrence of the context's suffix (n-gram,
    longest first). No extra model: the lookup is host-side index
    arithmetic over the row's prompt and committed tokens."""

    def __init__(self, num_slots: int, *, ngram_max: int = 3,
                 ngram_min: int = 1):
        self.B = num_slots
        self.ngram_max = ngram_max
        self.ngram_min = max(1, ngram_min)
        self._ctx: List[Optional[list]] = [None] * num_slots

    def start(self, slot: int, prompt_ids) -> None:
        self._ctx[slot] = [int(t) for t in np.asarray(prompt_ids)]

    def commit(self, slot: int, tokens) -> None:
        self._ctx[slot].extend(int(t) for t in tokens)

    def stop(self, slot: int) -> None:
        self._ctx[slot] = None

    def _lookup(self, ctx: list, k: int) -> np.ndarray:
        arr = np.asarray(ctx, np.int32)
        L = len(arr)
        for n in range(min(self.ngram_max, L - 1), self.ngram_min - 1, -1):
            pat = arr[-n:]
            # windows over arr[:-1]: the suffix itself is excluded,
            # overlapping starts are not (the repetition-loop case)
            win = np.lib.stride_tricks.sliding_window_view(arr[:-1], n)
            hits = np.nonzero((win == pat).all(axis=1))[0]
            if len(hits):
                i = int(hits[-1])                  # most recent occurrence
                cand = arr[i + n: i + n + k]
                if len(cand):
                    out = np.empty((k,), np.int32)
                    out[: len(cand)] = cand
                    out[len(cand):] = cand[-1]     # pad with the tail token
                    return out
        return np.full((k,), arr[-1], np.int32)    # no match: repeat last

    def propose(self, slots, k: int) -> np.ndarray:
        out = np.zeros((self.B, k), np.int32)
        for s in slots:
            out[s] = self._lookup(self._ctx[s], k)
        return out


def draft_config(cfg: ModelConfig) -> ModelConfig:
    """The resident draft model's shape for ``cfg``: the same family and
    vocabulary (proposals live in the target's token space), half the
    depth. Its weights are initialised apart from the target's, as in the
    JAX package (a deployment would load a distilled checkpoint)."""
    return dataclasses.replace(cfg, name=cfg.name + "-draft",
                               num_layers=max(1, cfg.num_layers // 2))


class ModelDraft:
    """A small resident draft model, greedy-decoding k proposals a step.

    It free-runs over a dense cache of its own (one row a slot,
    ``ring=False`` so every position is addressable): ``propose`` first
    feeds the tokens committed since its last call (one right-padded (B,
    C) block at per-row offsets, a verify-shaped write through the
    contiguous verify wrappers), then decodes k greedy tokens from the
    committed frontier (the contiguous decode wrappers). Entries written
    past the frontier are never seen: slot index equals position, so a
    stale entry carries a position greater than any live query until the
    feed overwrites it. Its device work runs on the caller's stream (a
    rollout engine's). ``propose`` reads one (B, k) block back."""

    def __init__(self, cfg: ModelConfig, params, num_slots: int, *,
                 max_prompt_len: int, max_ctx: int,
                 pad_id: int = Tokenizer.PAD, device="cuda"):
        self.cfg = cfg
        self.params = params
        self.B = num_slots
        self.Lp = max_prompt_len
        self.L = max_ctx
        self.pad_id = pad_id
        self.device = torch.device(device)
        self.caches = init_caches(cfg, num_slots, max_ctx,
                                  device=self.device, ring=False)
        self.logits = torch.zeros((num_slots, cfg.vocab_size),
                                  dtype=torch.float32, device=self.device)
        self.off = np.zeros((num_slots,), np.int64)   # committed frontier
        self._pending: List[list] = [[] for _ in range(num_slots)]

    def _head(self) -> torch.Tensor:
        return lm_head_weight(self.params["embed"], self.cfg).float()

    # -- device cores -------------------------------------------------------

    def _prefill(self, slot: int, tokens: torch.Tensor, length: int) -> None:
        """tokens: (1, Lp) right-padded. Prefill a one-row cache of the
        draft's full length and splice the whole row into ``slot`` (its
        unwritten slots clear the previous occupant's entries)."""
        h = prefill_slot(self.params, self.cfg, self.caches, slot, tokens,
                         length, self.L, ring=False)
        self.logits[slot] = h.float() @ self._head()

    def _feed(self, tokens, counts, offsets, active) -> None:
        """Advance the committed frontier: tokens (B, C) right-padded
        commit blocks, counts (B,) their real lengths, written at the
        per-row offsets; rows with count 0 keep their logits."""
        B, C = tokens.shape
        ar = torch.arange(C, dtype=torch.int64, device=self.device)[None]
        real = active[:, None] & (ar < counts[:, None])
        positions = torch.where(real, offsets[:, None] + ar, INVALID_POS)
        h, _ = forward_hidden(self.params, self.cfg, tokens,
                              positions=positions,
                              segments=torch.where(real, 0, -1),
                              caches=self.caches, cache_offset=offsets)
        last = (counts - 1).clamp(min=0)
        h_last = h[torch.arange(B, device=self.device), last]
        new = h_last.float() @ self._head()
        keep = (active & (counts > 0))[:, None]
        self.logits = torch.where(keep, new, self.logits)

    def _kstep(self, offsets, active, k: int) -> torch.Tensor:
        """k greedy draft steps from the committed frontier: each step
        argmax-decodes one token a live slot and writes it past the
        frontier (speculative: masked until committed or overwritten);
        other slots decode PAD at offset 0. Returns (k, B) tokens; the
        carried logits and offsets are the proposal's own and are
        dropped."""
        logits, off = self.logits, offsets
        W = self._head()
        zero = torch.zeros_like(off)
        toks = []
        for _ in range(k):
            tok = torch.where(active, torch.argmax(logits, dim=-1),
                              self.pad_id)
            h, _ = forward_hidden(
                self.params, self.cfg, tok[:, None],
                positions=torch.where(active, off, INVALID_POS)[:, None],
                segments=torch.where(active, 0, -1)[:, None],
                caches=self.caches, cache_offset=torch.where(active, off,
                                                             zero))
            logits = h[:, 0].float() @ W
            off = off + active.to(off.dtype)
            toks.append(tok)
        return torch.stack(toks)

    # -- provider API -------------------------------------------------------

    def start(self, slot: int, prompt_ids) -> None:
        p = np.asarray(prompt_ids, np.int64)[-self.Lp:]
        row = np.full((1, self.Lp), self.pad_id, np.int64)
        row[0, : len(p)] = p
        self._prefill(slot, to_device(row, self.device), len(p))
        self.off[slot] = len(p)
        self._pending[slot] = []

    def commit(self, slot: int, tokens) -> None:
        self._pending[slot].extend(int(t) for t in tokens)

    def stop(self, slot: int) -> None:
        self._pending[slot] = []

    def propose(self, slots, k: int) -> np.ndarray:
        B = self.B
        # flush the buffered commits in one fixed-width multi-token feed
        C = max((len(p) for p in self._pending), default=0)
        if C:
            toks = np.full((B, C), self.pad_id, np.int64)
            counts = np.zeros((B,), np.int64)
            active = np.zeros((B,), bool)
            for s in range(B):
                n = len(self._pending[s])
                if n:
                    toks[s, :n] = self._pending[s]
                    counts[s] = n
                    active[s] = True
                    self._pending[s] = []
            self._feed(to_device(toks, self.device),
                       to_device(counts, self.device),
                       to_device(self.off.copy(), self.device),
                       to_device(active, self.device))
            self.off += counts
        active = np.zeros((B,), bool)
        active[list(slots)] = True
        toks = self._kstep(to_device(self.off.copy(), self.device),
                           to_device(active, self.device), k)
        # one readback a k-step block, not a draft token: (B, k)
        return toks.T.to(torch.int32).cpu().numpy()


def make_draft_provider(kind: str, cfg: ModelConfig, num_slots: int, *,
                        spec_k: int, ngram: int = 3, max_prompt_len: int,
                        max_new_tokens: int, pad_id: int = Tokenizer.PAD,
                        draft_params=None,
                        draft_cfg: Optional[ModelConfig] = None,
                        seed: int = 0, device="cuda"):
    """A draft provider for an engine with ``num_slots`` slots. ``kind``:
    "prompt_lookup" (no extra model) or "model" (a small resident draft
    model, ``draft_config(cfg)`` unless ``draft_cfg`` is given; its
    weights made by the port's ``init`` from ``seed ^ 0x5bec`` on
    ``device`` unless ``draft_params`` are given)."""
    if kind == "prompt_lookup":
        return PromptLookupDraft(num_slots, ngram_max=ngram)
    if kind == "model":
        dcfg = draft_cfg or draft_config(cfg)
        if draft_params is None:
            draft_params = init(dcfg, seed=seed ^ 0x5bec, device=device)
        max_ctx = max_prompt_len + max_new_tokens + spec_k + 2
        return ModelDraft(dcfg, draft_params, num_slots,
                          max_prompt_len=max_prompt_len, max_ctx=max_ctx,
                          pad_id=pad_id, device=device)
    raise KeyError(f"unknown draft provider {kind!r}; "
                   f"known: prompt_lookup, model")
