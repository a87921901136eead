"""Draft providers of the spec-decode plane (the port of
``src/repro/spec/draft.py``, prompt lookup only).

Providers are deterministic (point-mass proposals), which is what makes
``spec/verify.py``'s accept-with-probability-p rule exact. The API is
slot-oriented:

    start(slot, prompt_ids)   row admitted into a decode slot
    commit(slot, tokens)      tokens the verify step committed for the slot
    stop(slot)                row finished / evicted
    propose(slots, k)         (num_slots, k) int32 drafts for active slots

Correctness never depends on draft quality: a bad draft is rejected and
costs only the verify block's extra positions. The resident draft model
(``kind="model"``) decodes over a dense cache of its own, which the port
does not have yet (ROADMAP Queue 1); asking for it raises.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np


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


def make_draft_provider(kind: str, num_slots: int):
    """A draft provider for an engine with ``num_slots`` slots. ``kind``:
    "prompt_lookup" (the port's provider) or "model" (not ported)."""
    if kind == "prompt_lookup":
        return PromptLookupDraft(num_slots)
    if kind == "model":
        raise ValueError(
            "a draft model needs a resident model decoding over a dense "
            "cache of its own, which is not ported to PyTorch yet "
            "(ROADMAP.md Queue 1); use the prompt-lookup draft")
    raise KeyError(f"unknown draft provider {kind!r}; "
                   f"known: prompt_lookup, model")
