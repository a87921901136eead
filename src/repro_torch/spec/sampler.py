"""Host-side helpers of the spec engines (the part of
``src/repro/spec/sampler.py`` the paged engine uses; the group-at-a-time
``SpecSampler`` waits with the ``Sampler`` engine, which is not ported).

State between steps: the cache holds every committed token except the
last, which rides into the next verify block as its first fed token. A
freshly prefilled row instead holds its last-prompt logits in hand, and
its first block carries k drafts plus one masked pad slot — the same k+1
shape.
"""
from __future__ import annotations

import numpy as np


def pack_row_block(tokens_row, pos_row, seg_row, fresh: bool, draft_row,
                   last_tok: int, pos_base: int, k: int) -> int:
    """Fill ONE row of the (k+1) verify-block arrays in place and return
    the row's cache-slot delta from its frontier: a fresh row packs [d_1..
    d_k, masked pad] starting AT the frontier (delta 0); a steady row
    packs [unfed last token, d_1..d_k] starting one before it (delta -1).
    ``pos_base`` is the frontier's position (prompt len + committed)."""
    if fresh:
        tokens_row[:k] = draft_row
        pos_row[:k] = pos_base + np.arange(k)
        seg_row[:k] = 0
        return 0
    tokens_row[0] = last_tok
    tokens_row[1:] = draft_row
    pos_row[:] = pos_base - 1 + np.arange(k + 1)
    seg_row[:] = 0
    return -1


def truncate_commit(ct, cl, remaining: int, eos_id: int):
    """Cap one row's committed tokens at its remaining budget and its
    first EOS (inclusive). Returns (tokens, logprobs, finished)."""
    ct, cl = ct[:remaining], cl[:remaining]
    if eos_id in ct:
        n = ct.index(eos_id) + 1
        ct, cl = ct[:n], cl[:n]
    done = (bool(ct) and ct[-1] == eos_id) or len(ct) >= remaining
    return ct, cl, done
