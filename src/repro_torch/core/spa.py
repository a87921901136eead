"""Shared-Prompt Attention packing (paper §4.3): the port's copy of the
numpy packers of ``src/repro/core/spa.py``.

A GRPO group's K responses share one prompt. We pack
    x = [ prompt[:-1],  (prompt[-1], r_1),  (prompt[-1], r_2), ... ]
with (paper's four modifications):
  (1) input construction — one row carries the shared prompt + K responses;
  (2) position indices    — every response restarts at |prompt| - 1;
  (3) attention mask      — segment ids drive the shared-prompt mask
                            (kv_seg == 0 OR kv_seg == q_seg, causal by pos);
  (4) loss                — only response-label positions contribute.

Exactness note (vs the paper's Fig. 4): each response segment *begins with a
copy of the last prompt token*. The hidden state at that copy predicts the
response's first token — without it, r_j[0] would have no loss term, because
the single shared last-prompt position can only carry one label. With it,
packed gradients equal the sum of per-sample gradients exactly
(tests/test_spa.py asserts allclose at fp32).

Per-token loss weights are 1/len(sample) so the packed loss reproduces
GRPO's per-sample token-mean regardless of how samples share rows.

Both packers also scatter rollout-captured ``response_logprobs`` (when the
group carries them) onto the label positions, producing
``MicroBatch.logp_behavior`` — the old-policy/behavior logprobs the grad
step consumes instead of recomputing (DESIGN.md §Tri-model-capture).
"""
from __future__ import annotations

import math
from typing import Sequence

import numpy as np

from repro_torch.core.queue import RolloutGroup
from repro_torch.data.tokenizer import Tokenizer
from repro_torch.rl.grpo import MicroBatch

PAD = Tokenizer.PAD


def _np(x):
    return np.asarray(x)


def pack_plain(groups: Sequence[RolloutGroup], advantages: Sequence[np.ndarray],
               max_prompt_len: int, max_response_len: int) -> MicroBatch:
    """One row per (prompt, response) sample — standard (non-SPA) layout.

    When every group carries rollout-captured ``response_logprobs``, they are
    scattered onto the label positions (the position predicting r[j] gets
    log p(r[j])) and the micro-batch gains ``logp_behavior`` — the trainer
    then skips the old-policy recompute (DESIGN.md §Tri-model-capture)."""
    rows_t, rows_y, rows_p, rows_s, rows_w, rows_a = [], [], [], [], [], []
    rows_lb = []
    capture = all(g.response_logprobs is not None for g in groups)
    S = max_prompt_len + max_response_len
    for g, adv in zip(groups, advantages):
        p = _np(g.prompt_ids)[:max_prompt_len]
        Lp = len(p)
        for j in range(g.response_ids.shape[0]):
            # repro: allow(host-sync): RolloutGroup fields are host numpy
            # arrays — same field names as the device RolloutBatch
            r = _np(g.response_ids)[j, : int(g.response_len[j])][:max_response_len]
            lr = len(r)
            toks = np.full((S,), PAD, np.int32)
            toks[:Lp] = p
            toks[Lp:Lp + lr] = r
            labels = np.full((S,), 0, np.int32)
            labels[:Lp + lr - 1] = toks[1:Lp + lr]
            pos = np.zeros((S,), np.int32)
            pos[:Lp + lr] = np.arange(Lp + lr)
            seg = np.full((S,), -1, np.int32)
            seg[:Lp + lr] = 0
            w = np.zeros((S,), np.float32)
            w[Lp - 1: Lp + lr - 1] = 1.0 / lr       # predicts r[0..lr-1]
            a = np.full((S,), float(adv[j]), np.float32)
            rows_t.append(toks); rows_y.append(labels); rows_p.append(pos)
            rows_s.append(seg); rows_w.append(w); rows_a.append(a)
            if capture:
                lb = np.zeros((S,), np.float32)
                lb[Lp - 1: Lp + lr - 1] = \
                    _np(g.response_logprobs)[j, :lr]  # same positions as w
                rows_lb.append(lb)
    n = len(rows_t)
    return MicroBatch(
        tokens=np.stack(rows_t), labels=np.stack(rows_y),
        positions=np.stack(rows_p), segments=np.stack(rows_s),
        loss_mask=np.stack(rows_w), advantages=np.stack(rows_a),
        n_samples=np.float32(n),
        logp_behavior=np.stack(rows_lb) if capture else None,
    )


def pack_spa(group: RolloutGroup, advantages: np.ndarray,
             max_prompt_len: int, max_response_len: int,
             responses_per_row: int) -> MicroBatch:
    """Pack one group into ceil(G/K) SPA rows of K responses each: the
    prompt block, then K slots of a fixed stride 1 + max_response_len.
    Padding positions carry pos=2^30-1 / seg=-1 and zero loss weight. (The
    JAX packer's ``align`` option, which rounds slots to the TPU tile size,
    is not ported: the CUDA kernel skips dead tiles exactly at any
    layout.)"""
    K = responses_per_row
    p = _np(group.prompt_ids)[:max_prompt_len]
    Lp = len(p)
    G = group.response_ids.shape[0]
    capture = group.response_logprobs is not None
    prompt_block = Lp - 1
    stride = 1 + max_response_len
    S = prompt_block + K * stride
    n_rows = math.ceil(G / K)
    rows = dict(t=[], y=[], pos=[], seg=[], w=[], a=[], lb=[])
    n_samples = 0
    PAD_POS = 2 ** 30 - 1
    for row_i in range(n_rows):
        toks = np.full((S,), PAD, np.int32)
        labels = np.zeros((S,), np.int32)
        pos = np.full((S,), PAD_POS, np.int32)
        seg = np.full((S,), -1, np.int32)
        w = np.zeros((S,), np.float32)
        a = np.zeros((S,), np.float32)
        lb = np.zeros((S,), np.float32)
        toks[:Lp - 1] = p[:-1]
        pos[:Lp - 1] = np.arange(Lp - 1)
        seg[:Lp - 1] = 0
        off = prompt_block
        for k in range(K):
            j = row_i * K + k
            if j >= G:
                break
            # repro: allow(host-sync): RolloutGroup fields are host numpy
            # arrays — same field names as the device RolloutBatch
            r = _np(group.response_ids)[j, : int(group.response_len[j])]
            r = r[:max_response_len]
            lr = len(r)
            sl = slice(off, off + 1 + lr)
            toks[sl] = np.concatenate([[p[-1]], r])
            pos[sl] = np.arange(Lp - 1, Lp + lr)     # restart at |prompt|-1
            seg[sl] = k + 1
            labels[off: off + lr] = r                # predict r[0..lr-1]
            w[off: off + lr] = 1.0 / lr
            a[off: off + 1 + lr] = float(advantages[j])
            if capture:                              # same positions as w
                lb[off: off + lr] = _np(group.response_logprobs)[j, :lr]
            n_samples += 1
            off += stride                            # fixed stride per slot
        rows["t"].append(toks); rows["y"].append(labels); rows["pos"].append(pos)
        rows["seg"].append(seg); rows["w"].append(w); rows["a"].append(a)
        rows["lb"].append(lb)
    return MicroBatch(
        tokens=np.stack(rows["t"]), labels=np.stack(rows["y"]),
        positions=np.stack(rows["pos"]), segments=np.stack(rows["seg"]),
        loss_mask=np.stack(rows["w"]), advantages=np.stack(rows["a"]),
        n_samples=np.float32(n_samples),
        logp_behavior=np.stack(rows["lb"]) if capture else None,
    )
