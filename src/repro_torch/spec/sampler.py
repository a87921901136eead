"""The dense spec engines' shared step and the group-at-a-time
``SpecSampler`` (the port of ``src/repro/spec/sampler.py``), plus the
block-packing and truncation helpers every spec engine uses.

Per step each live row proposes k draft tokens (a host-side provider),
then ONE k+1-token verify forward yields the k+1 conditional target
distributions; ``spec/verify.py`` accepts a leading run of drafts and
draws one tail token, so a row commits 1 to k+1 tokens a forward. Greedy
decode is token-identical to the ``Sampler``; sampled decode draws
exactly from the target policy.

State between steps: the cache holds every committed token except the
last, which rides into the next verify block as its first fed token. A
freshly prefilled row instead holds its last-prompt logits in hand, and
its first block carries k drafts plus one masked pad slot — the same k+1
shape. Rejected speculative entries need no rollback on a dense cache:
slot index follows position, and every stale entry carries a position
past the committed frontier until the next block's writes cover it.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch import device as _device
from repro_torch.configs.base import ModelConfig, require_engine_support
from repro_torch.data.tokenizer import Tokenizer
from repro_torch.device import engine_stream, on_engine_stream, to_device
from repro_torch.models import forward_hidden, init_caches
from repro_torch.models.attention import INVALID_POS
from repro_torch.models.layers import lm_head_weight
from repro_torch.rl.rollout import Key, RolloutBatch, Sampler, row_seed
from repro_torch.spec.draft import make_draft_provider
from repro_torch.spec.verify import commit_block, verify_block


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


def dense_verify_step(cfg, temperature: float, top_p: float, capture: bool,
                      params, caches, W, tokens, positions, segs, offsets,
                      prev_logits, fresh, draft, seeds, rc):
    """One k+1-token verify forward against a dense (or ring) cache, the
    step of both dense spec engines (the SpecSampler and the slot
    engine's spec path). The block writes at the per-row ``offsets`` and
    attends through the contiguous verify wrappers; ``fresh`` rows use
    their prefill logits as p_0 (their block's last slot is a masked
    pad); steady rows' p_0..p_k all come from this forward. Draws are
    keyed by the row seeds ``seeds`` and committed lengths ``rc``. The
    accept/commit walk runs on the device (``commit_block``), so the step
    returns right-padded (B, k+1) commit buffers and (B,) counts: (toks,
    lps, count)."""
    h, _ = forward_hidden(params, cfg, tokens, positions=positions,
                          segments=segs, caches=caches, cache_offset=offsets)
    out = h.float() @ W                                       # (B, k+1, V)
    p = torch.where(fresh[:, None, None],
                    torch.cat([prev_logits[:, None], out[:, :-1]], dim=1),
                    out)
    accept, alt, lp_d, lp_a = verify_block(
        p, draft, seeds, rc, temperature=temperature, top_p=top_p,
        capture=capture)
    return commit_block(accept, alt, draft, lp_d, lp_a)


def upload_block(tokens, positions, segs, offs, fresh, draft, seeds, rc,
                 device) -> tuple:
    """One verify block's host arrays on ``device`` in ONE copy: (tokens,
    positions, segs, offsets, fresh, draft, seeds, rc) as device tensors
    (the slices of one int64 buffer)."""
    K1 = tokens.shape[1]
    cols = [tokens, positions, segs, offs[:, None], fresh[:, None], draft,
            seeds[:, None], rc[:, None]]
    buf = to_device(np.concatenate([np.asarray(c, np.int64) for c in cols],
                                   axis=1), device)
    out, at = [], 0
    for width in (K1, K1, K1, 1, 1, K1 - 1, 1, 1):
        out.append(buf[:, at:at + width])
        at += width
    tok, pos, seg, off, fr, dr, sd, c = out
    return (tok, pos.to(torch.int32), seg.to(torch.int32), off[:, 0],
            fr[:, 0].bool(), dr, sd[:, 0], c[:, 0])


class SpecSampler:
    """``generate``: B prompts, left-padded to ``max_prompt_len``, into B
    responses of up to ``max_new_tokens``, k+1 tokens per target forward
    (the drop-in spec counterpart of ``rl/rollout.py``'s ``Sampler``,
    with the spec knobs: ``spec_k``, ``draft`` ("prompt_lookup" or
    "model"), ``ngram``, ``draft_params``, ``draft_cfg``, ``seed``).

    Its prefill is the Sampler's, over a cache of ``Lp + T + k + 1``
    slots (a ring of ``window + k + 1`` under a sliding window). Each
    host step packs the live rows' blocks, runs ``dense_verify_step`` and
    reads the commit buffers back once (``_commit_rows``, one frame
    below ``generate``). Draws use the port's counter hash: row b of a
    call keyed ``key`` draws with ``row_seed(key, b)`` at its committed
    length, lanes ``ACCEPT_LANE + j`` / ``RESAMPLE_LANE + j``, as the
    paged spec engine draws row b of a group keyed ``key``.

    Runs on ``device`` (CUDA unless the caller asks for the CPU); on the
    card every kernel runs on the rollout engines' stream with the
    Sampler's event edges. Returns a ``RolloutBatch`` of device
    tensors."""

    def __init__(self, cfg: ModelConfig, max_prompt_len: int,
                 max_new_tokens: int, *, spec_k: int = 4,
                 draft: str = "prompt_lookup", ngram: int = 3,
                 draft_params=None, draft_cfg: Optional[ModelConfig] = None,
                 temperature: float = 1.0, top_p: float = 1.0,
                 eos_id: int = Tokenizer.EOS, pad_id: int = Tokenizer.PAD,
                 capture_logprobs: bool = True, seed: int = 0,
                 device="cuda"):
        require_engine_support(cfg, "spec", rollout_engine="group")
        if spec_k < 1:
            raise ValueError(f"spec_k must be >= 1, got {spec_k}")
        self.cfg = cfg
        self.Lp = self.max_prompt_len = max_prompt_len
        self.T = self.max_new_tokens = max_new_tokens
        self.k = spec_k
        self.temperature = temperature
        self.top_p = top_p
        self.eos_id = eos_id
        self.pad_id = pad_id
        self.capture_logprobs = capture_logprobs
        self.device = _device.resolve(device)
        self.stream = engine_stream(self.device)
        self._draft_kw = dict(kind=draft, cfg=cfg, spec_k=spec_k,
                              ngram=ngram, max_prompt_len=max_prompt_len,
                              max_new_tokens=max_new_tokens, pad_id=pad_id,
                              draft_params=draft_params,
                              draft_cfg=draft_cfg, seed=seed,
                              device=self.device)
        self._providers = {}           # batch size -> provider
        self.pad_prompts = Sampler.pad_prompts.__get__(self)
        self.reset_stats()

    # -- stats --------------------------------------------------------------

    def reset_stats(self) -> None:
        self.spec_steps = 0            # verify forwards x live rows
        self.drafted_tokens = 0
        self.accepted_tokens = 0       # drafts that survived verification
        self.committed_tokens = 0      # tokens actually emitted

    @property
    def acceptance_rate(self) -> float:
        return (self.accepted_tokens / self.drafted_tokens
                if self.drafted_tokens else 0.0)

    # -- host loop ----------------------------------------------------------

    def generate(self, params, prompts: list, key: Key) -> RolloutBatch:
        toks, lens = self.pad_prompts(prompts)
        seeds = np.asarray([row_seed(key, b) for b in range(len(prompts))],
                           np.int64)
        return on_engine_stream(
            self.stream, params,
            lambda: self._generate(params, prompts, toks, lens, seeds))

    def _prefill(self, params, W, toks, lens):
        """The Sampler's prefill of the left-padded prompts, over a cache
        of Lp + T + k + 1 slots (ring slack k + 1). Returns (caches,
        last-prompt-token logits (B, V) f32)."""
        cfg, dev = self.cfg, self.device
        B, Lp = toks.shape
        ids = to_device(toks, dev)
        lens_d = to_device(lens, dev)
        ar = torch.arange(Lp, device=dev)[None]
        pad = Lp - lens_d[:, None]
        real = ar >= pad
        caches = init_caches(cfg, B, Lp + self.T + self.k + 1, device=dev,
                             ring_slack=self.k + 1)
        h, caches = forward_hidden(params, cfg, ids,
                                   positions=torch.where(real, ar - pad, 0),
                                   segments=torch.where(real, 0, -1),
                                   caches=caches, cache_offset=0)
        return caches, h[:, -1].float() @ W

    def _generate(self, params, prompts, toks, lens, seeds) -> RolloutBatch:
        B = len(prompts)
        k, T, Lp = self.k, self.T, self.Lp
        W = lm_head_weight(params["embed"], self.cfg).float()
        caches, logits0 = self._prefill(params, W, toks, lens)
        if B not in self._providers:
            kw = dict(self._draft_kw)
            self._providers[B] = make_draft_provider(
                kw.pop("kind"), kw.pop("cfg"), B, **kw)
        provider = self._providers[B]
        for b, p in enumerate(prompts):
            provider.start(b, np.asarray(p, np.int64)[-Lp:])
        resp = [[] for _ in range(B)]
        lps = [[] for _ in range(B)]
        done = np.zeros((B,), bool)
        fresh = np.ones((B,), bool)
        while not done.all():
            active = [b for b in range(B) if not done[b]]
            draft = provider.propose(active, k)               # (B, k)
            tokens = np.full((B, k + 1), self.pad_id, np.int64)
            positions = np.full((B, k + 1), INVALID_POS, np.int64)
            segs = np.full((B, k + 1), -1, np.int64)
            offs = np.full((B,), Lp, np.int64)
            rc = np.zeros((B,), np.int64)
            for b in active:
                t = len(resp[b])
                delta = pack_row_block(tokens[b], positions[b], segs[b],
                                       fresh[b], draft[b],
                                       resp[b][-1] if resp[b] else 0,
                                       int(lens[b]) + t, k)
                offs[b] = Lp + t + delta
                rc[b] = t
            blk = upload_block(tokens, positions, segs, offs, fresh, draft,
                               seeds, rc, self.device)
            tok_d, pos_d, seg_d, off_d, fresh_d, draft_d, seed_d, rc_d = blk
            out = dense_verify_step(
                self.cfg, self.temperature, self.top_p,
                self.capture_logprobs, params, caches, W, tok_d, pos_d,
                seg_d, off_d, logits0, fresh_d, draft_d, seed_d, rc_d)
            self._commit_rows(active, out, resp, lps, done, fresh, provider)
        out = np.full((B, T), self.pad_id, np.int64)
        out_lp = np.zeros((B, T), np.float32)
        out_len = np.zeros((B,), np.int64)
        for b in range(B):
            n = len(resp[b])
            out[b, :n] = resp[b]
            out_lp[b, :n] = lps[b]
            out_len[b] = n
        dev = self.device
        return RolloutBatch(
            response_ids=to_device(out, dev).to(torch.int32),
            response_len=to_device(out_len, dev).to(torch.int32),
            response_logprobs=(to_device(out_lp, dev)
                               if self.capture_logprobs else None))

    def _commit_rows(self, active, out, resp, lps, done, fresh,
                     provider) -> None:
        """Read one verify block's commit buffers back and commit its rows
        — the host half of the loop body, one frame below the hot entry
        point: one (B, k+1) token list, its logprobs and the (B,)
        counts."""
        k, T = self.k, self.T
        ctoks, clps, count = drain_verify(out, self.capture_logprobs)
        for b in active:
            n = count[b]
            self.spec_steps += 1
            self.drafted_tokens += k
            self.accepted_tokens += n - 1
            ct, cl, row_done = truncate_commit(
                ctoks[b][:n], clps[b][:n] if clps is not None else [0.0] * n,
                T - len(resp[b]), self.eos_id)
            resp[b].extend(ct)
            lps[b].extend(cl)
            provider.commit(b, ct)
            self.committed_tokens += len(ct)
            fresh[b] = False
            if row_done:
                done[b] = True
                provider.stop(b)


def drain_verify(out, capture: bool) -> tuple:
    """One verify block's commit buffers as host lists: (tokens (B, k+1),
    logprobs (B, k+1) or None, counts (B,))."""
    ctoks, clps, count = out
    # one readback a verify block (the commit walk ran on the device)
    return (ctoks.tolist(), clps.tolist() if capture else None,
            count.tolist())
