"""Token sampling for the port's decode engines, and the group-at-a-time
``Sampler`` engine.

Greedy decode is ``argmax``. Sampled decode is Gumbel-max: ``argmax(
filtered_logits + g)`` with ``g = -log(-log(u))``, ``u`` uniform in (0, 1).
The uniforms are counter-based: ``u`` for vocabulary index v of a row's
t-th response token is a fixed integer hash of (row seed, t, v), where the
row seed is a 64-bit word derived from (request key, row) (``row_seed``).
A draw is therefore a pure function of (key, row, t): a row's tokens
depend on its key, prompt and step and on nothing else — not on the slot
it runs in, on which other requests share the batch, or on how many steps
one device call runs (the JAX engines get the same property from
``fold_in(key, rid)`` plus ``stepwise_keys``; the two frameworks draw
different numbers). Being tensor ops with no generator state, the draw
runs inside a captured CUDA graph.

The hash works on 32-bit words held in int64 tensors, so every product
stays inside 64 bits and the integer words are the same on every device:
each key is folded into two 32-bit words by the ``lowbias32`` finalizer
(multipliers 0x7feb352d and 0x846ca68b), and the word of index v is
``mix(mix(v ^ k_lo) ^ k_hi)``. Its top 23 bits give ``u = (w + 0.5) *
2^-23``, exact in f32 and never 0 or 1.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Union

import numpy as np
import torch

from repro_torch import device as _device
from repro_torch.configs.base import require_engine_support
from repro_torch.data.tokenizer import Tokenizer
from repro_torch.device import engine_stream, on_engine_stream, to_device
from repro_torch.models import forward_hidden, init_caches
from repro_torch.models.layers import lm_head_weight

Key = Union[int, Sequence[int]]

_M32 = 0xFFFFFFFF
_MIX = (0x7FEB352D, 0x846CA68B)
_GOLDEN = 0x9E3779B9
# lanes: which draw of a (row, counter) pair a stream feeds
DECODE_LANE = 0                  # the decode step's Gumbel noise
ACCEPT_LANE = 1 << 16            # + j: spec verify, lane j's accept uniform
RESAMPLE_LANE = 2 << 16          # + j: spec verify, lane j's Gumbel noise


class RolloutBatch(NamedTuple):
    response_ids: torch.Tensor   # (B, max_new) int32, PAD after EOS
    response_len: torch.Tensor   # (B,) int32 (includes the EOS token)
    # (B, max_new) f32 log p(sampled id | context) under the UNFILTERED
    # model distribution; 0 past response_len; None when capture is off
    response_logprobs: Optional[torch.Tensor] = None


def _filter_logits(logits: torch.Tensor, temperature: float, top_p: float
                   ) -> torch.Tensor:
    """Temperature + nucleus filtering (row-independent, f32 in/out)."""
    logits = logits / temperature
    if top_p < 1.0:
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        cum = torch.cumsum(torch.softmax(sorted_logits, dim=-1), dim=-1)
        cutoff_idx = torch.sum(cum < top_p, dim=-1)   # first idx with cum >= p
        cutoff = torch.gather(sorted_logits, -1, cutoff_idx[:, None])
        logits = torch.where(logits < cutoff, -torch.inf, logits)
    return logits


def sampled_token_logprob(logits: torch.Tensor, tok: torch.Tensor
                          ) -> torch.Tensor:
    """log p(tok) under the RAW next-token distribution (no temperature /
    top-p). logits: (B, V); tok: (B,) int."""
    lp = torch.log_softmax(logits.float(), dim=-1)
    return torch.gather(lp, -1, tok.long()[:, None])[:, 0]


def row_seed(key: Key, row: int) -> int:
    """The sampling seed of row ``row`` of the request keyed ``key`` (an
    int or a sequence of ints, e.g. (seed, request id)): a 64-bit word, as
    a signed int64 value."""
    words = [key] if isinstance(key, (int, np.integer)) else list(key)
    seed = np.random.SeedSequence([int(w) for w in words] + [row]) \
        .generate_state(1, np.uint64)
    return int(seed.view(np.int64)[0])


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 for words x in [0, 2^32), in two 16-bit halves so
    no product leaves int64."""
    return (((((x >> 16) * c) & 0xFFFF) << 16) + (x & 0xFFFF) * c) & _M32


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """The lowbias32 finalizer on words in [0, 2^32): a bijection."""
    x = x ^ (x >> 16)
    x = _mul32(x, _MIX[0])
    x = x ^ (x >> 15)
    x = _mul32(x, _MIX[1])
    return x ^ (x >> 16)


def uniform_words(seed: torch.Tensor, counter: torch.Tensor, lane,
                  n: int) -> torch.Tensor:
    """The 32-bit words of the stream (seed, counter, lane) at indices
    0..n-1, as int64 in [0, 2^32). ``seed`` (int64 row seeds), ``counter``
    (int64) and ``lane`` (an int or int64 tensor) broadcast together to
    the stream shape S; returns S + (n,)."""
    lo = (seed & _M32)[..., None]
    hi = ((seed >> 32) & _M32)[..., None]
    # a Python int lane folds on the host: a device tensor made from a
    # host scalar would be a copy, which a graph capture refuses
    c = _mix32((counter & _M32) ^ _mix32(lane ^ _GOLDEN))[..., None]
    k_lo = _mix32(lo ^ c)
    k_hi = _mix32(hi ^ _mix32(k_lo))
    v = torch.arange(n, dtype=torch.int64, device=seed.device)
    return _mix32(_mix32(v ^ k_lo) ^ k_hi)


def uniforms(seed, counter, lane, n: int) -> torch.Tensor:
    """f32 uniforms in (0, 1) of the stream (seed, counter, lane)."""
    w = uniform_words(seed, counter, lane, n) >> 9
    return (w.to(torch.float32) + 0.5) * 2.0 ** -23


def gumbel_noise(seed, counter, lane, n: int) -> torch.Tensor:
    return -torch.log(-torch.log(uniforms(seed, counter, lane, n)))


def _sample_token_rows(logits: torch.Tensor, seeds: Optional[torch.Tensor],
                       counter: Optional[torch.Tensor], temperature: float,
                       top_p: float) -> torch.Tensor:
    """Sample one token per slot. logits: (B, V); ``seeds`` (B,) int64 row
    seeds and ``counter`` (B,) int64 response positions key each slot's
    draw (unused when greedy; an empty slot's token is masked by the
    caller). Returns (B,) int64."""
    logits = logits.float()
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1)
    logits = _filter_logits(logits, temperature, top_p)
    noise = gumbel_noise(seeds, counter, DECODE_LANE, logits.shape[-1])
    return torch.argmax(logits + noise, dim=-1)


class Sampler:
    """The group-at-a-time rollout engine (the port of the JAX
    ``Sampler``): ``generate`` turns B prompts, left-padded to
    ``max_prompt_len``, into B responses of ``max_new_tokens`` in lock
    step. One prefill of the B rows over a dense cache (a ring of the
    window's length under a sliding window), then exactly
    ``max_new_tokens`` steps: every row runs every step, a finished row
    emits PAD, and the loop never exits early. Each step samples from the
    logits in hand; every step but the last then runs one decode forward
    (one token a row through the contiguous decode kernel) for the next
    step's logits. The JAX Sampler also runs a last forward, whose logits
    nothing reads; the port leaves it out, so a call runs
    ``max_new_tokens - 1`` decode forwards.

    Draws are the port's counter hash: row b of a call keyed ``key``
    samples its t-th token with ``row_seed(key, b)`` at counter t (lane
    ``DECODE_LANE``), as the paged engine samples row b of a group keyed
    ``key``; so with the same key, dtype and weights a row's sampled
    tokens are the paged engine's (MoE off: a MoE layer's capacity
    follows each forward's token count, which the two engines size
    differently). Captured logprobs are under the unfiltered
    distribution; ``response_len`` is the index of the first EOS plus one,
    else ``max_new_tokens``.

    Runs on ``device`` (CUDA unless the caller asks for the CPU); on the
    card every kernel runs on the rollout engines' stream
    (``device.engine_stream``): it waits for the caller's stream before
    it reads the weights, keeps every tree leaf and input it reads from
    reuse until its kernels have run (``record_stream``: a store may drop
    its last reference to a tree mid-call, at an off-policy flip), and
    the caller's stream waits for the batch before it reads it. The
    T-step loop reads nothing back to the host; ``generate`` returns
    device tensors."""

    def __init__(self, cfg, max_prompt_len: int, max_new_tokens: int,
                 temperature: float = 1.0, top_p: float = 1.0,
                 eos_id: int = Tokenizer.EOS, pad_id: int = Tokenizer.PAD,
                 capture_logprobs: bool = True, *, device="cuda"):
        require_engine_support(cfg, "group")
        self.cfg = cfg
        self.max_prompt_len = max_prompt_len
        self.max_new_tokens = max_new_tokens
        self.temperature = temperature
        self.top_p = top_p
        self.eos_id = eos_id
        self.pad_id = pad_id
        self.capture_logprobs = capture_logprobs
        self.device = _device.resolve(device)
        self.stream = engine_stream(self.device)

    # -- host-side helpers ---------------------------------------------------
    def pad_prompts(self, prompts: list) -> tuple:
        """list of 1-D int arrays -> (B, Lp) left-padded int64 ids + (B,)
        lengths, host arrays: each prompt keeps its last ``Lp`` tokens."""
        Lp = self.max_prompt_len
        out = np.full((len(prompts), Lp), self.pad_id, np.int64)
        lens = np.zeros((len(prompts),), np.int64)
        for i, p in enumerate(prompts):
            p = np.asarray(p, np.int64)[-Lp:]
            if len(p) == 0:
                raise ValueError("empty prompt")
            out[i, Lp - len(p):] = p
            lens[i] = len(p)
        return out, lens

    def generate(self, params, prompts: list, key: Key) -> RolloutBatch:
        toks, lens = self.pad_prompts(prompts)
        seeds = np.asarray([row_seed(key, b) for b in range(len(prompts))],
                           np.int64)
        return on_engine_stream(
            self.stream, params,
            lambda: self._generate(params, toks, lens, seeds))

    # -- device core ---------------------------------------------------------
    def _generate(self, params, toks, lens, seeds) -> RolloutBatch:
        cfg = self.cfg
        B, Lp = toks.shape
        T = self.max_new_tokens
        dev = self.device
        W = lm_head_weight(params["embed"], cfg).float()
        ids = to_device(toks, dev)
        lens_d = to_device(lens, dev)
        seeds_d = to_device(seeds, dev)
        ar = torch.arange(Lp, device=dev)[None]
        pad = Lp - lens_d[:, None]
        real = ar >= pad
        positions = torch.where(real, ar - pad, 0).to(torch.int32)
        segments = torch.where(real, 0, -1).to(torch.int32)
        caches = init_caches(cfg, B, Lp + T, device=dev)
        h, caches = forward_hidden(params, cfg, ids, positions=positions,
                                   segments=segments, caches=caches,
                                   cache_offset=0)
        logits = h[:, -1].float() @ W
        done = torch.zeros((B,), dtype=torch.bool, device=dev)
        pos = lens_d.to(torch.int32)
        step_ids = torch.arange(T, dtype=torch.int64, device=dev)
        zeros = torch.zeros((B, 1), dtype=torch.int32, device=dev)
        toks_out, lps_out = [], []
        for t in range(T):
            tok = _sample_token_rows(logits, seeds_d,
                                     step_ids[t].expand(B),
                                     self.temperature, self.top_p)
            tok = torch.where(done, self.pad_id, tok)
            if self.capture_logprobs:
                lps_out.append(torch.where(
                    done, 0.0, sampled_token_logprob(logits, tok)))
            done = done | (tok == self.eos_id)
            toks_out.append(tok)
            if t + 1 < T:
                h, caches = forward_hidden(
                    params, cfg, tok[:, None], positions=pos[:, None],
                    segments=zeros, caches=caches, cache_offset=Lp + t)
                logits = h[:, 0].float() @ W
            pos = pos + 1
        resp = torch.stack(toks_out, dim=1).to(torch.int32)
        is_eos = resp == self.eos_id
        first = torch.argmax(is_eos.to(torch.int32), dim=1)
        resp_len = torch.where(is_eos.any(dim=1), first + 1,
                               T).to(torch.int32)
        lps = torch.stack(lps_out, dim=1) if self.capture_logprobs else None
        return RolloutBatch(response_ids=resp, response_len=resp_len,
                            response_logprobs=lps)
