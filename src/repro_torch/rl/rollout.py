"""Token sampling for the port's decode engines.

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
