"""Token sampling for the port's decode engines.

Greedy decode is ``argmax``. Sampled decode is Gumbel-max: ``argmax(
filtered_logits + g)`` with ``g = -log(-log(u))``, ``u`` uniform, drawn
from one ``torch.Generator`` per request row seeded from (request key,
row). A row's t-th draw is therefore the t-th draw of its own generator:
its tokens depend on its key, prompt and step and on nothing else — not
on the slot it runs in or on which other requests share the batch (the
JAX engines get the same property from ``fold_in(key, rid)`` plus
``stepwise_keys``; the two frameworks draw different numbers).
"""
from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence, Union

import numpy as np
import torch

Key = Union[int, Sequence[int]]


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


def row_generator(key: Key, row: int, device) -> torch.Generator:
    """The sampling generator of row ``row`` of the request keyed ``key``
    (an int or a sequence of ints, e.g. (seed, request id))."""
    words = [key] if isinstance(key, (int, np.integer)) else list(key)
    seed = np.random.SeedSequence([int(w) for w in words] + [row]) \
        .generate_state(1, np.uint64)[0]
    return torch.Generator(device=device).manual_seed(int(seed))


def gumbel(n: int, generator: torch.Generator, device) -> torch.Tensor:
    tiny = torch.finfo(torch.float32).tiny
    u = torch.rand(n, generator=generator, device=device).clamp_(min=tiny)
    return -torch.log(-torch.log(u))


def _sample_token_rows(logits: torch.Tensor,
                       generators: List[Optional[torch.Generator]],
                       temperature: float, top_p: float) -> torch.Tensor:
    """Sample one token per slot. logits: (B, V); ``generators[b]`` is the
    generator of the row in slot b (None for an empty slot, whose token
    the caller masks). Returns (B,) int64."""
    logits = logits.float()
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1)
    logits = _filter_logits(logits, temperature, top_p)
    noise = torch.zeros_like(logits)
    for b, gen in enumerate(generators):
        if gen is not None:
            noise[b] = gumbel(logits.shape[-1], gen, logits.device)
    return torch.argmax(logits + noise, dim=-1)
