"""Rejection-sampling verification, the exactness core of the spec-decode
plane (the port of ``src/repro/spec/verify.py``).

One k+1-token target forward yields the k+1 conditional distributions
p_0..p_k. The draft providers are deterministic (a point-mass proposal q =
delta_d), so the speculative rejection rule specialises to:

  * accept d_{j+1} with probability p_j(d_{j+1});
  * on the first rejection at j, resample from p_j with d_{j+1} masked
    out, renormalised (the leftover distribution);
  * after a clean sweep of all k drafts, draw a bonus token from p_k.

Every committed token's marginal is exactly p_j, so rollouts stay draws
from the current policy (Proposition 1). Greedy decode (temperature <= 0)
is "accept iff the draft is the argmax", token-identical to non-spec
greedy decode.

Randomness is counter-based (``rl/rollout.py``): lane j of a row's verify
step draws its accept uniform and its Gumbel vector from the streams keyed
by (row seed, committed length rc, lane j), whatever it accepts, so a row's
tokens depend only on its key, prompt and step, never on the slot it runs
in (JAX keys the same draws by ``keys[rc]`` and the lane; the two
frameworks draw different numbers). Acceptance uses the filtered (temperature, top-p)
distribution; the returned logprobs are raw-distribution values, what
``capture_logprobs`` ships to the trainer.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import torch

from repro_torch.rl.rollout import (ACCEPT_LANE, RESAMPLE_LANE, _filter_logits,
                                    gumbel_noise, uniforms)


def verify_block(logits: torch.Tensor, draft: torch.Tensor,
                 seeds: Optional[torch.Tensor],
                 counter: Optional[torch.Tensor], *, temperature: float,
                 top_p: float, capture: bool = True):
    """Verify one k+1-token block for every row.

    logits: (B, k+1, V) raw target logits, logits[:, j] = p_j; draft: (B,
    k) deterministic proposals; ``seeds`` (B,) int64 row seeds and
    ``counter`` (B,) int64 committed lengths key the draws (an empty
    slot's outputs the caller ignores; both unused when greedy).

    Returns (accept (B, k) bool, alt (B, k+1) int32 — the leftover resample
    at j < k and the bonus draw at j = k, lp_draft (B, k) f32, lp_alt (B,
    k+1) f32 raw logprobs; zeros when ``capture`` is off)."""
    B, K1, V = logits.shape
    k = K1 - 1
    lg = logits.float()
    draft = draft.long()
    if temperature <= 0.0:
        alt = torch.argmax(lg, dim=-1)                         # (B, k+1)
        accept = draft == alt[:, :k]
    else:
        filt = _filter_logits(lg.reshape(B * K1, V), temperature,
                              top_p).reshape(B, K1, V)
        logp_f = torch.log_softmax(filt, dim=-1)
        lanes = torch.arange(K1, dtype=torch.int64, device=lg.device)
        s, c = seeds[:, None], counter[:, None]
        u = uniforms(s, c, ACCEPT_LANE + lanes, 1)[..., 0]        # (B, k+1)
        noise = gumbel_noise(s, c, RESAMPLE_LANE + lanes, V)       # (B, k+1, V)
        p_draft = torch.exp(torch.gather(logp_f[:, :k], -1,
                                         draft[..., None]))[..., 0]
        accept = u[:, :k] < p_draft
        # leftover: p_j with the draft masked out (the categorical
        # renormalises); the bonus position k is unmasked
        iota = torch.arange(V, device=lg.device)
        masked = filt.clone()
        masked[:, :k] = torch.where(iota == draft[..., None], -torch.inf,
                                    filt[:, :k])
        alt = torch.argmax(masked + noise, dim=-1)
    alt = alt.to(torch.int32)
    if not capture:
        return (accept, alt, lg.new_zeros((B, k)), lg.new_zeros((B, K1)))
    raw_lp = torch.log_softmax(lg, dim=-1)
    lp_draft = torch.gather(raw_lp[:, :k], -1, draft[..., None])[..., 0]
    lp_alt = torch.gather(raw_lp, -1, alt.long()[..., None])[..., 0]
    return accept, alt, lp_draft, lp_alt


def commit_block(accept, alt, draft, lp_draft, lp_alt):
    """The commit walk for every row at once, as tensor ops on the device:
    the leading run of accepted drafts plus one tail token, so the host
    reads one right-padded buffer per verify block.

    Returns (toks (B, k+1) int32, right-padded with 0; lps (B, k+1) f32;
    count (B,) int32 in 1..k+1). Row by row equal to ``assemble_commit``:
    the run length is n = sum(cumprod(accept)) and the tail is alt[n]."""
    B, k = draft.shape
    n = torch.cumprod(accept.to(torch.int32), dim=1).sum(dim=1)   # (B,)
    j = torch.arange(k + 1, device=alt.device)[None, :]
    n_col = n[:, None].long()
    tail_t = torch.gather(alt, 1, n_col)
    tail_l = torch.gather(lp_alt.float(), 1, n_col)
    toks = torch.where(j < n_col, torch.cat(
        [draft.to(torch.int32), alt.new_zeros((B, 1))], dim=1),
        torch.where(j == n_col, tail_t, 0))
    lps = torch.where(j < n_col, torch.cat(
        [lp_draft.float(), lp_alt.new_zeros((B, 1), dtype=torch.float32)],
        dim=1), torch.where(j == n_col, tail_l, 0.0))
    return toks.to(torch.int32), lps.to(torch.float32), \
        (n + 1).to(torch.int32)


def assemble_commit(accept, alt, draft, lp_draft,
                    lp_alt) -> Tuple[List[int], List[float]]:
    """Walk ONE row's verify outputs into its committed tokens on the host:
    the leading run of accepted drafts plus one tail token (1 to k+1)."""
    k = len(draft)
    n = 0
    while n < k and bool(accept[n]):
        n += 1
    toks = [int(t) for t in draft[:n]] + [int(alt[n])]
    lps = [float(x) for x in lp_draft[:n]] + [float(lp_alt[n])]
    return toks, lps
