"""Top-k token-choice MoE with capacity-factor dropping (the port of the
JAX package's local path, ``_moe_ffn_local``).

Each token's router picks K of E experts; every expert takes at most C
(token, choice) pairs a forward, in token order (k fastest), and drops the
rest. The kept pairs are scattered into an (E, C, d) buffer, the experts
run as one batched SwiGLU over it, and the outputs are gathered back and
combined with the renormalised router weights; shared experts, where the
config has them, add a dense SwiGLU of every token.

Every shape here is fixed by the config and the token count T of the call
(never by the routing), and nothing is read back to the host: the paged
engine captures the decode block and the spec verify step, MoE layers
included, as CUDA graphs. The expert products are ``torch.bmm``, as the
JAX package leaves them to XLA outside any Pallas kernel.

C depends on T, so a token's output depends on the other tokens of its
forward wherever a choice is dropped; ``capacity_tokens`` lets a caller
that runs fewer tokens than the JAX engine does (the paged engine's
prompt prefill over the prompt's own pages) size C from the JAX T.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import mlp


def moe_shapes(cfg: ModelConfig) -> dict:
    """One layer's MoE leaves (the JAX ``init_moe``): the router (d, E),
    kept in f32 whatever the parameter dtype, the experts' (E, d, ff) /
    (E, ff, d) weights and the shared experts' SwiGLU of width
    ``num_shared_experts * moe_d_ff``."""
    d, E, ff = cfg.d_model, cfg.num_experts, cfg.moe_d_ff
    p = {"router": (d, E), "w_gate": (E, d, ff), "w_up": (E, d, ff),
         "w_down": (E, ff, d)}
    if cfg.num_shared_experts:
        sff = cfg.num_shared_experts * ff
        p["shared"] = {"w_gate": (d, sff), "w_up": (d, sff),
                       "w_down": (sff, d)}
    return p


def leaf_dtype(name: str, dtype: torch.dtype) -> torch.dtype:
    """The dtype of a parameter leaf named ``name`` in a tree of
    ``dtype``: the MoE router stays f32, as ``init_moe`` keeps it."""
    return torch.float32 if name == "router" else dtype


def capacity(num_tokens: int, cfg: ModelConfig) -> int:
    """Pairs each expert keeps a forward: ceil(T K / E x cf), padded up to
    a multiple of 8, at least 8."""
    c = math.ceil(num_tokens * cfg.num_experts_per_tok / cfg.num_experts
                  * cfg.capacity_factor)
    return max(8, ((c + 7) // 8) * 8)


def _route(params: dict, cfg: ModelConfig, xf: torch.Tensor,
           want_aux: bool):
    """xf: (T, d) -> (top_p (T, K) f32, top_i (T, K) int64, (me, ce) or
    None). The router runs in its own dtype (f32, as ``init_moe`` keeps
    it, whatever the activations'); top-K is a stable descending sort, so
    of equal probabilities the lower expert index comes first, as
    ``lax.top_k`` orders them (a zero router makes every row a tie)."""
    E, K = cfg.num_experts, cfg.num_experts_per_tok
    T = xf.shape[0]
    router = params["router"]
    probs = torch.softmax(xf.to(router.dtype) @ router, dim=-1)
    top_p, top_i = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_i = top_p[:, :K], top_i[:, :K]
    top_p = top_p / top_p.sum(-1, keepdim=True).clamp_min(1e-9)
    if not want_aux:
        return top_p, top_i, None
    # me carries the aux loss's gradient into the router; ce, a count, and
    # the sort's indices carry none, as jnp.bincount's and lax.top_k's
    me = probs.mean(dim=0)                                     # (E,)
    # a fixed-length count (bincount sizes its output from the data)
    ce = torch.zeros((E,), dtype=torch.float32, device=xf.device)
    ce.scatter_add_(0, top_i.reshape(-1),
                    torch.ones((T * K,), dtype=torch.float32,
                               device=xf.device))
    return top_p, top_i, (me, ce / (T * K))


def _dispatch_slots(top_i: torch.Tensor, E: int, C: int):
    """Rank of each (token, k) among its expert's choices, in row-major
    order (k fastest), from a stable argsort -> slot ids, E*C the overflow
    row; keep = rank < C."""
    T, K = top_i.shape
    choice = top_i.reshape(-1)
    sorted_choice, order = torch.sort(choice, stable=True)
    seg_start = torch.searchsorted(
        sorted_choice, torch.arange(E, device=choice.device))
    rank_sorted = (torch.arange(T * K, device=choice.device)
                   - seg_start[sorted_choice])
    rank = torch.empty_like(rank_sorted).scatter_(0, order, rank_sorted)
    rank = rank.reshape(T, K)
    keep = rank < C
    slot = torch.where(keep, top_i * C + rank, E * C)
    return slot, keep


def _scatter_tokens(xf: torch.Tensor, slot: torch.Tensor, keep: torch.Tensor,
                    E: int, C: int) -> torch.Tensor:
    """(T, d) tokens -> (E, C, d) dispatch buffer: every (token, choice)
    pair, zeroed where dropped, added into an (E*C + 1, d) buffer whose
    last row takes the overflow."""
    T, K = slot.shape
    d = xf.shape[1]
    src = (xf[:, None, :] * keep[:, :, None].to(xf.dtype)).reshape(T * K, d)
    buf = torch.zeros((E * C + 1, d), dtype=xf.dtype, device=xf.device)
    buf.index_add_(0, slot.reshape(-1), src)
    return buf[: E * C].reshape(E, C, d)


def _combine_tokens(y_e: torch.Tensor, slot: torch.Tensor,
                    keep: torch.Tensor, top_p: torch.Tensor) -> torch.Tensor:
    """(E, C, d) expert outputs -> (T, d) f32: each token's K outputs
    weighted by (top_p x keep) cast to the activation dtype, summed in
    f32 (a dropped choice reads the zero overflow row)."""
    E, C, d = y_e.shape
    T, K = slot.shape
    y_flat = torch.cat([y_e.reshape(E * C, d),
                        y_e.new_zeros((1, d))], dim=0)
    g = y_flat[slot.reshape(-1)].reshape(T, K, d)
    w = (top_p * keep).to(y_e.dtype)
    return (g.float() * w.float()[:, :, None]).sum(dim=1)


def _expert_ffn(params: dict, buf: torch.Tensor) -> torch.Tensor:
    """(E, C, d) -> (E, C, d) batched SwiGLU, SiLU in f32."""
    g = torch.bmm(buf, params["w_gate"])
    u = torch.bmm(buf, params["w_up"])
    h = torch.nn.functional.silu(g.float()).to(buf.dtype) * u
    return torch.bmm(h, params["w_down"])


def moe_ffn(params: dict, cfg: ModelConfig, x: torch.Tensor, *,
            capacity_tokens: Optional[int] = None, want_aux: bool = False):
    """x: (B, S, d) -> (y (B, S, d), aux loss or None). C is sized from
    ``capacity_tokens`` when given, else from the call's B x S tokens. The
    auxiliary load-balance loss (E x sum(me x ce) x coef) is computed only
    with ``want_aux`` (the grad step's policy forward); serving and the
    no-grad old and reference forwards never read it. Its gradient reaches
    the router through ``me``; the outputs' through ``top_p``, the sorted
    probabilities, whose indices, slots and keep mask carry none."""
    B, S, d = x.shape
    E = cfg.num_experts
    T = B * S
    C = capacity(T if capacity_tokens is None else capacity_tokens, cfg)
    xf = x.reshape(T, d)
    top_p, top_i, stats = _route(params, cfg, xf, want_aux)
    slot, keep = _dispatch_slots(top_i, E, C)
    buf = _scatter_tokens(xf, slot, keep, E, C)
    y = _combine_tokens(_expert_ffn(params, buf), slot, keep, top_p)
    if cfg.num_shared_experts:
        y = y + mlp(params["shared"], xf).float()
    aux = None
    if want_aux:
        me, ce = stats
        aux = cfg.router_aux_coef * E * torch.sum(me * ce)
    return y.to(x.dtype).reshape(B, S, d), aux
