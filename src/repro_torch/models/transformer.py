"""Decoder-only LM with GQA or MLA attention and a SwiGLU or MoE
feed-forward: parameter layout, init, block and whole-model forward, and
the cache constructors.

Parameters are a nested dict with the JAX package's layout: every layer
leaf is stacked with a leading axis (``layers``), beside ``embed`` and
``final_norm``. A MoE config's leading ``first_k_dense`` layers (DeepSeek-V2's
dense prelude, with ``dense_d_ff``) are stacked the same way under
``prelude``, where the JAX package keeps a list of them, and run before the
``layers`` body; the MoE layers hold ``moe`` in place of ``mlp``. The
forward loops over the layers in Python (PyTorch runs eagerly; there is no
trace whose size depth would set). Caches and the paged pool are one stack
over all ``num_layers``, the prelude's first, indexed by absolute layer.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig, require_engine_support
from repro_torch.models.attention import (DenseCacheBackend,
                                          PagedCacheBackend, attention)
from repro_torch.models.layers import (dense_init, dtype_of, embed, mlp,
                                       rmsnorm)
from repro_torch.models.moe import leaf_dtype, moe_ffn, moe_shapes


def _attn_shapes(cfg: ModelConfig) -> dict:
    """One layer's attention leaves: GQA's four projections, or MLA's
    (JAX ``init_mla``: no q-LoRA, the latent's norm, the up-projections
    w_uk / w_uv that absorbed decode folds into q and out)."""
    d, H = cfg.d_model, cfg.num_heads
    if cfg.use_mla:
        r, nd = cfg.kv_lora_rank, cfg.qk_nope_head_dim
        rd, vd = cfg.qk_rope_head_dim, cfg.v_head_dim
        return {"wq": (d, H * (nd + rd)), "w_dkv": (d, r), "w_kr": (d, rd),
                "ckv_norm": (r,), "w_uk": (r, H * nd), "w_uv": (r, H * vd),
                "wo": (H * vd, d)}
    Hkv, hd = cfg.num_kv_heads, cfg.head_dim
    return {"wq": (d, H * hd), "wk": (d, Hkv * hd), "wv": (d, Hkv * hd),
            "wo": (H * hd, d)}


def num_prelude(cfg: ModelConfig) -> int:
    """Leading dense layers before the MoE body (0 without MoE)."""
    return cfg.first_k_dense if cfg.is_moe else 0


def _block_shapes(cfg: ModelConfig, *, moe: bool, d_ff: int) -> dict:
    d = cfg.d_model
    b = {"ln1": {"scale": (d,)}, "attn": _attn_shapes(cfg),
         "ln2": {"scale": (d,)}}
    if moe:
        b["moe"] = moe_shapes(cfg)
    else:
        b["mlp"] = {"w_gate": (d, d_ff), "w_up": (d, d_ff),
                    "w_down": (d_ff, d)}
    return b


def _stack(n: int, shapes: dict) -> dict:
    return {k: _stack(n, v) if isinstance(v, dict) else (n,) + v
            for k, v in shapes.items()}


def param_shapes(cfg: ModelConfig) -> dict:
    """The parameter tree's shapes — one source for ``init_model`` and
    ``convert``'s checks."""
    d = cfg.d_model
    n_pre = num_prelude(cfg)
    embed_p = {"embedding": (cfg.vocab_size, d)}
    if not cfg.tie_embeddings:
        embed_p["lm_head"] = (d, cfg.vocab_size)
    shapes = {"embed": embed_p, "final_norm": {"scale": (d,)}}
    if n_pre:
        shapes["prelude"] = _stack(n_pre, _block_shapes(
            cfg, moe=False, d_ff=cfg.dense_d_ff or cfg.d_ff))
    shapes["layers"] = _stack(cfg.num_layers - n_pre, _block_shapes(
        cfg, moe=cfg.is_moe, d_ff=cfg.d_ff))
    return shapes


def init_model(cfg: ModelConfig, *, seed: int, device) -> dict:
    """Random weights made directly on ``device`` from one seeded
    generator: norms (MLA's ``ckv_norm`` too) are ones, the embedding
    N(0, 0.02), every projection a truncated-normal fan-in init (fan-in =
    the input axis, the second to last of a layer's leaf). The MoE router
    is f32 whatever ``param_dtype`` is. A stacked leaf is drawn one layer
    at a time into the leaf itself: a whole f32 draw of deepseek-v2-lite's
    stacked expert leaf would take 19 GB, twice."""
    dt = dtype_of(cfg.param_dtype)
    gen = torch.Generator(device=device).manual_seed(seed)

    def make(name: str, shape: tuple, stacked: bool):
        if name in ("scale", "ckv_norm"):
            return torch.ones(shape, dtype=dt, device=device)
        if name == "embedding":
            return (torch.randn(shape, generator=gen, device=device)
                    * 0.02).to(dt)
        leaf_dt = leaf_dtype(name, dt)
        if not stacked:
            return dense_init(shape, in_axis=len(shape) - 2, dtype=leaf_dt,
                              device=device, generator=gen)
        w = torch.empty(shape, dtype=leaf_dt, device=device)
        for i in range(shape[0]):
            w[i] = dense_init(shape[1:], in_axis=len(shape) - 3,
                              dtype=leaf_dt, device=device, generator=gen)
        return w

    def walk(tree: dict, stacked: bool) -> dict:
        return {k: walk(v, stacked or k in ("layers", "prelude"))
                if isinstance(v, dict) else make(k, v, stacked)
                for k, v in tree.items()}

    return walk(param_shapes(cfg), False)


def layer(tree, i: int) -> dict:
    """Layer ``i``'s views of a tree stacked over layers (or entry ``i`` of
    a per-layer list, the layout the grad step differentiates)."""
    if isinstance(tree, list):
        return tree[i]
    return {k: layer(v, i) if isinstance(v, dict) else v[i]
            for k, v in tree.items()}


def blocks(params: dict, cfg: ModelConfig):
    """Each layer's parameters in forward order: the dense prelude's, then
    the body's (the index into the caches is the position in this
    sequence)."""
    n_pre = num_prelude(cfg)
    for i in range(n_pre):
        yield layer(params["prelude"], i)
    for i in range(cfg.num_layers - n_pre):
        yield layer(params["layers"], i)


def _block_hidden(bp: dict, cfg: ModelConfig, x, positions, segments,
                  want_aux: bool):
    x, _, aux = block_forward(bp, cfg, x, positions, segments,
                              want_aux=want_aux)
    return x, aux


def block_forward(bp: dict, cfg: ModelConfig, x, positions, segments, *,
                  cache: Optional[dict] = None, cache_offset=None,
                  page_table=None, capacity_tokens: Optional[int] = None,
                  want_aux: bool = False):
    """Pre-norm attention (GQA or MLA) + SwiGLU or MoE block. Returns
    (x_out, cache, aux): ``aux`` is a MoE layer's load-balance loss when
    ``want_aux``, else None (a dense block has none). ``capacity_tokens``
    sizes a MoE layer's expert capacity (``moe.moe_ffn``)."""
    h = rmsnorm(bp["ln1"]["scale"], x, cfg.norm_eps)
    attn_out, kv = attention(
        bp["attn"], cfg, h, positions, segments,
        cache=None if cache is None else cache["kv"],
        cache_offset=cache_offset, page_table=page_table)
    x = x + attn_out
    h2 = rmsnorm(bp["ln2"]["scale"], x, cfg.norm_eps)
    aux = None
    if "moe" in bp:
        y, aux = moe_ffn(bp["moe"], cfg, h2, capacity_tokens=capacity_tokens,
                         want_aux=want_aux)
        x = x + y
    else:
        x = x + mlp(bp["mlp"], h2)
    return x, None if kv is None else {"kv": kv}, aux


def forward_hidden(params: dict, cfg: ModelConfig, tokens: torch.Tensor, *,
                   positions=None, segments=None, caches=None,
                   cache_offset=None, page_table=None,
                   capacity_tokens: Optional[int] = None,
                   want_aux: bool = False):
    """Token ids (B, S) -> final hidden states (B, S, d).

    ``caches`` (dense caches or the paged pool, stacked over layers) are
    written in place, every layer at ``cache_offset``: an int for a
    dense prefill (0) or a lock-step decode step, a (B,) tensor of
    per-row start offsets for the slot engines' decode and verify blocks
    on a dense cache, flat slot indices on the paged pool. A training forward (autograd recording,
    no caches) checkpoints each layer when ``cfg.remat``, as
    ``jax.checkpoint`` does in the JAX package: the backward recomputes the
    layer's forward instead of keeping its activations. MoE layers size
    their expert capacity from ``capacity_tokens`` when given, else from
    the call's B x S tokens. Returns (hidden, caches), and with
    ``want_aux`` (hidden, caches, aux): the MoE layers' load-balance
    losses summed in f32 from 0 in forward order, the prelude's first, as
    the JAX ``forward_hidden`` sums them (0 for a dense model)."""
    B, S = tokens.shape
    x = embed(params["embed"], tokens, dtype_of(cfg.compute_dtype))
    if positions is None:
        positions = torch.arange(S, dtype=torch.int32,
                                 device=tokens.device).expand(B, S)
    if segments is None:
        segments = torch.zeros((B, S), dtype=torch.int32, device=tokens.device)
    positions = positions.to(torch.int32).contiguous()
    segments = segments.to(torch.int32).contiguous()
    aux_total = torch.zeros((), dtype=torch.float32, device=tokens.device) \
        if want_aux else None
    remat = cfg.remat and caches is None and torch.is_grad_enabled()
    for i, bp in enumerate(blocks(params, cfg)):
        if remat:
            # the block draws no random numbers: no RNG state to keep
            x, aux = checkpoint(_block_hidden, bp, cfg, x, positions,
                                segments, want_aux, use_reentrant=False,
                                preserve_rng_state=False)
        else:
            x, _, aux = block_forward(
                bp, cfg, x, positions, segments,
                cache=None if caches is None else layer(caches["layers"], i),
                cache_offset=cache_offset, page_table=page_table,
                capacity_tokens=capacity_tokens, want_aux=want_aux)
        if aux is not None:
            aux_total = aux_total + aux
    h = rmsnorm(params["final_norm"]["scale"], x, cfg.norm_eps)
    return (h, caches, aux_total) if want_aux else (h, caches)


def _stacked(cfg: ModelConfig, one: dict) -> dict:
    return {"layers": {"kv": {k: v.expand((cfg.num_layers,) + v.shape)
                              .contiguous() for k, v in one.items()}}}


def init_caches(cfg: ModelConfig, batch: int, length: int, *, device,
                ring: bool = True, ring_slack: int = 0) -> dict:
    """Dense per-layer decode caches, stacked over layers. A
    sliding-window config gets the ring buffer sized to its window,
    ``min(length, window + ring_slack)`` slots (``ring=True``, the
    Sampler's); ``ring=False`` gives ``length`` slots whatever the window
    (the paged engine's prompt prefill: every prompt token's K/V is
    spliced into the pool; the window mask still applies in attention).
    ``ring_slack`` widens the ring beyond the window, as in JAX: a verify
    block writes up to k speculative tokens past the committed frontier,
    and on a ring of exactly the window those writes would evict entries
    the block's earlier queries still see; the dense spec engines pass
    k + 1, so every in-window entry stays resident for the whole block
    (the window mask itself is position-driven and unchanged)."""
    kv_len = (min(length, cfg.sliding_window + ring_slack)
              if cfg.sliding_window and ring else length)
    one = DenseCacheBackend(cfg, kv_len).init(
        batch, dtype_of(cfg.compute_dtype), device)
    return _stacked(cfg, one)


def prefill_slot(params: dict, cfg: ModelConfig, caches: dict, slot: int,
                 tokens: torch.Tensor, length: int, max_ctx: int, *,
                 ring: bool = True, ring_slack: int = 0) -> torch.Tensor:
    """Prefill one right-padded prompt row (``tokens`` (1, Lp), its first
    ``length`` real) into a one-row cache of ``max_ctx`` (``init_caches``'
    ``ring`` and ``ring_slack``) and splice the whole row into row
    ``slot`` of the dense pool ``caches``: its unwritten slots clear the
    previous occupant's entries. Returns the last prompt token's hidden
    state (d_model,)."""
    ar = torch.arange(tokens.shape[1], dtype=torch.int32,
                      device=tokens.device)[None]
    real = ar < length
    row = init_caches(cfg, 1, max_ctx, device=tokens.device, ring=ring,
                      ring_slack=ring_slack)
    h, row = forward_hidden(params, cfg, tokens,
                            positions=torch.where(real, ar, 0),
                            segments=torch.where(real, 0, -1),
                            caches=row, cache_offset=0)
    pool, one = caches["layers"]["kv"], row["layers"]["kv"]
    for name in pool:
        pool[name][:, slot] = one[name][:, 0]
    return h[0, length - 1]


def init_paged_caches(cfg: ModelConfig, num_pages: int, page_size: int, *,
                      device) -> dict:
    """Per-layer paged pools stacked over layers; the page table is shared
    across layers (every layer uses the same logical-to-physical map)."""
    require_engine_support(cfg, "paged")
    one = PagedCacheBackend(cfg, page_size).init(
        num_pages, dtype_of(cfg.compute_dtype), device)
    return _stacked(cfg, one)
