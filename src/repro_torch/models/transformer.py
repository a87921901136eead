"""Dense decoder-only LM: parameter layout, init, block and whole-model
forward, and the cache constructors.

Parameters are a nested dict with the JAX package's layout: every layer
leaf is stacked with a leading L axis (``layers``), beside ``embed`` and
``final_norm``. The forward loops over the L layers in Python (PyTorch
runs eagerly; there is no trace whose size depth would set).
"""
from __future__ import annotations

from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig, require_engine_support
from repro_torch.models.attention import (DenseCacheBackend,
                                          PagedCacheBackend, gqa_attention)
from repro_torch.models.layers import (dense_init, dtype_of, embed, mlp,
                                       rmsnorm)


def param_shapes(cfg: ModelConfig) -> dict:
    """The parameter tree's shapes — one source for ``init_model`` and
    ``convert``'s checks."""
    d, H, Hkv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    L, ff = cfg.num_layers, cfg.d_ff
    embed_p = {"embedding": (cfg.vocab_size, d)}
    if not cfg.tie_embeddings:
        embed_p["lm_head"] = (d, cfg.vocab_size)
    return {
        "embed": embed_p,
        "final_norm": {"scale": (d,)},
        "layers": {
            "ln1": {"scale": (L, d)},
            "attn": {"wq": (L, d, H * hd), "wk": (L, d, Hkv * hd),
                     "wv": (L, d, Hkv * hd), "wo": (L, H * hd, d)},
            "ln2": {"scale": (L, d)},
            "mlp": {"w_gate": (L, d, ff), "w_up": (L, d, ff),
                    "w_down": (L, ff, d)},
        },
    }


def init_model(cfg: ModelConfig, *, seed: int, device) -> dict:
    """Random weights made directly on ``device`` from one seeded
    generator: norms are ones, the embedding N(0, 0.02), every projection
    a truncated-normal fan-in init (fan-in = the input axis)."""
    dt = dtype_of(cfg.param_dtype)
    gen = torch.Generator(device=device).manual_seed(seed)

    def make(name: str, shape: tuple, stacked: bool):
        if name == "scale":
            return torch.ones(shape, dtype=dt, device=device)
        if name == "embedding":
            return (torch.randn(shape, generator=gen, device=device)
                    * 0.02).to(dt)
        return dense_init(shape, in_axis=1 if stacked else 0, dtype=dt,
                          device=device, generator=gen)

    def walk(tree: dict, stacked: bool) -> dict:
        return {k: walk(v, stacked or k == "layers") if isinstance(v, dict)
                else make(k, v, stacked) for k, v in tree.items()}

    return walk(param_shapes(cfg), False)


def layer(tree, i: int) -> dict:
    """Layer ``i``'s views of a tree stacked over layers (or entry ``i`` of
    a per-layer list, the layout the grad step differentiates)."""
    if isinstance(tree, list):
        return tree[i]
    return {k: layer(v, i) if isinstance(v, dict) else v[i]
            for k, v in tree.items()}


def _block_hidden(bp: dict, cfg: ModelConfig, x, positions, segments):
    return block_forward(bp, cfg, x, positions, segments)[0]


def block_forward(bp: dict, cfg: ModelConfig, x, positions, segments, *,
                  cache: Optional[dict] = None, cache_offset=None,
                  page_table=None):
    """Pre-norm attention + SwiGLU block. Returns (x_out, cache)."""
    h = rmsnorm(bp["ln1"]["scale"], x, cfg.norm_eps)
    attn_out, kv = gqa_attention(
        bp["attn"], cfg, h, positions, segments,
        cache=None if cache is None else cache["kv"],
        cache_offset=cache_offset, page_table=page_table)
    x = x + attn_out
    h2 = rmsnorm(bp["ln2"]["scale"], x, cfg.norm_eps)
    x = x + mlp(bp["mlp"], h2)
    return x, None if kv is None else {"kv": kv}


def forward_hidden(params: dict, cfg: ModelConfig, tokens: torch.Tensor, *,
                   positions=None, segments=None, caches=None,
                   cache_offset=None, page_table=None):
    """Token ids (B, S) -> final hidden states (B, S, d).

    ``caches`` (dense prefill caches or the paged pool, stacked over
    layers) are written in place. A training forward (autograd recording,
    no caches) checkpoints each layer when ``cfg.remat``, as
    ``jax.checkpoint`` does in the JAX package: the backward recomputes the
    layer's forward instead of keeping its activations. Returns (hidden,
    caches)."""
    B, S = tokens.shape
    x = embed(params["embed"], tokens, dtype_of(cfg.compute_dtype))
    if positions is None:
        positions = torch.arange(S, dtype=torch.int32,
                                 device=tokens.device).expand(B, S)
    if segments is None:
        segments = torch.zeros((B, S), dtype=torch.int32, device=tokens.device)
    positions = positions.to(torch.int32).contiguous()
    segments = segments.to(torch.int32).contiguous()
    if cfg.remat and caches is None and torch.is_grad_enabled():
        for i in range(cfg.num_layers):
            # the block draws no random numbers: no RNG state to keep
            x = checkpoint(_block_hidden, layer(params["layers"], i), cfg, x,
                           positions, segments, use_reentrant=False,
                           preserve_rng_state=False)
        return rmsnorm(params["final_norm"]["scale"], x, cfg.norm_eps), caches
    for i in range(cfg.num_layers):
        x, _ = block_forward(
            layer(params["layers"], i), cfg, x, positions, segments,
            cache=None if caches is None else layer(caches["layers"], i),
            cache_offset=cache_offset, page_table=page_table)
    return rmsnorm(params["final_norm"]["scale"], x, cfg.norm_eps), caches


def _stacked(cfg: ModelConfig, one: dict) -> dict:
    return {"layers": {"kv": {k: v.expand((cfg.num_layers,) + v.shape)
                              .contiguous() for k, v in one.items()}}}


def init_caches(cfg: ModelConfig, batch: int, length: int, *, device
                ) -> dict:
    """Dense per-layer caches of ``length`` slots, stacked over layers (the
    paged engine's prompt prefill runs over one and splices it into the
    pool; there is no ring buffer in the port)."""
    one = DenseCacheBackend(cfg, length).init(
        batch, dtype_of(cfg.compute_dtype), device)
    return _stacked(cfg, one)


def init_paged_caches(cfg: ModelConfig, num_pages: int, page_size: int, *,
                      device) -> dict:
    """Per-layer paged pools stacked over layers; the page table is shared
    across layers (every layer uses the same logical-to-physical map)."""
    require_engine_support(cfg, "paged")
    one = PagedCacheBackend(cfg, page_size).init(
        num_pages, dtype_of(cfg.compute_dtype), device)
    return _stacked(cfg, one)
