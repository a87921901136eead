"""GQA attention and the KV-cache backends of the port.

Masking is driven by (position, segment) arrays, as in the JAX package:
causal ``kv_pos <= q_pos``, shared prompt ``kv_seg == 0 or kv_seg ==
q_seg``; padding uses seg -1 and invalid cache slots pos ``INVALID_POS``.

Which kernel runs is decided by the branch alone, never by a config flag:
a prefill or training forward (dense path) calls the SPA wrapper, a paged
decode step calls the paged-decode wrapper; each wrapper launches its CUDA
kernel for CUDA tensors and runs its plain version for CPU tensors.

Caches are updated IN PLACE (the JAX backends return new arrays): the
paged pool is the engine's largest allocation, and a copy per step would
double it.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.decode_attention import paged_decode_attention
from repro_torch.kernels.spa_attention import (allow_mask, chunked_attention,
                                               spa_attention)
from repro_torch.models.layers import apply_rope

INVALID_POS = 2 ** 30

__all__ = ["INVALID_POS", "allow_mask", "chunked_attention", "cache_streams",
           "DenseCacheBackend", "PagedCacheBackend", "gqa_attention"]


def cache_streams(cfg: ModelConfig) -> Tuple[Tuple[str, tuple], ...]:
    """What one cached token consists of: per-head K and V rows (the port
    runs the GQA family only; MLA latent streams come with MLA)."""
    return (("k", (cfg.num_kv_heads, cfg.head_dim)),
            ("v", (cfg.num_kv_heads, cfg.head_dim)))


def is_paged_cache(cache: dict) -> bool:
    return "pos_pages" in cache


class DenseCacheBackend:
    """Contiguous per-row cache of ``length`` slots (no ring buffer). The
    paged engine runs each prompt's prefill over one of these and splices
    its K/V into the page pool."""

    def __init__(self, cfg: ModelConfig, length: int):
        self.cfg = cfg
        self.L = length

    def init(self, batch: int, dtype: torch.dtype, device) -> dict:
        state = {n: torch.zeros((batch, self.L) + shp, dtype=dtype,
                                device=device)
                 for n, shp in cache_streams(self.cfg)}
        state["pos"] = torch.full((batch, self.L), INVALID_POS,
                                  dtype=torch.int32, device=device)
        state["seg"] = torch.full((batch, self.L), -2, dtype=torch.int32,
                                  device=device)
        return state

    def write_prefill(self, state: dict, vals: tuple, positions,
                      segments) -> dict:
        """Write S <= L prompt tokens at offset 0, in place."""
        S = positions.shape[1]
        if S > self.L:
            raise ValueError(f"prefill of {S} tokens exceeds the {self.L}-slot "
                             f"cache")
        for (n, _), val in zip(cache_streams(self.cfg), vals):
            state[n][:, :S] = val
        state["pos"][:, :S] = positions
        state["seg"][:, :S] = segments
        return state

    def read(self, state: dict) -> tuple:
        """-> (*streams, kv_pos, kv_seg), each full-length."""
        return tuple(state[n] for n, _ in cache_streams(self.cfg)) \
            + (state["pos"], state["seg"])


class PagedCacheBackend:
    """One physical page pool shared by every sequence on the engine,
    stitched into logical sequences by a per-slot page table; a GRPO
    group's rows list the same prompt pages."""

    def __init__(self, cfg: ModelConfig, page_size: int):
        self.cfg = cfg
        self.page = page_size

    def init(self, num_pages: int, dtype: torch.dtype, device) -> dict:
        state = {n + "_pages": torch.zeros((num_pages, self.page) + shp,
                                           dtype=dtype, device=device)
                 for n, shp in cache_streams(self.cfg)}
        state["pos_pages"] = torch.full((num_pages, self.page), INVALID_POS,
                                        dtype=torch.int32, device=device)
        return state

    def write_decode(self, state: dict, vals: tuple, positions,
                     cache_offset) -> dict:
        """In-place flat scatter of one token per row: ``cache_offset`` (B,)
        holds flat slot indices (page_id * page_size + slot). Engines point
        inactive rows at the trash page, so duplicate trash indices across
        rows are harmless garbage."""
        idx = cache_offset.long()
        for (n, shp), val in zip(cache_streams(self.cfg), vals):
            state[n + "_pages"].view((-1,) + shp)[idx] = val[:, 0]
        state["pos_pages"].view(-1)[idx] = positions[:, 0]
        return state


def _paged_gqa_decode(cfg: ModelConfig, q, k, v, positions, cache,
                      cache_offset, page_table):
    """One decode token per row against the paged pool: write the token's
    K/V in place, then flash-decode over each row's pages."""
    PagedCacheBackend(cfg, cache["pos_pages"].shape[1]).write_decode(
        cache, (k, v), positions, cache_offset)
    out = paged_decode_attention(q[:, 0], cache["k_pages"], cache["v_pages"],
                                 cache["pos_pages"], page_table,
                                 positions[:, 0], window=cfg.sliding_window)
    return out[:, None], cache


def gqa_attention(params, cfg: ModelConfig, x, positions, segments, *,
                  cache: Optional[dict] = None, cache_offset=None,
                  page_table=None):
    """x: (B, S, d). Prefill/training when ``cache`` is None or a dense
    cache filled from offset 0; one decode step when ``cache`` is a paged
    pool (with per-row flat write slots and a page table).

    Returns (out, cache)."""
    B, S, _ = x.shape
    H, Hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = (x @ params["wq"]).reshape(B, S, H, hd)
    k = (x @ params["wk"]).reshape(B, S, Hkv, hd)
    v = (x @ params["wv"]).reshape(B, S, Hkv, hd)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)

    if cache is not None and is_paged_cache(cache):
        if S != 1:
            raise ValueError(f"the paged pool takes one decode token per row "
                             f"(got S={S}); the multi-token verify block is "
                             f"not ported yet")
        out, cache = _paged_gqa_decode(cfg, q, k, v, positions, cache,
                                       cache_offset, page_table)
    else:
        if cache is None:
            kk, vv, kp, ks = k, v, positions, segments
        else:
            if not (cache_offset is None or (isinstance(cache_offset, int)
                                             and cache_offset == 0)):
                raise ValueError("a dense cache is filled from offset 0 "
                                 "(prefill); decode runs on the paged pool")
            be = DenseCacheBackend(cfg, cache["pos"].shape[1])
            kk, vv, kp, ks = be.read(be.write_prefill(cache, (k, v),
                                                      positions, segments))
        out = spa_attention(q, kk, vv, positions, kp, segments, ks,
                            window=cfg.sliding_window,
                            chunk_size=cfg.attn_chunk_size)
    out = out.reshape(B, S, H * hd) @ params["wo"]
    return out, cache
