"""GQA and MLA attention and the KV-cache backends of the port.

Masking is driven by (position, segment) arrays, as in the JAX package:
causal ``kv_pos <= q_pos``, shared prompt ``kv_seg == 0 or kv_seg ==
q_seg``; padding uses seg -1 and invalid cache slots pos ``INVALID_POS``.

Which kernel runs is decided by the branch alone, never by a config flag:
a prefill or training forward (dense path) calls the SPA wrapper; one
token per row against a dense (or ring) cache, the dense engines' decode
step, calls the contiguous decode wrapper; S > 1 tokens per row against
a dense cache at per-row (B,) offsets (the dense spec engines' verify
block, the draft model's feed; JAX's ``_is_verify``) the contiguous verify
wrapper; against the paged pool, one token per row calls the paged-decode
wrapper and S > 1 tokens per row (the spec verify block, the radix cache's
suffix prefill) the paged-verify wrapper. Each wrapper launches its CUDA
kernel for CUDA tensors and runs its plain version for CPU tensors.

MLA (DeepSeek-V2) caches one latent row per token, ``(ckv, kr)``, instead
of per-head K/V. Against the paged pool it attends in the latent space
(absorbed: w_uk folded into q, w_uv applied to the latent output) through
the paged MLA wrappers, S == 1 through ``paged_mla_decode_attention`` and
S > 1 (the spec verify block, the radix cache's suffix prefill) through
``paged_mla_verify_attention``; against a dense (or ring) latent cache,
one token per row through ``mla_decode_attention`` and a verify block
through ``mla_verify_attention``, the same kernel on a one-page-per-row
view. Prefill and training expand per-head K/V
from the latent and run plain PyTorch attention, as the JAX package does
(``_mla_expanded``); training differentiates it with autograd.

Caches are updated IN PLACE (the JAX backends return new arrays): the
paged pool is the engine's largest allocation, and a copy per step would
double it.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.decode_attention import (decode_attention,
                                                  mla_decode_attention,
                                                  mla_verify_attention,
                                                  paged_decode_attention,
                                                  paged_mla_decode_attention,
                                                  paged_mla_verify_attention,
                                                  paged_verify_attention,
                                                  verify_attention)
from repro_torch.kernels.spa_attention import (allow_mask, chunked_attention,
                                               spa_attention)
from repro_torch.models.layers import apply_rope, rmsnorm

INVALID_POS = 2 ** 30

__all__ = ["INVALID_POS", "allow_mask", "chunked_attention", "cache_streams",
           "DenseCacheBackend", "PagedCacheBackend", "gqa_attention",
           "mla_attention", "attention"]


def cache_streams(cfg: ModelConfig) -> Tuple[Tuple[str, tuple], ...]:
    """What one cached token consists of: per-head K and V rows (GQA), or
    MLA's compressed latent and shared rope key; the layout backends below
    are agnostic to which."""
    if cfg.use_mla:
        return (("ckv", (cfg.kv_lora_rank,)),
                ("kr", (cfg.qk_rope_head_dim,)))
    return (("k", (cfg.num_kv_heads, cfg.head_dim)),
            ("v", (cfg.num_kv_heads, cfg.head_dim)))


def is_paged_cache(cache: dict) -> bool:
    return "pos_pages" in cache


class DenseCacheBackend:
    """Contiguous per-row cache of ``length`` slots; the sliding-window
    RING buffer when ``cfg.sliding_window`` is set (write index ``offset
    % length``; a prefill of S > length tokens ring-writes its trailing
    window, token i in slot ``i % length``), as the JAX backend. The dense
    engines (the group Sampler, the SpecSampler, the slot engine and the
    draft model) decode over one; the paged engine runs each prompt's
    prefill over one (never a ring) and splices its K/V into the page
    pool.

    A padding token (segment -1) is stored at pos ``INVALID_POS``: the
    decode kernels mask by position alone, where the JAX package masks
    padding by segment (``allow_mask``). For the segment-0 queries that
    decode against the cache the two masks agree. Segments are stored as
    given, and a prefill attends before the write, with the positions it
    was given."""

    def __init__(self, cfg: ModelConfig, length: int):
        self.cfg = cfg
        self.L = length
        self.ring = cfg.sliding_window is not None

    def init(self, batch: int, dtype: torch.dtype, device) -> dict:
        state = {n: torch.zeros((batch, self.L) + shp, dtype=dtype,
                                device=device)
                 for n, shp in cache_streams(self.cfg)}
        state["pos"] = torch.full((batch, self.L), INVALID_POS,
                                  dtype=torch.int32, device=device)
        state["seg"] = torch.full((batch, self.L), -2, dtype=torch.int32,
                                  device=device)
        return state

    def _store(self, state: dict, start: int, vals: tuple, positions,
               segments) -> dict:
        stop = start + positions.shape[1]
        for (n, _), val in zip(cache_streams(self.cfg), vals):
            state[n][:, start:stop] = val
        state["pos"][:, start:stop] = torch.where(segments < 0, INVALID_POS,
                                                  positions)
        state["seg"][:, start:stop] = segments
        return state

    def write_decode(self, state: dict, vals: tuple, positions, segments,
                     cache_offset) -> dict:
        """In-place write of S tokens per row (vals (B, S, *shp)): at the
        scalar (int) offset of a lock-step engine, row b's token j lands in
        slot ``cache_offset + j``; at the per-row (B,) int tensor of start
        offsets of a slot engine, in slot ``cache_offset[b] + j`` (one
        indexed write per stream). Both wrap mod L on a ring. A scalar
        write past the end of a plain cache raises; per-row offsets are not
        read back (that would wait for the device), so the engines keep
        them in range, as JAX's scatter needs too. An idle slot of the
        slot engine writes its pad at offset 0, over whatever its finished
        row left there, as in JAX: no live row reads that slot again
        before a prefill rewrites it."""
        if isinstance(cache_offset, torch.Tensor):
            if cache_offset.dim() != 1:
                raise TypeError("per-row write offsets must be a (B,) "
                                "tensor")
            return self._store_rows(state, cache_offset, vals, positions,
                                    segments)
        if not isinstance(cache_offset, int):
            raise TypeError("a dense cache takes a scalar (int) write "
                            "offset or a (B,) tensor of per-row offsets")
        S = positions.shape[1]
        idx = cache_offset % self.L if self.ring else cache_offset
        if idx + S > self.L:
            raise ValueError(f"write of {S} tokens at slot {idx} overruns "
                             f"the {self.L}-slot cache")
        return self._store(state, idx, vals, positions, segments)

    def _store_rows(self, state: dict, offsets: torch.Tensor, vals: tuple,
                    positions, segments) -> dict:
        """Row b's S tokens into slots ``offsets[b] + j`` (mod L on a
        ring), padding at pos ``INVALID_POS``."""
        B, S = positions.shape
        dev = positions.device
        idx = offsets.to(device=dev, dtype=torch.int64)[:, None] \
            + torch.arange(S, dtype=torch.int64, device=dev)[None]
        if self.ring:
            idx = idx % self.L
        rows = torch.arange(B, dtype=torch.int64, device=dev)[:, None] \
            .expand(B, S)
        for (n, _), val in zip(cache_streams(self.cfg), vals):
            state[n][rows, idx] = val.to(state[n].dtype)
        state["pos"][rows, idx] = torch.where(segments < 0, INVALID_POS,
                                              positions)
        state["seg"][rows, idx] = segments
        return state

    def write_prefill(self, state: dict, vals: tuple, positions,
                      segments) -> dict:
        """Prompt prefill, in place. S <= L writes at offset 0; S > L
        (ring caches only) ring-writes the trailing window."""
        S = positions.shape[1]
        if S > self.L:
            if not self.ring:
                raise ValueError(f"prefill of {S} tokens exceeds the "
                                 f"{self.L}-slot cache")

            def ring(a):
                return torch.roll(a[:, -self.L:], S % self.L, dims=1)
            vals = tuple(ring(v) for v in vals)
            positions, segments = ring(positions), ring(segments)
        return self._store(state, 0, vals, positions, segments)


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
        """In-place flat scatter of the S tokens of every row, one scatter
        of B*S tokens: ``cache_offset`` holds flat slot indices (page_id *
        page_size + slot), (B,) for one token per row or (B, S) for a
        multi-token block. Engines point masked tokens at the trash page,
        so duplicate trash indices are harmless garbage."""
        idx = cache_offset.long().reshape(-1)
        for (n, shp), val in zip(cache_streams(self.cfg), vals):
            state[n + "_pages"].view((-1,) + shp)[idx] = val.reshape(
                (-1,) + shp)
        state["pos_pages"].view(-1)[idx] = positions.reshape(-1)
        return state


def _paged_gqa_decode(cfg: ModelConfig, q, k, v, positions, cache,
                      cache_offset, page_table):
    """S tokens per row against the paged pool: write their K/V in place,
    then attend over each row's pages, every token masked by its own
    position (so causality inside a multi-token block needs nothing
    more). S == 1 is a decode step; S > 1 the spec verify block or a
    suffix prefill."""
    PagedCacheBackend(cfg, cache["pos_pages"].shape[1]).write_decode(
        cache, (k, v), positions, cache_offset)
    if q.shape[1] == 1:
        out = paged_decode_attention(q[:, 0], cache["k_pages"],
                                     cache["v_pages"], cache["pos_pages"],
                                     page_table, positions[:, 0],
                                     window=cfg.sliding_window)[:, None]
    else:
        out = paged_verify_attention(q, cache["k_pages"], cache["v_pages"],
                                     cache["pos_pages"], page_table,
                                     positions, window=cfg.sliding_window)
    return out, cache


def _is_verify(S: int, cache_offset) -> bool:
    """A multi-token DECODE-side write (the dense spec engines' k+1-token
    verify block, the draft model's feed) rather than a prefill: every
    prefill passes a scalar offset (0), the verify engines per-row (B,)
    start offsets (JAX's ``_is_verify``)."""
    return S > 1 and isinstance(cache_offset, torch.Tensor) \
        and cache_offset.dim() >= 1


def _dense_prefill(cfg: ModelConfig, vals: tuple, positions, segments,
                   cache, cache_offset) -> None:
    """A prefill (S > 1) into a dense cache, filled from offset 0. The
    prefill attends over its own fresh tokens, with the positions and
    segments it was given: the JAX package attends over the cache after
    the write, whose other slots (pos 2^30) no query sees, so the masks
    are the same; a windowed prefill of more than L tokens attends over
    all of them and keeps the trailing window (the JAX S > L branch)."""
    if cache is None:
        return
    if not (cache_offset is None or (isinstance(cache_offset, int)
                                     and cache_offset == 0)):
        raise ValueError("a prefill fills a dense cache from offset 0; a "
                         "multi-token write elsewhere is a verify block, "
                         "which takes per-row (B,) tensor offsets")
    DenseCacheBackend(cfg, cache["pos"].shape[1]).write_prefill(
        cache, vals, positions, segments)


def _dense_decode_write(cfg: ModelConfig, vals: tuple, positions, segments,
                        cache, cache_offset) -> None:
    """S tokens per row into a dense (or ring) cache at the scalar offset
    (a prompt of one token is written at 0, as in JAX) or at per-row (B,)
    offsets."""
    DenseCacheBackend(cfg, cache["pos"].shape[1]).write_decode(
        cache, vals, positions, segments,
        0 if cache_offset is None else cache_offset)


def gqa_attention(params, cfg: ModelConfig, x, positions, segments, *,
                  cache: Optional[dict] = None, cache_offset=None,
                  page_table=None):
    """x: (B, S, d). Prefill/training when ``cache`` is None or a dense
    cache filled from offset 0 (S > 1); one token per row against a dense
    (or ring) cache at a scalar or per-row (B,) offset (the dense engines'
    decode step); S > 1 tokens per row against a dense cache at per-row
    offsets (a verify block: written first, then each query attends at
    its own position); S tokens per row against the paged pool when
    ``cache`` is one (with (B,) or (B, S) flat write slots and a page
    table).

    Returns (out, cache)."""
    B, S, _ = x.shape
    H, Hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = (x @ params["wq"]).reshape(B, S, H, hd)
    k = (x @ params["wk"]).reshape(B, S, Hkv, hd)
    v = (x @ params["wv"]).reshape(B, S, Hkv, hd)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)

    if cache is not None and is_paged_cache(cache):
        out, cache = _paged_gqa_decode(cfg, q, k, v, positions, cache,
                                       cache_offset, page_table)
    elif cache is not None and S == 1:
        # dense decode: write, then the contiguous decode kernel over the
        # cache (JAX: chunked_attention's single-query path)
        _dense_decode_write(cfg, (k, v), positions, segments, cache,
                            cache_offset)
        out = decode_attention(q[:, 0], cache["k"], cache["v"],
                               cache["pos"], positions[:, 0],
                               window=cfg.sliding_window)[:, None]
    elif cache is not None and _is_verify(S, cache_offset):
        # dense verify block: write, then the contiguous verify kernel,
        # every query masked by its own position
        _dense_decode_write(cfg, (k, v), positions, segments, cache,
                            cache_offset)
        out = verify_attention(q, cache["k"], cache["v"], cache["pos"],
                               positions, window=cfg.sliding_window)
    else:
        _dense_prefill(cfg, (k, v), positions, segments, cache,
                       cache_offset)
        out = spa_attention(q, k, v, positions, positions, segments,
                            segments, window=cfg.sliding_window,
                            chunk_size=cfg.attn_chunk_size)
    out = out.reshape(B, S, H * hd) @ params["wo"]
    return out, cache


# ---------------------------------------------------------------------
# MLA (multi-head latent attention, DeepSeek-V2)
# ---------------------------------------------------------------------

def _mla_qckv(params, cfg: ModelConfig, x, positions):
    """Per-head queries split into (nope, rope) parts, the normalised
    latent ckv (B, S, r) and the shared rope key kr (B, S, rd)."""
    B, S, _ = x.shape
    H, nd, rd = cfg.num_heads, cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    q = (x @ params["wq"]).reshape(B, S, H, nd + rd)
    q_nope, q_rope = q[..., :nd], q[..., nd:]
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)
    ckv = rmsnorm(params["ckv_norm"], x @ params["w_dkv"], cfg.norm_eps)
    kr = apply_rope((x @ params["w_kr"])[:, :, None, :], positions,
                    cfg.rope_theta)[:, :, 0, :]
    return q_nope, q_rope, ckv, kr


def _absorbed_q(params, cfg: ModelConfig, q_nope, q_rope):
    """Fold w_uk into q: (B, S, H, nd) -> (B, S, H, r + rd) latent-space
    queries."""
    w_uk = params["w_uk"].reshape(cfg.kv_lora_rank, cfg.num_heads,
                                  cfg.qk_nope_head_dim)
    q_lat = torch.einsum("bshn,rhn->bshr", q_nope, w_uk)
    return torch.cat([q_lat, q_rope], dim=-1)


def _paged_mla_decode(params, cfg: ModelConfig, q_nope, q_rope, ckv, kr,
                      positions, cache, cache_offset, page_table, scale):
    """Absorbed MLA attention of S tokens per row against the paged latent
    pool: write their (ckv, kr) rows in place, then attend in the (rank +
    rope) latent space, every token masked by its own position. S == 1 is
    a decode step, S > 1 the spec verify block or a radix suffix prefill
    (its pad slots write to the trash page at pos 0 and their outputs are
    dropped). Returns (o_lat (B, S, H, r), cache)."""
    PagedCacheBackend(cfg, cache["pos_pages"].shape[1]).write_decode(
        cache, (ckv, kr), positions, cache_offset)
    q_cat = _absorbed_q(params, cfg, q_nope, q_rope)          # (B,S,H,r+rd)
    pools = (cache["ckv_pages"], cache["kr_pages"], cache["pos_pages"],
             page_table)
    if q_cat.shape[1] == 1:
        o_lat = paged_mla_decode_attention(
            q_cat[:, 0], *pools, positions[:, 0], scale=scale,
            window=cfg.sliding_window)[:, None]
    else:
        o_lat = paged_mla_verify_attention(q_cat, *pools, positions,
                                           scale=scale,
                                           window=cfg.sliding_window)
    return o_lat, cache


def _dense_mla_decode(params, cfg: ModelConfig, q_nope, q_rope, ckv, kr,
                      positions, segments, cache, cache_offset, scale):
    """Absorbed MLA attention of S tokens per row against a dense (or
    ring) latent cache: write their (ckv, kr) rows, then attend in the
    latent space through the contiguous MLA wrappers (JAX:
    chunked_attention over the cache read), one token per row through
    ``mla_decode_attention``, a verify block through
    ``mla_verify_attention``. Returns o_lat (B, S, H, r)."""
    _dense_decode_write(cfg, (ckv, kr), positions, segments, cache,
                        cache_offset)
    q_cat = _absorbed_q(params, cfg, q_nope, q_rope)
    if q_cat.shape[1] > 1:
        return mla_verify_attention(q_cat, cache["ckv"], cache["kr"],
                                    cache["pos"], positions, scale=scale,
                                    window=cfg.sliding_window)
    return mla_decode_attention(q_cat[:, 0], cache["ckv"], cache["kr"],
                                cache["pos"], positions[:, 0], scale=scale,
                                window=cfg.sliding_window)[:, None]


def _mla_expanded(params, cfg: ModelConfig, q_nope, q_rope, ckv_all, kr_all,
                  positions, kv_pos, segments, kv_seg, scale):
    """Prefill attention: per-head K/V expanded from the latent, then
    masked attention in plain PyTorch (``chunked_attention``). This is not
    a fallback for a missing kernel: the JAX package computes MLA prefill
    and training attention the same way, in plain jnp outside any Pallas
    kernel (``mla_attention``'s expanded branch), so there is no TPU
    kernel here to port, and the SPA kernel takes only Dk == Dv in {64,
    128} while this path has Dk = nd + rd and Dv = vd."""
    B, L, _ = ckv_all.shape
    H, nd = cfg.num_heads, cfg.qk_nope_head_dim
    k_nope = (ckv_all @ params["w_uk"]).reshape(B, L, H, nd)
    v = (ckv_all @ params["w_uv"]).reshape(B, L, H, cfg.v_head_dim)
    k = torch.cat([k_nope, kr_all[:, :, None, :].expand(
        B, L, H, cfg.qk_rope_head_dim)], dim=-1)
    q = torch.cat([q_nope, q_rope], dim=-1)
    return chunked_attention(q, k, v, positions, kv_pos, segments, kv_seg,
                             window=cfg.sliding_window,
                             chunk_size=cfg.attn_chunk_size, scale=scale)


def mla_attention(params, cfg: ModelConfig, x, positions, segments, *,
                  cache: Optional[dict] = None, cache_offset=None,
                  page_table=None):
    """x: (B, S, d). Against the paged latent pool (``cache`` one, with
    flat write slots and a page table): the absorbed path through the
    paged MLA kernels for S tokens per row (a decode step, the spec verify
    block, a radix suffix prefill attending through cached latent pages),
    so the pool stores only ckv + kr per token (the MLA memory win); one
    token per row against a dense (or ring) latent cache: the same
    absorbed attention through the contiguous MLA wrapper (the dense
    engines' decode step), and S > 1 tokens per row at per-row (B,)
    offsets (a verify block) through the contiguous MLA verify wrapper.
    Otherwise (no cache, or a dense cache filled from offset 0): the
    expanded path of prefill and training.

    The softmax scale is (nd + rd)^-0.5 and is passed to the kernels
    explicitly: their default, D^-0.5 with D = r + rd, is not MLA's.
    Returns (out, cache)."""
    B, S, _ = x.shape
    H, vd, r = cfg.num_heads, cfg.v_head_dim, cfg.kv_lora_rank
    q_nope, q_rope, ckv, kr = _mla_qckv(params, cfg, x, positions)
    scale = (cfg.qk_nope_head_dim + cfg.qk_rope_head_dim) ** -0.5
    if cache is not None and (S == 1 or is_paged_cache(cache)
                              or _is_verify(S, cache_offset)):
        if is_paged_cache(cache):
            o_lat, cache = _paged_mla_decode(params, cfg, q_nope, q_rope,
                                             ckv, kr, positions, cache,
                                             cache_offset, page_table, scale)
        else:
            o_lat = _dense_mla_decode(params, cfg, q_nope, q_rope, ckv, kr,
                                      positions, segments, cache,
                                      cache_offset, scale)
        out = torch.einsum("bshr,rhv->bshv", o_lat,
                           params["w_uv"].reshape(r, H, vd))
    else:
        _dense_prefill(cfg, (ckv, kr), positions, segments, cache,
                       cache_offset)
        out = _mla_expanded(params, cfg, q_nope, q_rope, ckv, kr,
                            positions, positions, segments, segments, scale)
    out = out.reshape(B, S, H * vd) @ params["wo"]
    return out, cache


def attention(params, cfg: ModelConfig, x, positions, segments, **kw):
    """The block's attention: MLA or GQA by the config."""
    fn = mla_attention if cfg.use_mla else gqa_attention
    return fn(params, cfg, x, positions, segments, **kw)
