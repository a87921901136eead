"""Flash attention of new tokens against a KV cache: one query per row
(decode) or S queries per row, each masked by its own position (the
spec-decode verify block and the radix cache's suffix prefill).

Three CUDA sources serve eight wrappers:

  * ``paged_decode_attention`` launches ``csrc/paged_decode_attention.cu``
    (one query per row over the page pool): the Split-L kernel of
    ``csrc/splitl.cuh``, the context split over blocks whose f32 partials
    a second kernel merges in split order, for any number of query heads
    per KV head;
  * ``paged_verify_attention`` launches ``csrc/paged_verify_attention.cu``
    (S queries per row over the page pool) in one of two regimes, chosen
    here by R = S * G query rows per (row, KV head): R <= 64 (the spec
    verify block) the same Split-L kernel, larger R (a suffix prefill)
    query tiles (bf16: 128 rows, two warpgroups on the tensor cores; f32:
    64 rows on the CUDA cores), split over the context (and merged by the
    same ordered combine) only while the grid would leave most SMs idle;
  * ``decode_attention`` and ``verify_attention`` take a contiguous
    (B, L, Hkv, D) cache and launch the same two kernels through a
    zero-copy view of it as a pool: one page of length L per row, the
    positions as that page's positions, and row b's table [b];
    ``mla_decode_attention`` (one query per row) and
    ``mla_verify_attention`` (S per row) do the same for the MLA kernel
    over a contiguous latent cache (B, L, r) / (B, L, rd);
  * ``paged_mla_decode_attention`` (one query per row) and
    ``paged_mla_verify_attention`` (S per row) launch
    ``csrc/paged_mla_attention.cu``: absorbed MLA attention over the
    paged LATENT pool, which is MQA (Hkv = 1, G = H) with K = [ckv | kr]
    (Dk = r + rd) and V = ckv (Dv = r); the caller passes MLA's scale.
    It is Split-L too (``mla_plan``: blocks of 16 query rows, the context
    split over blocks, the same ordered combine), with bf16 products on
    the tensor cores.

Each kernel walks the row's page table itself. CPU tensors take the plain
versions (``*_plain``), which gather each row's pages into a contiguous
context and run the plain attention. They replace the Pallas TPU kernels of
``src/repro/kernels/decode_attention.py`` of the same names.

Mask: ``kv_pos <= q_pos`` (optionally windowed). The null page 0 and every
unwritten slot carry pos 2^30, so they are masked for live tokens; a token
at pos 2^30 sees every slot, in both versions and in JAX. A query with no
visible key returns 0 in both versions (JAX averages the masked values).
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from repro_torch.kernels import build, count_launch
from repro_torch.kernels.spa_attention import chunked_attention

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (64, 128)
# q, k_pages, v_pages, pos_pages, page_table, q_pos, out, part_acc, part_ml;
# B, H, Hkv, D, page, n_max, dtype, window, splits, keys per split; scale;
# stream
_DECODE_ARGTYPES = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 10 + [
    ctypes.c_float, ctypes.c_void_p]
# the same with S after B and tiles (the regime) after keys per split
_VERIFY_ARGTYPES = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 12 + [
    ctypes.c_float, ctypes.c_void_p]
# The launch plan. Split-L (csrc/splitl.cuh): blocks walk 32-key steps,
# and the context is cut into enough splits that at least _WAVES blocks
# per SM exist and no split holds more than _SPLIT_KEYS keys (a long
# context is read by more blocks at once). Verify blocks of more than
# _SPLITL_MAX_ROWS query rows per (row, KV head) take the query-tile
# regime: 128 rows a block in bf16 (two warpgroups), 64 in f32, over
# 64-key tiles; its context is split only while fewer than _TILE_WAVES
# blocks per SM exist (each block already walks its rows' whole causal
# span). A split holds at most 4096 keys (its page-table entries and key
# bits sit in shared memory).
_KSTEP = 32
_SPLIT_MAX_KEYS = 4096
_WAVES = 2
_SPLIT_KEYS = 1024
_SPLITL_MAX_ROWS = 64
_TILE_ROWS = {True: 128, False: 64}      # by bf16
_TILE_KEYS = 64
_TILE_WAVES = 0.5
_sms = {}
_tables = {}
_plans = {}
# wrapper name -> the plan (``attention_plan``) of its last kernel launch
LAST_PLAN = {}
# (r, rd) latent widths the MLA kernel is built for: full-width and reduced
# deepseek-v2-lite
_MLA_SHAPES = ((512, 64), (64, 16))
# q, ckv_pages, kr_pages, pos_pages, page_table, q_pos, out, part_acc,
# part_ml; B, S, H, r, rd, page, n_max, dtype, window, splits, keys per
# split; scale; stream
_MLA_ARGTYPES = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 11 + [
    ctypes.c_float, ctypes.c_void_p]
# The MLA plan (``mla_plan``): blocks of 16 query rows walk 32-key tiles;
# two blocks per SM in one wave where the context allows; 256 to 1024 keys
# a split, down to 64 where 256-key splits leave fewer than two blocks per
# SM.
_MLA_ROWS = 16
_MLA_TILE = 32
_MLA_WAVES = 2
_MLA_SMALL_KEYS = 64
_MLA_MIN_KEYS = 256
_MLA_MAX_KEYS = 1024
_mla_plans = {}
_NO_SCRATCH = (ctypes.c_void_p(None), ctypes.c_void_p(None))


def gather_pages(k_pages, v_pages, pos_pages, page_table):
    """(P, page, Hkv, D) pools + (B, n_max) tables -> each row's logical
    (B, L, Hkv, D) K/V context and (B, L) positions."""
    B, n_max = page_table.shape
    page = pos_pages.shape[1]
    idx = page_table.long()
    k = k_pages[idx].reshape(B, n_max * page, *k_pages.shape[2:])
    v = v_pages[idx].reshape(B, n_max * page, *v_pages.shape[2:])
    return k, v, pos_pages[idx].reshape(B, n_max * page)


def gather_latent_pages(ckv_pages, kr_pages, pos_pages, page_table):
    """Latent pools (P, page, r) / (P, page, rd) + (B, n_max) tables ->
    MQA-shaped keys (B, L, 1, r + rd) = [ckv | kr], values (B, L, 1, r) =
    ckv, and positions (B, L)."""
    B, n_max = page_table.shape
    page = pos_pages.shape[1]
    idx = page_table.long()
    ckv = ckv_pages[idx].reshape(B, n_max * page, ckv_pages.shape[-1])
    kr = kr_pages[idx].reshape(B, n_max * page, kr_pages.shape[-1])
    k = torch.cat([ckv, kr], dim=-1)[:, :, None, :]
    return k, ckv[:, :, None, :], pos_pages[idx].reshape(B, n_max * page)


def verify_attention_plain(q, k, v, kv_pos, q_pos, *,
                           scale: Optional[float] = None,
                           window: Optional[int] = None):
    """Plain version over a contiguous cache: q (B, S, H, D), k/v (B, L,
    Hkv, D), kv_pos (B, L), q_pos (B, S); segments play no part."""
    return chunked_attention(q, k, v, q_pos, kv_pos, torch.zeros_like(q_pos),
                             torch.zeros_like(kv_pos), window=window,
                             scale=scale)


def decode_attention_plain(q, k, v, kv_pos, q_pos, *,
                           scale: Optional[float] = None,
                           window: Optional[int] = None):
    """Plain version of one query per row: q (B, H, D), q_pos (B,)."""
    return verify_attention_plain(q[:, None], k, v, kv_pos, q_pos[:, None],
                                  scale=scale, window=window)[:, 0]


def paged_verify_attention_plain(q, k_pages, v_pages, pos_pages, page_table,
                                 q_pos, *, scale: Optional[float] = None,
                                 window: Optional[int] = None):
    """Plain version: gather the pages, then masked attention of S queries
    per row, each at its own position."""
    k, v, kv_pos = gather_pages(k_pages, v_pages, pos_pages, page_table)
    return verify_attention_plain(q, k, v, kv_pos, q_pos, scale=scale,
                                  window=window)


def paged_decode_attention_plain(q, k_pages, v_pages, pos_pages, page_table,
                                 q_pos, *, scale: Optional[float] = None,
                                 window: Optional[int] = None):
    """Plain version: gather the pages, then masked attention of one query
    per row."""
    k, v, kv_pos = gather_pages(k_pages, v_pages, pos_pages, page_table)
    return decode_attention_plain(q, k, v, kv_pos, q_pos, scale=scale,
                                  window=window)


def paged_mla_decode_attention_plain(q, ckv_pages, kr_pages, pos_pages,
                                     page_table, q_pos, *, scale: float,
                                     window: Optional[int] = None):
    """Plain version: gather the latent pages, then masked attention of one
    query per row with K = [ckv | kr] and V = ckv."""
    k, v, kv_pos = gather_latent_pages(ckv_pages, kr_pages, pos_pages,
                                       page_table)
    return decode_attention_plain(q, k, v, kv_pos, q_pos, scale=scale,
                                  window=window)


def paged_mla_verify_attention_plain(q, ckv_pages, kr_pages, pos_pages,
                                     page_table, q_pos, *, scale: float,
                                     window: Optional[int] = None):
    """Plain version: gather the latent pages, then masked attention of S
    queries per row, each at its own position."""
    k, v, kv_pos = gather_latent_pages(ckv_pages, kr_pages, pos_pages,
                                       page_table)
    return verify_attention_plain(q, k, v, kv_pos, q_pos, scale=scale,
                                  window=window)


def attention_plan(B: int, S: int, H: int, Hkv: int, L: int, sms: int, *,
                   verify: bool, bf16: bool = False) -> dict:
    """How the paged decode (``verify=False``, S 1) and verify wrappers
    launch for a batch of B rows of S tokens over L = n_max * page logical
    keys on a card of ``sms`` SMs: the regime, the number of context
    splits and the keys each holds, the groups of query rows, and the
    blocks of the main kernel. Split-L blocks hold up to 16 query rows;
    more rows per (row, KV head) form more groups. ``bf16`` picks the
    query-tile kernel's rows per block."""
    R = S * (H // Hkv)
    if verify and R > _SPLITL_MAX_ROWS:
        tiles = -(-R // _TILE_ROWS[bf16])
        steps = -(-L // _TILE_KEYS)
        want = max(1, min(steps, math.ceil(_TILE_WAVES * sms
                                           / (tiles * Hkv * B))))
        per = min(-(-steps // want), _SPLIT_MAX_KEYS // _TILE_KEYS)
        splits = -(-steps // per)
        return {"regime": "tiles", "splits": splits,
                "keys_per_split": per * _TILE_KEYS, "row_groups": tiles,
                "blocks": splits * tiles * Hkv * B}
    rows = 4 if R <= 4 else 8 if R <= 8 else 16
    groups = -(-R // rows)
    steps = -(-L // _KSTEP)
    want = max(1, min(steps, max(-(-_WAVES * sms // (B * Hkv * groups)),
                                 -(-L // _SPLIT_KEYS))))
    per = min(max(1, steps // want), _SPLIT_MAX_KEYS // _KSTEP)
    splits = -(-steps // per)
    return {"regime": "splitl", "splits": splits,
            "keys_per_split": per * _KSTEP, "row_groups": groups,
            "blocks": splits * Hkv * B * groups}


def mla_plan(B: int, S: int, H: int, L: int, sms: int) -> dict:
    """How the MLA wrappers launch for B rows of S tokens of H heads over
    L = n_max * page logical keys on a card of ``sms`` SMs: the row groups
    (16 query rows a block: a token's 16 heads at full width), the context
    splits and the keys each holds (whole 32-key tiles), and the blocks of
    the main kernel. It is the plain function of the shape that
    ``attention_plan`` is for the GQA kernels, and takes no account of
    which keys are live.

    The splits are as many as give two blocks per SM in one wave, not one
    block more (the bf16 kernel's shared memory lets two blocks share an
    SM; a block left to a second wave would start its walk late), with 64
    to 1024 keys each (a split's positions, slots and live bits sit in
    shared memory). f32 knowingly takes the same plan, though its block
    (188,480 bytes of shared memory before the keys) leaves room for one
    an SM: sized for one f32 block an SM (8 splits of 1056 keys at B 16
    to 8k, 6 of 192 in the verify block, each one wave) it ran 8 % and 3 %
    slower on the H100 (PERF.md), probably because at mixed context
    lengths the shorter splits spread the live keys more evenly over the
    SMs (a split past a row's context ends at once). The f32 partials
    weigh on the choice: one split of one row group writes
    16 x (r + 2) floats and the combine reads them once, 65,792 bytes at
    full width (r 512), against 294,912 bytes of bf16 latent rows in a
    256-key split (22 %; f32 rows: 11 %; reduced width, r 64 / rd 16: 8,448
    against 40,960 bytes, 21 %). A split holds fewer than 256 keys only
    where 256-key splits would leave fewer than two blocks per SM: there
    the call is too small to be bound by bytes, its time is the longest
    block's walk, and the partials' bytes (89 % of the latent bytes at 64
    keys) cost less than a longer walk. At chip_smoke's phase-2 shapes on
    132 SMs:

      * decode B 4 over 1104 keys: 18 splits of 64 keys, 72 blocks;
      * decode B 16 over 8208 keys: 16 splits of 544 keys, 256 blocks;
      * verify B 4, S 5 over 1088 keys: 5 row groups, 12 splits of 96
        keys, 240 blocks."""
    groups = -(-S * H // _MLA_ROWS)
    steps = -(-L // _MLA_TILE)
    want = max(1, _MLA_WAVES * sms // (B * groups))     # one wave, not one block more
    least = _MLA_MIN_KEYS // _MLA_TILE
    per = max(least, -(-steps // want))
    if per == least and B * groups * -(-steps // least) < _MLA_WAVES * sms:
        per = max(_MLA_SMALL_KEYS // _MLA_TILE, -(-steps // want))
    per = min(per, _MLA_MAX_KEYS // _MLA_TILE, steps)
    splits = -(-steps // per)
    return {"regime": "splitl", "splits": splits,
            "keys_per_split": per * _MLA_TILE, "row_groups": groups,
            "blocks": splits * groups * B}


def _sm_count(device) -> int:
    n = _sms.get(device.index)
    if n is None:
        n = _sms[device.index] = \
            torch.cuda.get_device_properties(device).multi_processor_count
    return n


def _plan(B, S, H, Hkv, L, device, verify, bf16) -> dict:
    """``attention_plan`` on this device's card, made once per shape."""
    key = (B, S, H, Hkv, L, device, verify, bf16)
    plan = _plans.get(key)
    if plan is None:
        plan = _plans[key] = attention_plan(B, S, H, Hkv, L,
                                            _sm_count(device), verify=verify,
                                            bf16=bf16)
    return plan


def _launch_paged(name, symbol, argtypes, q, k_pages, v_pages, pos_pages,
                  page_table, q_pos, scale, window, S, verify, *,
                  counted: Optional[str] = None):
    """Launch a paged kernel (source ``name``) on q (B, [S,] H, D) by the
    plan: its splits and keys per split, f32 scratch for the partials above
    one split (one allocation: the accumulators, then (m, l) per row), and
    (verify) its regime. The launch and its plan are recorded under
    ``counted``, the calling wrapper's name (default ``name``)."""
    counted = counted or name
    B, H, D = q.shape[0], q.shape[-2], q.shape[-1]
    page, Hkv = k_pages.shape[1], k_pages.shape[2]
    n_max = page_table.shape[1]
    plan = _plan(B, S, H, Hkv, n_max * page, q.device, verify,
                 q.dtype == torch.bfloat16)
    LAST_PLAN[counted] = plan
    splits = plan["splits"]
    out = torch.empty_like(q)
    scratch = _NO_SCRATCH
    if splits > 1:
        rows = splits * B * S * H
        part = torch.empty(rows * (D + 2), dtype=torch.float32,
                           device=q.device)
        base = part.data_ptr()
        scratch = (ctypes.c_void_p(base), ctypes.c_void_p(base + 4 * rows * D))
    launch = build.entry(name, symbol, argtypes)
    dims = (B, S, H, Hkv, D) if verify else (B, H, Hkv, D)
    regime = (int(plan["regime"] == "tiles"),) if verify else ()
    launch(build.ptr(q), build.ptr(k_pages), build.ptr(v_pages),
           build.ptr(pos_pages), build.ptr(page_table), build.ptr(q_pos),
           build.ptr(out), *scratch, *dims, page, n_max, _DTYPES[q.dtype],
           window or 0, splits, plan["keys_per_split"], *regime,
           D ** -0.5 if scale is None else scale, build.stream(q))
    count_launch(counted)
    return out


def _check_cuda(name, q, k_pages, v_pages, pos_pages, page_table, q_pos,
                window):
    """The kernels' input contract; q is (B, [S,] H, D), q_pos (B, [S])."""
    B, H, D = q.shape[0], q.shape[-2], q.shape[-1]
    if k_pages.shape != v_pages.shape or k_pages.dim() != 4:
        raise ValueError(f"{name}: k/v pages must be (P, page, Hkv, D), got "
                         f"{tuple(k_pages.shape)}/{tuple(v_pages.shape)}")
    P, page, Hkv, Dk = k_pages.shape
    if Dk != D or D not in _HEAD_DIMS:
        raise ValueError(f"{name} kernel takes head_dim in {_HEAD_DIMS} with "
                         f"Dv == Dk, got q {D}, pages {Dk}")
    if H % Hkv:
        raise ValueError(f"{name} kernel takes H % Hkv == 0, got H={H}, "
                         f"Hkv={Hkv}")
    if q.dtype not in _DTYPES or k_pages.dtype != q.dtype \
            or v_pages.dtype != q.dtype:
        raise TypeError(f"{name} kernel takes float32 or bfloat16 of one "
                        f"dtype, got {q.dtype}/{k_pages.dtype}/"
                        f"{v_pages.dtype}")
    if page_table.dim() != 2:
        raise TypeError(f"{name}: page_table must be (B, n_max)")
    for arg, t, shape in (("pos_pages", pos_pages, (P, page)),
                          ("page_table", page_table,
                           (B, page_table.shape[-1])),
                          ("q_pos", q_pos, tuple(q.shape[:-2]))):
        if t.dtype != torch.int32 or tuple(t.shape) != shape:
            raise TypeError(f"{name}: {arg} must be int32 {shape}, got "
                            f"{t.dtype} {tuple(t.shape)}")
    for t in (q, k_pages, v_pages, pos_pages, page_table, q_pos):
        if t.device != q.device:
            raise ValueError(f"{name}: all inputs must be on one device")
        if not t.is_contiguous():
            raise ValueError(f"{name} kernel takes contiguous inputs")
    for t in (k_pages, v_pages):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} kernel reads K/V pages 16 bytes at a "
                             f"time: their storage must be 16-byte aligned")
    if window is not None and window <= 0:
        raise ValueError(f"{name}: window must be positive, got {window}")


def _device_route(name, q) -> bool:
    """True: launch the kernel (CUDA); False: run the plain version (CPU)."""
    if q.device.type == "cpu":
        return False
    if q.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {q.device}")
    return True


def paged_decode_attention(q, k_pages, v_pages, pos_pages, page_table, q_pos,
                           *, scale: Optional[float] = None,
                           window: Optional[int] = None):
    """q: (B, H, D); k_pages/v_pages: (P, page, Hkv, D); pos_pages: (P,
    page) int32; page_table: (B, n_max) int32 page ids per row; q_pos: (B,)
    int32. Returns (B, H, D) in q.dtype.

    CPU tensors run the plain version; CUDA tensors launch the kernel."""
    name = "paged_decode_attention"
    if not _device_route(name, q):
        return paged_decode_attention_plain(q, k_pages, v_pages, pos_pages,
                                            page_table, q_pos, scale=scale,
                                            window=window)
    _check_cuda(name, q, k_pages, v_pages, pos_pages, page_table, q_pos,
                window)
    return _launch_paged(name, "paged_decode_attention_launch",
                         _DECODE_ARGTYPES, q, k_pages, v_pages, pos_pages,
                         page_table, q_pos, scale, window, 1, verify=False)


def paged_verify_attention(q, k_pages, v_pages, pos_pages, page_table, q_pos,
                           *, scale: Optional[float] = None,
                           window: Optional[int] = None):
    """q: (B, S, H, D), the S tokens already written into the pool;
    k_pages/v_pages: (P, page, Hkv, D); pos_pages: (P, page) int32;
    page_table: (B, n_max) int32; q_pos: (B, S) int32, each token's own
    position. Returns (B, S, H, D) in q.dtype.

    CPU tensors run the plain version; CUDA tensors launch the kernel."""
    name = "paged_verify_attention"
    if not _device_route(name, q):
        return paged_verify_attention_plain(q, k_pages, v_pages, pos_pages,
                                            page_table, q_pos, scale=scale,
                                            window=window)
    _check_cuda(name, q, k_pages, v_pages, pos_pages, page_table, q_pos,
                window)
    return _launch_paged(name, "paged_verify_attention_launch",
                         _VERIFY_ARGTYPES, q, k_pages, v_pages, pos_pages,
                         page_table, q_pos, scale, window, q.shape[1],
                         verify=True)


def _as_pool(k, v, kv_pos):
    """A contiguous (B, L, Hkv, D) cache as a pool of B pages of length L,
    without a copy: row b's table is [b] (one table per batch size and
    device, made once: no kernel launch per call)."""
    key = (k.shape[0], k.device)
    table = _tables.get(key)
    if table is None:
        table = _tables[key] = torch.arange(
            k.shape[0], dtype=torch.int32, device=k.device)[:, None]
    return k, v, kv_pos, table


def decode_attention(q, k, v, kv_pos, q_pos, *, scale: Optional[float] = None,
                     window: Optional[int] = None):
    """q: (B, H, D) one token per row; k/v: (B, L, Hkv, D); kv_pos: (B, L)
    int32; q_pos: (B,) int32. Returns (B, H, D). CUDA tensors launch the
    paged decode kernel on the cache viewed as a pool (counted as
    ``decode_attention``). A ring cache's slots need not be in position
    order: the kernel's split combine is order-free."""
    name = "decode_attention"
    if not _device_route(name, q):
        return decode_attention_plain(q, k, v, kv_pos, q_pos, scale=scale,
                                      window=window)
    pool = _as_pool(k, v, kv_pos)
    _check_cuda(name, q, *pool, q_pos, window)
    return _launch_paged("paged_decode_attention",
                         "paged_decode_attention_launch", _DECODE_ARGTYPES,
                         q, *pool, q_pos, scale, window, 1, verify=False,
                         counted=name)


def verify_attention(q, k, v, kv_pos, q_pos, *, scale: Optional[float] = None,
                     window: Optional[int] = None):
    """q: (B, S, H, D); k/v: (B, L, Hkv, D); kv_pos: (B, L) int32; q_pos:
    (B, S) int32. Returns (B, S, H, D). CUDA tensors launch the paged
    verify kernel on the cache viewed as a pool (counted as
    ``verify_attention``)."""
    name = "verify_attention"
    if not _device_route(name, q):
        return verify_attention_plain(q, k, v, kv_pos, q_pos, scale=scale,
                                      window=window)
    pool = _as_pool(k, v, kv_pos)
    _check_cuda(name, q, *pool, q_pos, window)
    return _launch_paged("paged_verify_attention",
                         "paged_verify_attention_launch", _VERIFY_ARGTYPES,
                         q, *pool, q_pos, scale, window, q.shape[1],
                         verify=True, counted=name)


def _check_mla_cuda(name, q, ckv_pages, kr_pages, pos_pages, page_table,
                    q_pos, window):
    """The MLA kernel's input contract; q is (B, [S,] H, r + rd), q_pos
    (B, [S]). Written to cost little host time per call: sizes are read
    once and compared one by one (slicing a shape is slow)."""
    cs, rs = ckv_pages.shape, kr_pages.shape
    if len(cs) != 3 or len(rs) != 3 or cs[0] != rs[0] or cs[1] != rs[1]:
        raise ValueError(f"{name}: latent pages must be (P, page, r) and "
                         f"(P, page, rd), got {tuple(cs)}/{tuple(rs)}")
    P, page, r = cs
    rd = rs[2]
    qs = q.shape
    if (r, rd) not in _MLA_SHAPES or qs[-1] != r + rd:
        raise ValueError(f"{name} kernel is built for (r, rd) in "
                         f"{_MLA_SHAPES} with q of width r + rd, got "
                         f"({r}, {rd}) and q {qs[-1]}")
    dt = q.dtype
    if dt not in _DTYPES or ckv_pages.dtype != dt or kr_pages.dtype != dt:
        raise TypeError(f"{name} kernel takes float32 or bfloat16 of one "
                        f"dtype, got {dt}/{ckv_pages.dtype}/"
                        f"{kr_pages.dtype}")
    ts = page_table.shape
    if len(ts) != 2:
        raise TypeError(f"{name}: page_table must be (B, n_max)")
    i32 = torch.int32
    for arg, t, shape in (("pos_pages", pos_pages, (P, page)),
                          ("page_table", page_table, (qs[0], ts[1])),
                          ("q_pos", q_pos, tuple(qs)[:-2])):
        if t.dtype != i32 or t.shape != shape:
            raise TypeError(f"{name}: {arg} must be int32 {shape}, got "
                            f"{t.dtype} {tuple(t.shape)}")
    dev = q.get_device()
    for t in (q, ckv_pages, kr_pages, pos_pages, page_table, q_pos):
        if t.get_device() != dev:
            raise ValueError(f"{name}: all inputs must be on one device")
        if not t.is_contiguous():
            raise ValueError(f"{name} kernel takes contiguous inputs")
    if q.data_ptr() % 16 or ckv_pages.data_ptr() % 16 \
            or kr_pages.data_ptr() % 16:
        raise ValueError(f"{name} kernel reads queries and latent pages "
                         f"16 bytes at a time: their storage must be "
                         f"16-byte aligned")
    if window is not None and window <= 0:
        raise ValueError(f"{name}: window must be positive, got {window}")


def _launch_mla(name, q, ckv_pages, kr_pages, pos_pages, page_table, q_pos,
                scale, window, S):
    """Both MLA wrappers launch the one kernel by ``mla_plan`` (made once
    per shape); q is (B, H, r + rd) at S 1 (no view is made: views cost
    host time), else (B, S, H, r + rd); the output has q's leading shape.
    Above one split the f32 partials are one allocation: the accumulators
    (splits, B*S*H, r), then (m, l) per row."""
    _check_mla_cuda(name, q, ckv_pages, kr_pages, pos_pages, page_table,
                    q_pos, window)
    qs = q.shape
    B, H = qs[0], qs[-2]
    _, page, r = ckv_pages.shape
    n_max = page_table.shape[1]
    dev = q.get_device()
    key = (B, S, H, n_max * page, dev)
    plan = _mla_plans.get(key)
    if plan is None:
        plan = _mla_plans[key] = mla_plan(B, S, H, n_max * page,
                                          _sm_count(q.device))
    LAST_PLAN[name] = plan
    splits = plan["splits"]
    out = torch.empty((*qs[:-1], r), dtype=q.dtype, device=q.device)
    scratch = _NO_SCRATCH
    if splits > 1:
        rows = splits * B * S * H
        part = torch.empty(rows * (r + 2), dtype=torch.float32,
                           device=q.device)
        base = part.data_ptr()
        scratch = (ctypes.c_void_p(base), ctypes.c_void_p(base + 4 * rows * r))
    launch = build.entry("paged_mla_attention", "paged_mla_attention_launch",
                         _MLA_ARGTYPES)
    launch(build.ptr(q), build.ptr(ckv_pages), build.ptr(kr_pages),
           build.ptr(pos_pages), build.ptr(page_table), build.ptr(q_pos),
           build.ptr(out), *scratch, B, S, H, r, kr_pages.shape[2], page,
           n_max, _DTYPES[q.dtype], window or 0, splits,
           plan["keys_per_split"], float(scale), build.stream(q))
    count_launch(name)
    return out


def paged_mla_decode_attention(q, ckv_pages, kr_pages, pos_pages, page_table,
                               q_pos, *, scale: float,
                               window: Optional[int] = None):
    """Absorbed MLA decode over the paged latent pool. q: (B, H, r + rd)
    latent-space queries (w_uk folded in); ckv_pages: (P, page, r);
    kr_pages: (P, page, rd); pos_pages: (P, page) int32; page_table: (B,
    n_max) int32; q_pos: (B,) int32. ``scale`` has no default: MLA's is
    (nd + rd)^-0.5, not (r + rd)^-0.5. Returns (B, H, r) latent outputs in
    q.dtype (the caller applies w_uv).

    CPU tensors run the plain version; CUDA tensors launch the kernel."""
    name = "paged_mla_decode_attention"
    if not _device_route(name, q):
        return paged_mla_decode_attention_plain(
            q, ckv_pages, kr_pages, pos_pages, page_table, q_pos,
            scale=scale, window=window)
    if q.dim() != 3 or q_pos.dim() != 1:
        raise ValueError(f"{name}: q must be (B, H, r + rd) and q_pos (B,)")
    return _launch_mla(name, q, ckv_pages, kr_pages, pos_pages, page_table,
                       q_pos, scale, window, 1)


def paged_mla_verify_attention(q, ckv_pages, kr_pages, pos_pages, page_table,
                               q_pos, *, scale: float,
                               window: Optional[int] = None):
    """Absorbed MLA attention of S tokens per row over the paged latent
    pool (the spec verify block): q: (B, S, H, r + rd), the S tokens'
    latents already written into the pool; q_pos: (B, S) int32, each
    token's own position; the rest as ``paged_mla_decode_attention``.
    Returns (B, S, H, r).

    CPU tensors run the plain version; CUDA tensors launch the kernel."""
    name = "paged_mla_verify_attention"
    if not _device_route(name, q):
        return paged_mla_verify_attention_plain(
            q, ckv_pages, kr_pages, pos_pages, page_table, q_pos,
            scale=scale, window=window)
    if q.dim() != 4 or q_pos.dim() != 2:
        raise ValueError(f"{name}: q must be (B, S, H, r + rd) and q_pos "
                         f"(B, S)")
    return _launch_mla(name, q, ckv_pages, kr_pages, pos_pages, page_table,
                       q_pos, scale, window, q.shape[1])


def mla_decode_attention_plain(q, ckv, kr, kv_pos, q_pos, *, scale: float,
                               window: Optional[int] = None):
    """Plain version: the paged plain version on the one-page-per-row
    view of the contiguous latent cache."""
    return paged_mla_decode_attention_plain(q, *_as_pool(ckv, kr, kv_pos),
                                            q_pos, scale=scale, window=window)


def mla_decode_attention(q, ckv, kr, kv_pos, q_pos, *, scale: float,
                         window: Optional[int] = None):
    """Absorbed MLA decode over a contiguous latent cache (the group
    Sampler's dense or ring cache). q: (B, H, r + rd); ckv: (B, L, r); kr:
    (B, L, rd); kv_pos: (B, L) int32; q_pos: (B,) int32. Returns (B, H,
    r). CUDA tensors launch the paged MLA kernel on the cache viewed as a
    pool of B pages of length L, row b's table [b] (counted as
    ``mla_decode_attention``); CPU tensors run the paged plain version on
    the same view."""
    name = "mla_decode_attention"
    if not _device_route(name, q):
        return mla_decode_attention_plain(q, ckv, kr, kv_pos, q_pos,
                                          scale=scale, window=window)
    if q.dim() != 3 or q_pos.dim() != 1:
        raise ValueError(f"{name}: q must be (B, H, r + rd) and q_pos (B,)")
    return _launch_mla(name, q, *_as_pool(ckv, kr, kv_pos), q_pos, scale,
                       window, 1)


def mla_verify_attention_plain(q, ckv, kr, kv_pos, q_pos, *, scale: float,
                               window: Optional[int] = None):
    """Plain version: the paged plain version on the one-page-per-row
    view of the contiguous latent cache."""
    return paged_mla_verify_attention_plain(q, *_as_pool(ckv, kr, kv_pos),
                                            q_pos, scale=scale, window=window)


def mla_verify_attention(q, ckv, kr, kv_pos, q_pos, *, scale: float,
                         window: Optional[int] = None):
    """Absorbed MLA attention of S tokens per row over a contiguous latent
    cache (the dense spec engines' verify block, the draft model's feed).
    q: (B, S, H, r + rd), the S tokens' latents already written into the
    cache; ckv: (B, L, r); kr: (B, L, rd); kv_pos: (B, L) int32; q_pos:
    (B, S) int32, each token's own position. Returns (B, S, H, r). CUDA
    tensors launch the paged MLA kernel on the cache viewed as a pool of B
    pages of length L, row b's table [b] (counted as
    ``mla_verify_attention``); CPU tensors run the paged plain version on
    the same view."""
    name = "mla_verify_attention"
    if not _device_route(name, q):
        return mla_verify_attention_plain(q, ckv, kr, kv_pos, q_pos,
                                          scale=scale, window=window)
    if q.dim() != 4 or q_pos.dim() != 2:
        raise ValueError(f"{name}: q must be (B, S, H, r + rd) and q_pos "
                         f"(B, S)")
    return _launch_mla(name, q, *_as_pool(ckv, kr, kv_pos), q_pos, scale,
                       window, q.shape[1])
