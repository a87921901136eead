"""Flash decode over a paged KV pool (one new query token per row).

``paged_decode_attention`` launches the CUDA kernel
``csrc/paged_decode_attention.cu`` for CUDA tensors, which walks each row's
page table inside the kernel; CPU tensors take
``paged_decode_attention_plain``, which gathers each row's pages into a
contiguous context and runs the plain attention. It replaces the Pallas
TPU kernel ``paged_decode_attention`` of
``src/repro/kernels/decode_attention.py``.

Mask: ``kv_pos <= q_pos`` (optionally windowed). The null page 0 and every
unwritten slot carry pos 2^30, so they are masked for live rows; a row
with no visible key returns 0 in both versions.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import build, count_launch
from repro_torch.kernels.spa_attention import chunked_attention

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (64, 128)
_GMAX = 8     # query heads per KV head the kernel handles in one block
# q, k_pages, v_pages, pos_pages, page_table, q_pos, out; B, H, Hkv, D, page,
# n_max, dtype, window; scale; stream
_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 8 + [ctypes.c_float,
                                                         ctypes.c_void_p]


def gather_pages(k_pages, v_pages, pos_pages, page_table):
    """(P, page, Hkv, D) pools + (B, n_max) tables -> each row's logical
    (B, L, Hkv, D) K/V context and (B, L) positions."""
    B, n_max = page_table.shape
    page = pos_pages.shape[1]
    idx = page_table.long()
    k = k_pages[idx].reshape(B, n_max * page, *k_pages.shape[2:])
    v = v_pages[idx].reshape(B, n_max * page, *v_pages.shape[2:])
    return k, v, pos_pages[idx].reshape(B, n_max * page)


def paged_decode_attention_plain(q, k_pages, v_pages, pos_pages, page_table,
                                 q_pos, *, scale: Optional[float] = None,
                                 window: Optional[int] = None):
    """Plain version: gather the pages, then masked attention of one query
    per row (segments play no part in decode)."""
    k, v, kv_pos = gather_pages(k_pages, v_pages, pos_pages, page_table)
    qp = q_pos[:, None]
    out = chunked_attention(q[:, None], k, v, qp, kv_pos,
                            torch.zeros_like(qp), torch.zeros_like(kv_pos),
                            window=window, scale=scale)
    return out[:, 0]


def _check_cuda(q, k_pages, v_pages, pos_pages, page_table, q_pos, window):
    B, H, D = q.shape
    if k_pages.shape != v_pages.shape or k_pages.dim() != 4:
        raise ValueError(f"paged_decode_attention: k/v pages must be "
                         f"(P, page, Hkv, D), got {tuple(k_pages.shape)}/"
                         f"{tuple(v_pages.shape)}")
    P, page, Hkv, Dk = k_pages.shape
    if Dk != D or D not in _HEAD_DIMS:
        raise ValueError(f"paged_decode_attention kernel takes head_dim in "
                         f"{_HEAD_DIMS} with Dv == Dk, got q {D}, pages {Dk}")
    if H % Hkv or H // Hkv > _GMAX:
        raise ValueError(f"paged_decode_attention kernel takes H % Hkv == 0 "
                         f"and at most {_GMAX} query heads per KV head, got "
                         f"H={H}, Hkv={Hkv}")
    if q.dtype not in _DTYPES or k_pages.dtype != q.dtype \
            or v_pages.dtype != q.dtype:
        raise TypeError(f"paged_decode_attention kernel takes float32 or "
                        f"bfloat16 of one dtype, got {q.dtype}/"
                        f"{k_pages.dtype}/{v_pages.dtype}")
    for name, t, shape in (("pos_pages", pos_pages, (P, page)),
                           ("page_table", page_table, (B, page_table.shape[-1])),
                           ("q_pos", q_pos, (B,))):
        if t.dtype != torch.int32 or tuple(t.shape) != shape:
            raise TypeError(f"paged_decode_attention: {name} must be int32 "
                            f"{shape}, got {t.dtype} {tuple(t.shape)}")
    if page_table.dim() != 2:
        raise TypeError("paged_decode_attention: page_table must be (B, n_max)")
    for t in (q, k_pages, v_pages, pos_pages, page_table, q_pos):
        if t.device != q.device:
            raise ValueError("paged_decode_attention: all inputs must be on "
                             "one device")
        if not t.is_contiguous():
            raise ValueError("paged_decode_attention kernel takes contiguous "
                             "inputs")
    for t in (k_pages, v_pages):
        if t.data_ptr() % 16:
            raise ValueError("paged_decode_attention kernel reads K/V pages 16 "
                             "bytes at a time: their storage must be 16-byte "
                             "aligned")
    if window is not None and window <= 0:
        raise ValueError(f"paged_decode_attention: window must be positive, "
                         f"got {window}")


def paged_decode_attention(q, k_pages, v_pages, pos_pages, page_table, q_pos,
                           *, scale: Optional[float] = None,
                           window: Optional[int] = None):
    """q: (B, H, D); k_pages/v_pages: (P, page, Hkv, D); pos_pages: (P,
    page) int32; page_table: (B, n_max) int32 page ids per row; q_pos: (B,)
    int32. Returns (B, H, D) in q.dtype.

    CPU tensors run the plain version; CUDA tensors launch the kernel."""
    if q.device.type == "cpu":
        return paged_decode_attention_plain(q, k_pages, v_pages, pos_pages,
                                            page_table, q_pos, scale=scale,
                                            window=window)
    if q.device.type != "cuda":
        raise ValueError(f"paged_decode_attention: no kernel for device "
                         f"{q.device}")
    _check_cuda(q, k_pages, v_pages, pos_pages, page_table, q_pos, window)
    B, H, D = q.shape
    page, Hkv = k_pages.shape[1], k_pages.shape[2]
    n_max = page_table.shape[1]
    scale = D ** -0.5 if scale is None else scale
    out = torch.empty_like(q)
    launch = build.entry("paged_decode_attention",
                         "paged_decode_attention_launch", _ARGTYPES)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    launch(build.ptr(q), build.ptr(k_pages), build.ptr(v_pages),
           build.ptr(pos_pages), build.ptr(page_table), build.ptr(q_pos),
           build.ptr(out), B, H, Hkv, D, page, n_max, _DTYPES[q.dtype],
           window or 0, scale, ctypes.c_void_p(stream))
    count_launch("paged_decode_attention")
    return out
