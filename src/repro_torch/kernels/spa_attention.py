"""Block-sparse shared-prompt flash attention (prefill and SPA-packed rows),
forward and backward.

``spa_attention`` launches the CUDA kernel ``csrc/spa_attention.cu`` for
CUDA tensors; CPU tensors take ``chunked_attention``, the plain PyTorch
version of the same function, whose gradient autograd takes. It replaces
the Pallas TPU kernel ``spa_attention`` of ``src/repro/kernels/
spa_attention.py``. When autograd needs its gradient (training), a CUDA
call goes through ``_SPAAttention``: the forward kernel also writes the
log-sum-exp and an f32 copy of the output, and the backward launches
``csrc/spa_attention_bwd.cu`` — the port's kernel for the gradient the JAX
package takes by autodiff of its pure-JAX ``chunked_attention`` (the
Pallas kernel has no VJP).

Semantics (both versions): kv visible iff ``kv_pos <= q_pos`` and
(``kv_seg == 0`` or ``kv_seg == q_seg``), optionally ``q_pos - kv_pos <
window``; online softmax in f32 with the finite ``NEG_INF``; masked
probabilities are exactly 0, so a query row that sees no key at all
returns 0 (the JAX kernel returns an average of masked values there —
such rows are padding and never read).
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import build, count_launch

NEG_INF = -1e30
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (64, 128)
# q, k, v, q_pos, kv_pos, q_seg, kv_seg, out, lse, o32; B, Sq, Skv, H, Hkv,
# D, dtype, window; scale; stream
_ARGTYPES = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 8 + [ctypes.c_float,
                                                          ctypes.c_void_p]
# q, k, v, q_pos, kv_pos, q_seg, kv_seg, o32, lse, dout, delta, dk_part,
# dv_part, dq, dk, dv; B, Sq, Skv, H, Hkv, D, dtype, window; scale; stream
_BWD_ARGTYPES = [ctypes.c_void_p] * 16 + [ctypes.c_int] * 8 + [
    ctypes.c_float, ctypes.c_void_p]


def allow_mask(q_pos, kv_pos, q_seg, kv_seg, window: Optional[int] = None):
    """(B, Sq), (B, Skv) -> (B, Sq, Skv) boolean shared-prompt/causal mask."""
    qp, kp = q_pos[:, :, None], kv_pos[:, None, :]
    qs, ks = q_seg[:, :, None], kv_seg[:, None, :]
    allow = (kp <= qp) & ((ks == 0) | (ks == qs))
    if window is not None:
        allow &= (qp - kp) < window
    return allow


def chunked_attention(q, k, v, q_pos, kv_pos, q_seg, kv_seg, *,
                      window: Optional[int] = None, chunk_size: int = 512,
                      scale: Optional[float] = None):
    """Plain PyTorch flash attention: online softmax over KV chunks, f32
    inside, rounded once to q.dtype.

    q: (B, Sq, H, Dk); k: (B, Skv, Hkv, Dk); v: (B, Skv, Hkv, Dv) with
    H % Hkv == 0 (query head h reads KV head h // G). Returns (B, Sq, H, Dv).
    """
    B, Sq, H, Dk = q.shape
    _, Skv, Hkv, Dv = v.shape
    G = H // Hkv
    scale = Dk ** -0.5 if scale is None else scale
    qr = q.float().reshape(B, Sq, Hkv, G, Dk)
    acc = q.new_zeros((B, Hkv, G, Sq, Dv), dtype=torch.float32)
    m = q.new_full((B, Hkv, G, Sq), NEG_INF, dtype=torch.float32)
    l = q.new_zeros((B, Hkv, G, Sq), dtype=torch.float32)
    for c0 in range(0, Skv, chunk_size):
        kc = k[:, c0:c0 + chunk_size].float()
        vc = v[:, c0:c0 + chunk_size].float()
        ok = allow_mask(q_pos, kv_pos[:, c0:c0 + chunk_size], q_seg,
                        kv_seg[:, c0:c0 + chunk_size], window)[:, None, None]
        s = torch.einsum("bqhgd,bkhd->bhgqk", qr, kc) * scale
        s = torch.where(ok, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.where(ok, torch.exp(s - m_new[..., None]), 0.0)
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum("bhgqk,bkhd->bhgqd", p, vc)
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, Dv).to(q.dtype)


def _check_cuda(q, k, v, q_pos, kv_pos, q_seg, kv_seg, window):
    B, Sq, H, D = q.shape
    if k.shape != v.shape or k.dim() != 4 or k.shape[0] != B:
        raise ValueError(f"spa_attention: k/v must be (B, Skv, Hkv, D) with "
                         f"B={B}, got {tuple(k.shape)}/{tuple(v.shape)}")
    _, Skv, Hkv, Dk = k.shape
    if Dk != D or D not in _HEAD_DIMS:
        raise ValueError(f"spa_attention kernel takes head_dim in "
                         f"{_HEAD_DIMS} with Dv == Dk, got q {D}, k/v {Dk}")
    if H % Hkv:
        raise ValueError(f"spa_attention: {H} query heads over {Hkv} KV heads")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"spa_attention kernel takes float32 or bfloat16 "
                        f"q/k/v of one dtype, got {q.dtype}/{k.dtype}/{v.dtype}")
    for name, t, n in (("q_pos", q_pos, Sq), ("q_seg", q_seg, Sq),
                       ("kv_pos", kv_pos, Skv), ("kv_seg", kv_seg, Skv)):
        if t.dtype != torch.int32 or tuple(t.shape) != (B, n):
            raise TypeError(f"spa_attention: {name} must be int32 ({B}, {n}), "
                            f"got {t.dtype} {tuple(t.shape)}")
    for t in (q, k, v, q_pos, kv_pos, q_seg, kv_seg):
        if t.device != q.device:
            raise ValueError("spa_attention: all inputs must be on one device")
        if not t.is_contiguous():
            raise ValueError("spa_attention kernel takes contiguous inputs")
    for t in (q, k, v):
        if t.data_ptr() % 16:
            raise ValueError("spa_attention kernel reads q/k/v 16 bytes at a "
                             "time: their storage must be 16-byte aligned")
    if window is not None and window <= 0:
        raise ValueError(f"spa_attention: window must be positive, got {window}")


def _optional_ptr(t) -> Optional[ctypes.c_void_p]:
    return None if t is None else build.ptr(t)


def _forward_kernel(q, k, v, q_pos, kv_pos, q_seg, kv_seg, scale: float,
                    window: Optional[int], stats: bool):
    """Launch the forward kernel. Returns (out, o32, lse): with ``stats``
    the f32 output (``out`` itself for f32 inputs) and the (B, H, Sq) f32
    log-sum-exp of the scaled scores, else (out, None, None)."""
    B, Sq, H, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    lse = o32 = None
    if stats:
        lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
        if q.dtype != torch.float32:
            o32 = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    launch = build.entry("spa_attention", "spa_attention_launch", _ARGTYPES)
    launch(build.ptr(q), build.ptr(k), build.ptr(v), build.ptr(q_pos),
           build.ptr(kv_pos), build.ptr(q_seg), build.ptr(kv_seg),
           build.ptr(out), _optional_ptr(lse), _optional_ptr(o32), B, Sq, Skv,
           H, Hkv, D, _DTYPES[q.dtype], window or 0, scale, build.stream(q))
    count_launch("spa_attention")
    if stats and o32 is None:
        o32 = out
    return out, o32, lse


def spa_attention_bwd(q, k, v, q_pos, kv_pos, q_seg, kv_seg, o32, lse, dout,
                      *, scale: Optional[float] = None,
                      window: Optional[int] = None):
    """The backward kernel: (dq, dk, dv) of the forward at (q, k, v), given
    the forward's f32 output ``o32`` (B, Sq, H, D) and log-sum-exp ``lse``
    (B, H, Sq), and ``dout`` in q's dtype. CUDA tensors only — its plain
    version is ``spa_attention_bwd_plain``."""
    if q.device.type != "cuda":
        raise ValueError(f"spa_attention_bwd: the kernel runs on CUDA tensors "
                         f"(got {q.device}); the plain version is autograd "
                         f"of chunked_attention")
    _check_cuda(q, k, v, q_pos, kv_pos, q_seg, kv_seg, window)
    B, Sq, H, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    for name, t, shape, dt in (("o32", o32, (B, Sq, H, D), torch.float32),
                               ("lse", lse, (B, H, Sq), torch.float32),
                               ("dout", dout, (B, Sq, H, D), q.dtype)):
        if t.dtype != dt or tuple(t.shape) != shape or \
                t.device != q.device or not t.is_contiguous():
            raise ValueError(f"spa_attention_bwd: {name} must be a contiguous "
                             f"{dt} {shape} on {q.device}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    scale = D ** -0.5 if scale is None else scale
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    delta = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    # each query head's unrounded part of dk and dv; the kernel sums the G
    # parts of a KV head in a fixed order (no atomics) and rounds once
    dk_part, dv_part = (torch.empty((B, Skv, H, D), dtype=torch.float32,
                                    device=q.device) for _ in range(2))
    launch = build.entry("spa_attention_bwd", "spa_attention_bwd_launch",
                         _BWD_ARGTYPES)
    launch(*(build.ptr(t) for t in (q, k, v, q_pos, kv_pos, q_seg, kv_seg,
                                    o32, lse, dout, delta, dk_part, dv_part,
                                    dq, dk, dv)),
           B, Sq, Skv, H, Hkv, D, _DTYPES[q.dtype], window or 0, scale,
           build.stream(q))
    count_launch("spa_attention_bwd")
    return dq, dk, dv


def spa_attention_bwd_plain(q, k, v, q_pos, kv_pos, q_seg, kv_seg, dout, *,
                            scale: Optional[float] = None,
                            window: Optional[int] = None):
    """Plain version of the backward: autograd of ``chunked_attention``.
    Returns (dq, dk, dv)."""
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    with torch.enable_grad():
        out = chunked_attention(*leaves, q_pos, kv_pos, q_seg, kv_seg,
                                window=window, scale=scale)
        return torch.autograd.grad(out, leaves, dout)


class _SPAAttention(torch.autograd.Function):
    """The forward and backward kernels under autograd (CUDA tensors)."""

    @staticmethod
    def forward(ctx, q, k, v, q_pos, kv_pos, q_seg, kv_seg, scale, window):
        out, o32, lse = _forward_kernel(q, k, v, q_pos, kv_pos, q_seg, kv_seg,
                                        scale, window, stats=True)
        ctx.save_for_backward(q, k, v, q_pos, kv_pos, q_seg, kv_seg, o32, lse)
        ctx.scale, ctx.window = scale, window
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, q_pos, kv_pos, q_seg, kv_seg, o32, lse = ctx.saved_tensors
        dq, dk, dv = spa_attention_bwd(
            q, k, v, q_pos, kv_pos, q_seg, kv_seg, o32, lse,
            dout.contiguous(), scale=ctx.scale, window=ctx.window)
        return dq, dk, dv, None, None, None, None, None, None


def spa_attention(q, k, v, q_pos, kv_pos, q_seg, kv_seg, *,
                  scale: Optional[float] = None,
                  window: Optional[int] = None,
                  chunk_size: int = 512):
    """Shared-prompt flash attention. q: (B, Sq, H, D); k/v: (B, Skv, Hkv,
    D); pos/seg: (B, S) int32. Returns (B, Sq, H, D) in q.dtype.

    CPU tensors run the plain version (KV chunks of ``chunk_size``) under
    autograd; CUDA tensors launch the kernel, and its backward kernel when
    autograd records the call."""
    if q.device.type == "cpu":
        return chunked_attention(q, k, v, q_pos, kv_pos, q_seg, kv_seg,
                                 window=window, scale=scale,
                                 chunk_size=chunk_size)
    if q.device.type != "cuda":
        raise ValueError(f"spa_attention: no kernel for device {q.device}")
    _check_cuda(q, k, v, q_pos, kv_pos, q_seg, kv_seg, window)
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _SPAAttention.apply(q, k, v, q_pos, kv_pos, q_seg, kv_seg,
                                   scale, window)
    return _forward_kernel(q, k, v, q_pos, kv_pos, q_seg, kv_seg, scale,
                           window, stats=False)[0]
