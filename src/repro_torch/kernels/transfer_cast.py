"""Fused cast+copy for the weight-plane's wire payload.

``transfer_cast`` launches the CUDA kernel ``csrc/transfer_cast.cu`` for
CUDA tensors; CPU tensors take the plain version, ``x.to(dtype)``. It
replaces the Pallas TPU kernel ``transfer_cast`` of ``src/repro/kernels/
transfer_cast.py``: when the weight-plane streams an f32-mastered tree as a
bf16 (or f16) payload, one pass reads the f32 leaf and writes the payload,
rounding to nearest even — bitwise equal to ``x.to(dtype)`` on every finite
value, +-0 and +-Inf; a NaN stays a NaN.

Both versions take only f32 -> bf16 and f32 -> f16 (and return ``x``
itself when the dtypes already agree); any other pair raises.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, count_launch

_WIRE = {torch.bfloat16: 1, torch.float16: 2}
# src, dst; n; dst dtype; stream
_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
             ctypes.c_void_p]


def transfer_cast(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``x`` cast to ``dtype`` in one pass (a new tensor of x's shape)."""
    if x.dtype == dtype:
        return x
    if x.dtype != torch.float32 or dtype not in _WIRE:
        raise TypeError(f"transfer_cast takes float32 -> bfloat16/float16, "
                        f"got {x.dtype} -> {dtype}")
    if x.device.type == "cpu":
        return x.to(dtype)
    if x.device.type != "cuda":
        raise ValueError(f"transfer_cast: no kernel for device {x.device}")
    if not x.is_contiguous():
        raise ValueError("transfer_cast kernel takes a contiguous leaf")
    out = torch.empty(x.shape, dtype=dtype, device=x.device)
    if x.numel() == 0:
        return out
    launch = build.entry("transfer_cast", "transfer_cast_launch", _ARGTYPES)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    launch(build.ptr(x), build.ptr(out), x.numel(), _WIRE[dtype],
           ctypes.c_void_p(stream))
    count_launch("transfer_cast")
    return out
