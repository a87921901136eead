"""Core layers: RMSNorm, SwiGLU MLP, RoPE, embedding / LM head — plain
functions on tensors over a parameter dict with the JAX package's layout
(weights stored (in, out), applied as ``x @ w``). The f32 islands of the
JAX layers are kept: the norm, the SiLU and the rotary angles run in f32.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "float16": torch.float16}


def dtype_of(name: str) -> torch.dtype:
    return _DTYPES[name]


def dense_init(shape, *, in_axis: int, dtype: torch.dtype,
               device: torch.device, generator: torch.Generator
               ) -> torch.Tensor:
    """Truncated-normal fan-in init (+-2 sigma, sigma = fan_in^-0.5), drawn
    in f32 from ``generator`` on ``device`` and cast to ``dtype``."""
    w = torch.empty(shape, dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(w, mean=0.0, std=1.0, a=-2.0, b=2.0,
                                generator=generator)
    return (w * shape[in_axis] ** -0.5).to(dtype)


def rmsnorm(scale: torch.Tensor, x: torch.Tensor, eps: float = 1e-5
            ) -> torch.Tensor:
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


def mlp(params: dict, x: torch.Tensor) -> torch.Tensor:
    g = x @ params["w_gate"]
    u = x @ params["w_up"]
    h = torch.nn.functional.silu(g.float()).to(x.dtype) * u
    return h @ params["w_down"]


_FREQS: dict = {}


def rope_freqs(head_dim: int, theta: float, device) -> torch.Tensor:
    """(head_dim / 2,) f32 rotary frequencies, computed on the CPU and
    copied to ``device`` once (cached per device): every device rotates
    by the same angles. A pow on the card may round a frequency an ulp
    away from the CPU's, and an SPA padding token sits at position
    2^30 - 1, where one ulp of a frequency turns its angle by O(1) and
    gives it another hidden state, which a MoE layer routes. The first call
    on a device runs before any capture (a captured step's eager warm-up
    makes it), so a captured step only reads the cached tensor."""
    key = (head_dim, float(theta), torch.device(device))
    freqs = _FREQS.get(key)
    if freqs is None:
        half = head_dim // 2
        freqs = (1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32)
                                  / half))).to(device)
        _FREQS[key] = freqs
    return freqs


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float
               ) -> torch.Tensor:
    """Split-half rotary embedding. x: (B, S, H, D); positions: (B, S)."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)              # (D/2,)
    angles = positions.float()[..., None] * freqs                 # (B, S, D/2)
    angles = angles[..., None, :]                                 # (B, S, 1, D/2)
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def embed(params: dict, tokens: torch.Tensor, compute_dtype: torch.dtype
          ) -> torch.Tensor:
    return params["embedding"][tokens].to(compute_dtype)


def lm_head_weight(params: dict, cfg: ModelConfig) -> torch.Tensor:
    """(d_model, vocab)."""
    return params["embedding"].T if cfg.tie_embeddings else params["lm_head"]
