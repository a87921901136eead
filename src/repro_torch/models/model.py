"""Public model API of the port: init / forward / logits."""
from __future__ import annotations

import torch

from repro_torch import device as _device
from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import lm_head_weight
from repro_torch.models.transformer import (forward_hidden, init_caches,
                                            init_model, init_paged_caches)


def init(cfg: ModelConfig, *, seed: int = 0, device="cuda") -> dict:
    """Random weights from ``seed``, made directly on ``device`` (CUDA
    unless the caller asks for the CPU)."""
    return init_model(cfg, seed=seed, device=_device.resolve(device))


def logits(params: dict, cfg: ModelConfig, hidden: torch.Tensor
           ) -> torch.Tensor:
    return hidden @ lm_head_weight(params["embed"], cfg).to(hidden.dtype)


def forward(params: dict, cfg: ModelConfig, tokens: torch.Tensor, **kw):
    """Full-logits forward (small models / tests). Returns (logits, caches)."""
    h, caches = forward_hidden(params, cfg, tokens, **kw)
    return logits(params, cfg, h), caches


__all__ = ["init", "forward", "forward_hidden", "init_caches",
           "init_paged_caches", "logits"]
