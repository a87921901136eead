"""Architecture registry of the port: ``--arch <id>`` -> ModelConfig.

Only the architectures whose whole serving path is ported are registered;
``get_config`` raises on every other id of the JAX registry.
"""
from __future__ import annotations

import dataclasses

from repro_torch.configs.base import ModelConfig, RLConfig
from repro_torch.configs.llama3p2_3b import CONFIG as _llama32

REGISTRY: dict[str, ModelConfig] = {c.name: c for c in (_llama32,)}

ARCH_IDS = tuple(REGISTRY)


def get_config(name: str) -> ModelConfig:
    if name not in REGISTRY:
        raise KeyError(f"arch {name!r} is not ported to PyTorch yet; "
                       f"ported: {sorted(REGISTRY)}")
    return REGISTRY[name]


def reduced_config(cfg: ModelConfig) -> ModelConfig:
    """CPU-smoke-testable variant of the same family: 2 layers,
    d_model <= 256, 64-wide heads, f32 (the dense branch of the JAX
    package's ``reduced_config``)."""
    heads = min(cfg.num_heads, 4) if cfg.num_heads else 0
    kv = min(cfg.num_kv_heads, max(1, heads // 2)) if heads else 0
    if heads and heads % max(kv, 1):
        kv = 1
    kw: dict = dict(
        name=cfg.name + "-smoke",
        num_layers=2,
        d_model=min(cfg.d_model, 256),
        num_heads=heads,
        num_kv_heads=kv,
        head_dim=64 if heads else 0,
        d_ff=min(cfg.d_ff, 512) if cfg.d_ff else 0,
        vocab_size=min(cfg.vocab_size, 512),
        attn_chunk_size=64,
        loss_chunk_size=64,
        param_dtype="float32",
        compute_dtype="float32",
    )
    if cfg.sliding_window is not None:
        kw["sliding_window"] = 32
    return dataclasses.replace(cfg, **kw)


__all__ = ["REGISTRY", "ARCH_IDS", "get_config", "reduced_config",
           "ModelConfig", "RLConfig"]
