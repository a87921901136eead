"""Architecture registry of the port: ``--arch <id>`` -> ModelConfig.

Only the architectures the port runs in some form are registered;
``get_config`` raises on every other id of the JAX registry. The two MoE
configs are registered as published: deepseek-v2-lite (MLA, 64 experts
top-6, 2 shared, one dense prelude layer) is served at full width,
qwen3-moe (GQA, 128 experts top-8) in its reduced form; both train.
"""
from __future__ import annotations

import dataclasses

from repro_torch.configs.base import ModelConfig, RLConfig
from repro_torch.configs.deepseek_v2_lite_16b import CONFIG as _dsv2lite
from repro_torch.configs.llama3p2_3b import CONFIG as _llama32
from repro_torch.configs.qwen3_moe_235b_a22b import CONFIG as _qwen3moe

REGISTRY: dict[str, ModelConfig] = {c.name: c for c in (_dsv2lite, _llama32,
                                                        _qwen3moe)}

ARCH_IDS = tuple(REGISTRY)


def get_config(name: str) -> ModelConfig:
    if name not in REGISTRY:
        raise KeyError(f"arch {name!r} is not ported to PyTorch yet; "
                       f"ported: {sorted(REGISTRY)}")
    return REGISTRY[name]


def long_context_variant(cfg: ModelConfig, window: int = 8192) -> ModelConfig:
    """Sub-quadratic decode variant for the long-context shapes
    (``decode_32k``, ``long_500k``): a full-attention config gets a
    sliding-window KV cache, whose paged engine reclaims out-of-window
    pages. SSM/hybrid configs (their state is already O(1)) and configs
    that already have a window come back unchanged."""
    if cfg.family in ("ssm", "hybrid") or cfg.sliding_window is not None:
        return cfg
    return dataclasses.replace(cfg, sliding_window=window)


def reduced_config(cfg: ModelConfig) -> ModelConfig:
    """CPU-smoke-testable variant of the same family: 2 layers,
    d_model <= 256, 64-wide heads, f32, and <= 4 experts or a 64-rank
    latent where the config has them (the dense, MoE and MLA branches of
    the JAX package's ``reduced_config``)."""
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
    if cfg.is_moe:
        kw.update(
            num_experts=4,
            num_experts_per_tok=2,
            num_shared_experts=min(cfg.num_shared_experts, 1),
            moe_d_ff=128,
            first_k_dense=min(cfg.first_k_dense, 1),
            dense_d_ff=256 if cfg.first_k_dense else 0,
        )
    if cfg.use_mla:
        kw.update(kv_lora_rank=64, qk_nope_head_dim=32, qk_rope_head_dim=16,
                  v_head_dim=32, head_dim=48)
    if cfg.sliding_window is not None:
        kw["sliding_window"] = 32
    return dataclasses.replace(cfg, **kw)


__all__ = ["REGISTRY", "ARCH_IDS", "get_config", "long_context_variant",
           "reduced_config", "ModelConfig", "RLConfig"]
