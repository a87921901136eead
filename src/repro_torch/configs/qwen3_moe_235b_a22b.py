"""qwen3-moe-235b-a22b — 128 experts top-8 [hf:Qwen/Qwen3-235B-A22B family].

[moe] 94L d_model=4096 64H (GQA kv=4) d_ff=1536(per expert) vocab=151936,
MoE 128e top-8, no shared experts, no dense prelude.

The port serves its reduced form (``reduced_config``); at full width its
bf16 weights take about 470 GB, more than one card holds.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-235b-a22b",
    family="moe",
    source="hf:Qwen/Qwen3-30B-A3B",
    num_layers=94,
    d_model=4096,
    num_heads=64,
    num_kv_heads=4,
    head_dim=128,
    d_ff=1536,
    vocab_size=151936,
    num_experts=128,
    num_experts_per_tok=8,
    num_shared_experts=0,
    moe_d_ff=1536,
    first_k_dense=0,
    rope_theta=1e6,
)
