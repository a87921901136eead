"""deepseek-v2-lite-16b — MLA + fine-grained MoE [arXiv:2405.04434].

[moe] 27L d_model=2048 16H (MLA kv_lora=512) d_ff=1408(per expert)
vocab=102400, 64 routed experts top-6 + 2 shared, first layer dense
(d_ff=10944). MLA: qk_nope=128, qk_rope=64, v_head=128 (no q-LoRA in lite).

The port serves and trains it as published (MoE on, the router trained by
its auxiliary load-balance loss); ``mla_dense`` in the README is the same
model with its six MoE fields zeroed.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v2-lite-16b",
    family="moe",
    source="arXiv:2405.04434",
    num_layers=27,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    head_dim=128,
    d_ff=1408,
    vocab_size=102400,
    use_mla=True,
    kv_lora_rank=512,
    q_lora_rank=0,
    qk_nope_head_dim=128,
    qk_rope_head_dim=64,
    v_head_dim=128,
    num_experts=64,
    num_experts_per_tok=6,
    num_shared_experts=2,
    moe_d_ff=1408,
    first_k_dense=1,
    dense_d_ff=10944,
    rope_theta=1e4,
)
