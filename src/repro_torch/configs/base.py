"""Model and run configuration, and the engine support matrix of the port.

``ModelConfig`` keeps the fields the ported paths read plus the capability
fields the support matrix needs to reject what the port does not run yet
(MLA, MoE, SSM/hybrid, enc-dec, VLM, sliding windows). ``RLConfig`` keeps
the fields the periodic-async GRPO pipeline reads.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    # identity ----------------------------------------------------------
    name: str = "unnamed"
    family: str = "dense"  # dense | moe | ssm | hybrid | audio | vlm
    source: str = ""       # citation (arXiv id / model card)

    # core transformer ---------------------------------------------------
    num_layers: int = 2
    d_model: int = 256
    num_heads: int = 4
    num_kv_heads: int = 4
    head_dim: int = 0          # 0 -> d_model // num_heads
    d_ff: int = 1024
    vocab_size: int = 1024
    rope_theta: float = 1e6
    norm_eps: float = 1e-5
    tie_embeddings: bool = False

    # capability fields (read by engine_support) --------------------------
    sliding_window: Optional[int] = None   # None -> full causal
    use_mla: bool = False
    num_experts: int = 0
    ssm_state_size: int = 0
    hybrid: bool = False
    is_encoder_decoder: bool = False
    vision_prefix_len: int = 0

    # numerics -----------------------------------------------------------------
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    # activation checkpointing per layer in training (paper Table 7)
    remat: bool = True
    # KV chunk of the plain (CPU) flash-attention version
    attn_chunk_size: int = 512
    # sequence chunk of token_logprobs: the (B, S, V) logits never exist
    loss_chunk_size: int = 512

    def __post_init__(self):
        if self.head_dim == 0 and self.num_heads:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)


# ---------------------------------------------------------------------
# Engine x family support matrix. Every engine construction site of the
# port consults this instead of hand-rolling family asserts, so the
# exclusion list lives in exactly one place.
# ---------------------------------------------------------------------

ROLLOUT_ENGINES = ("group", "paged")
SPEC_PLANE = "spec"
PREFIX_PLANE = "prefix"

_NOT_YET = "not ported to PyTorch yet (ROADMAP.md Queue 1)"


def engine_support(cfg: ModelConfig, engine: str) -> Tuple[bool, str]:
    """(supported, reason) for running ``cfg`` on ``engine`` in the port:
    the paged engine serves the dense GQA family; the spec and prefix
    planes and every other family wait for later slices."""
    if engine == SPEC_PLANE:
        return False, "speculative decode (draft/verify kernels) is " + _NOT_YET
    if engine == PREFIX_PLANE:
        return False, "the radix prefix cache is " + _NOT_YET
    if engine not in ROLLOUT_ENGINES:
        raise KeyError(f"unknown engine {engine!r}; known: "
                       f"{ROLLOUT_ENGINES + (SPEC_PLANE, PREFIX_PLANE)}")
    if engine == "group":
        return False, ("the group-at-a-time Sampler engine is " + _NOT_YET
                       + "; rollouts run on the paged engine")
    if cfg.family in ("ssm", "hybrid") or cfg.hybrid or cfg.ssm_state_size:
        return False, "SSM/hybrid recurrent state is " + _NOT_YET
    if cfg.is_encoder_decoder or cfg.vision_prefix_len:
        return False, "enc-dec and VLM prefixes are " + _NOT_YET
    if cfg.use_mla:
        return False, ("MLA latent pages and their decode kernels are "
                       + _NOT_YET)
    if cfg.num_experts or cfg.family != "dense":
        return False, "MoE feed-forward is " + _NOT_YET
    if cfg.sliding_window is not None:
        return False, ("sliding-window page reclamation is " + _NOT_YET)
    return True, "pages hold per-head K/V rows (dense GQA)"


def require_engine_support(cfg: ModelConfig, engine: str) -> None:
    # repro: allow(support-matrix): this IS the port's matrix enforcer; the engine name is its caller's literal
    ok, reason = engine_support(cfg, engine)
    if not ok:
        raise ValueError(f"{cfg.name}: engine {engine!r} is not applicable "
                         f"in the PyTorch port — {reason}")


@dataclasses.dataclass(frozen=True)
class RLConfig:
    """GRPO / periodic-asynchrony run configuration (paper Tables 7-9): the
    fields of the JAX package's ``RLConfig`` that the ported pipeline reads.
    The wire cast has no kernel flag: the tensor's device picks it."""
    group_size: int = 32               # answers per prompt (G)
    batch_prompts: int = 32            # prompts per iteration (N)
    micro_batch: int = 1               # samples per micro-step (m)
    kl_coef: float = 0.02
    clip_eps_low: float = 0.2
    clip_eps_high: float = 0.2
    temperature: float = 1.0
    top_p: float = 1.0
    learning_rate: float = 1e-6
    weight_decay: float = 0.01
    grad_clip: float = 1.0
    adam_b1: float = 0.9
    adam_b2: float = 0.95
    max_prompt_len: int = 128
    max_response_len: int = 128
    shared_prompt_attention: bool = False
    mode: str = "async"                # sync | async | async_offpolicy
    staleness_eta: int = 1             # off-policy baseline lookahead
    num_inference_instances: int = 4   # train:rollout ratio (paper: 1:4)
    # "paged" (token-level continuous batching over the page pool); the
    # "group" Sampler engine is not ported (require_engine_support raises)
    rollout_engine: str = "paged"
    cbatch_slots: int = 8              # decode slots per paged instance
    kv_page_size: int = 16             # tokens per KV page
    kv_pages: int = 0                  # physical pages (0 = auto-size)
    # rollout-time logprob capture: under Proposition 1 the captured values
    # are the old-policy logprobs, so the grad step runs one reference
    # forward instead of the stacked old+ref pair
    capture_logprobs: bool = True
    # weight-plane: bucket size, background streaming, and the payload
    # dtype ("" = the storage dtype, bitwise; "bfloat16" casts an f32 tree
    # on the wire through kernels/transfer_cast.py)
    transfer_bucket_bytes: int = 1 << 22
    transfer_overlap: bool = True
    transfer_wire_dtype: str = ""
    seed: int = 0
