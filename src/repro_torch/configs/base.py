"""Model and run configuration, and the engine support matrix of the port.

``ModelConfig`` keeps the fields the ported paths read plus the capability
fields the support matrix needs to reject what the port does not run yet
(SSM/hybrid, enc-dec, VLM). ``RLConfig``
keeps the fields the periodic-async GRPO pipeline reads.
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

    # attention variants ---------------------------------------------------
    sliding_window: Optional[int] = None   # None -> full causal
    use_mla: bool = False                  # DeepSeek-V2 multi-head latent attention
    kv_lora_rank: int = 512
    q_lora_rank: int = 0                   # 0 -> full-rank q projection
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128

    # MoE (served and trained) -----------------------------------------------
    num_experts: int = 0                   # 0 -> dense FFN
    num_experts_per_tok: int = 0
    num_shared_experts: int = 0
    moe_d_ff: int = 0                      # per-expert hidden size
    first_k_dense: int = 0                 # leading dense layers (DeepSeek-V2)
    dense_d_ff: int = 0                    # d_ff of those dense layers
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.001

    # other capability fields (read by engine_support) ----------------------
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

    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0


# ---------------------------------------------------------------------
# Engine x family support matrix. Every engine construction site of the
# port consults this instead of hand-rolling family asserts, so the
# exclusion list lives in exactly one place.
# ---------------------------------------------------------------------

ROLLOUT_ENGINES = ("group", "cbatch", "paged")
SPEC_PLANE = "spec"
PREFIX_PLANE = "prefix"
TRAIN_PLANE = "train"
_PLANES = (SPEC_PLANE, PREFIX_PLANE, TRAIN_PLANE)

_NOT_YET = "not ported to PyTorch yet (ROADMAP.md Queue 1)"


def engine_support(cfg: ModelConfig, engine: str, *,
                   rollout_engine: str = "paged") -> Tuple[bool, str]:
    """(supported, reason) for running ``cfg`` on ``engine`` in the port.
    The three rollout engines, the paged engine, the group-at-a-time
    Sampler and the dense-slot continuous-batching engine (``cbatch``),
    run GQA and MLA attention, each with a dense or a MoE feed-forward
    and with or without a sliding window (the paged engine reclaims
    out-of-window pages, the dense engines keep a ring of the window's
    length); every other family waits for later slices. The spec plane
    rides every engine (the SpecSampler on ``group``); the prefix plane
    rides the paged engine only (``rollout_engine`` names the engine a
    plane is asked for); training (the ``"train"`` plane, which
    ``build_pipeline`` asks) takes any engine's rollouts."""
    if engine in _PLANES:
        if rollout_engine != "paged" and engine == PREFIX_PLANE:
            return False, ("the radix prefix cache shares pages of the "
                           "paged pool; the dense engines' caches have "
                           "none")
        ok, reason = engine_support(cfg, "paged")
        if not ok:
            return ok, reason
        moe = " (MoE routed per forward, as in the JAX engine)" \
            if cfg.is_moe else ""
        windowed = cfg.sliding_window is not None
        if engine == SPEC_PLANE:
            if rollout_engine != "paged":
                win = (", incl. sliding-window (a ring of window + k + 1 "
                       "slots)" if windowed else "")
                return True, ("a rejected draft's dense-cache entries sit "
                              "past the frontier until the next block "
                              "overwrites them" + win + moe)
            win = (", incl. sliding-window (speculative pages respect "
                   "reclamation)" if windowed else "")
            return True, ("a rejected draft's speculative pages roll back "
                          "to the freelist" + win + moe)
        if engine == PREFIX_PLANE:
            kind = "MLA latent" if cfg.use_mla else "K/V"
            win = (" (window-dead leading pages are never cached)"
                   if windowed else "")
            return True, (f"cached {kind} prompt pages are shared across "
                          "requests" + win + moe)
        win = (f", every query masked to its {cfg.sliding_window}-token "
               "window" if windowed else "")
        if cfg.is_moe:
            return True, ("the router's auxiliary load-balance loss joins "
                          "the GRPO loss and trains the router, as in the "
                          "JAX package" + win + moe)
        if cfg.use_mla:
            return True, ("MLA's expanded attention trains through "
                          "autograd, as the JAX package's does" + win)
        return True, "the SPA kernel and its backward carry training" + win
    if engine not in ROLLOUT_ENGINES:
        raise KeyError(f"unknown engine {engine!r}; known: "
                       f"{ROLLOUT_ENGINES + _PLANES}")
    if cfg.family in ("ssm", "hybrid") or cfg.hybrid or cfg.ssm_state_size:
        return False, "SSM/hybrid recurrent state is " + _NOT_YET
    if cfg.is_encoder_decoder or cfg.vision_prefix_len:
        return False, "enc-dec and VLM prefixes are " + _NOT_YET
    ffn = "MoE" if cfg.is_moe else "dense"
    kind = "MLA" if cfg.use_mla else "GQA"
    if engine == "group":
        win = ("; sliding-window: a ring of the window's length"
               if cfg.sliding_window is not None else "")
        rows = "(ckv, kr) latent rows" if cfg.use_mla else "per-head K/V rows"
        return True, (f"one dense cache of {rows} a row, decoded in lock "
                      f"step ({kind}, {ffn} FFN){win}")
    if engine == "cbatch":
        win = ("; sliding-window: a ring of the window's length a slot"
               if cfg.sliding_window is not None else "")
        return True, (f"fixed slot pool over one contiguous cache ({kind}, "
                      f"{ffn} FFN){win}")
    win = ("; sliding-window: out-of-window pages are reclaimed to the "
           "freelist" if cfg.sliding_window is not None else "")
    if cfg.use_mla:
        return True, f"pages hold (ckv, kr) latent rows (MLA, {ffn} FFN){win}"
    return True, f"pages hold per-head K/V rows (GQA, {ffn} FFN){win}"


def require_engine_support(cfg: ModelConfig, engine: str, *,
                           rollout_engine: str = "paged") -> None:
    # repro: allow(support-matrix): this IS the port's matrix enforcer; the engine name is its caller's literal
    ok, reason = engine_support(cfg, engine, rollout_engine=rollout_engine)
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
    # "paged" (token-level continuous batching over the page pool) or
    # "group" (the group-at-a-time Sampler over a dense cache, the only
    # engine of the async_offpolicy baseline; with spec_decode the
    # SpecSampler); "cbatch" trains as "group" does, as in the JAX
    # package. The JAX package defaults to "group"; the port keeps
    # "paged", its main path
    rollout_engine: str = "paged"
    cbatch_slots: int = 8              # decode slots per paged instance
    kv_page_size: int = 16             # tokens per KV page
    kv_pages: int = 0                  # physical pages (0 = auto-size)
    # speculative decode (the paged engine, or the SpecSampler on the
    # group engine): draft spec_k tokens, verify them in ONE k+1-token
    # forward, accept by rejection sampling (distribution-exact:
    # Proposition 1 holds)
    spec_decode: bool = False
    spec_k: int = 4                    # drafted tokens per verify step
    # draft provider: "prompt_lookup" (n-gram reuse of prompt/response
    # tokens, no extra model) or "model" (a small resident draft model)
    spec_draft: str = "prompt_lookup"
    spec_ngram: int = 3                # longest n-gram the lookup tries
    # radix prefix cache on the paged engine: prompts sharing a token-span
    # prefix share its cached pages and prefill only their suffix
    prefix_cache: bool = False
    # device-resident decode loop: the paged engine runs D decode steps a
    # block (one CUDA-graph replay on the card) and drains its tokens to
    # the host once per block, dispatching block n + 1 before block n is
    # read. 1 drains every step. Tokens do not depend on D (per-row,
    # per-step counter-based draws).
    decode_drain_interval: int = 1
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
