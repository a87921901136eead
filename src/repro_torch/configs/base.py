"""Model configuration and the engine support matrix of the port.

``ModelConfig`` keeps the fields the ported paths read plus the capability
fields the support matrix needs to reject what the port does not run yet
(MLA, MoE, SSM/hybrid, enc-dec, VLM, sliding windows).
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

    def __post_init__(self):
        if self.head_dim == 0 and self.num_heads:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)


# ---------------------------------------------------------------------
# Engine x family support matrix. Every engine construction site of the
# port consults this instead of hand-rolling family asserts, so the
# exclusion list lives in exactly one place.
# ---------------------------------------------------------------------

ROLLOUT_ENGINES = ("paged",)
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
