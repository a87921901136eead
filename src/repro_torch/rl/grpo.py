"""GRPO with the tri-model forward (paper §4.2.1, Figure 2), the port of
``src/repro/rl/grpo.py``.

A micro-step computes three per-token log-probs: policy (with grad),
old-policy and reference. The JAX package fuses the no-grad old+ref pair
into one program by a vmap over the two stacked parameter trees; stacking
would copy both trees here, so the port runs the two no-grad forwards one
after the other under ``torch.no_grad``.

Loss (PPO-clip + k3 KL penalty, paper Eq. 1 / Table 8):
    J = E_t[ min(r_t A, clip(r_t, 1-eps_l, 1+eps_h) A) - beta * KL_t ]
    KL_t = exp(ref - pol) - (ref - pol) - 1        (k3 estimator, >= 0)
"""
from __future__ import annotations

import collections
from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, RLConfig
from repro_torch.models import forward_hidden, token_logprobs
from repro_torch.models.transformer import layer, num_prelude
from repro_torch.optim.adam import adam_update


class MicroBatch(NamedTuple):
    """One micro-batch of packed samples (SPA-packed or plain), as numpy
    arrays from the packers or tensors after ``to_device``.

    ``loss_mask`` carries per-token loss WEIGHTS (1/len(sample) on that
    sample's label positions, 0 elsewhere), so the loss is the exact
    per-sample token-mean however samples share rows; the micro-batch loss
    is sum(per_token * weight) / n_samples."""
    tokens: object           # (m, S) int32
    labels: object           # (m, S) int32 — next-token ids
    positions: object        # (m, S) int32
    segments: object         # (m, S) int32 — 0 = prompt/shared, k = response k
    loss_mask: object        # (m, S) f32 — per-token loss weights
    advantages: object       # (m, S) f32 — group-normalised, per token
    n_samples: float = 1.0   # number of packed samples
    # (m, S) f32 rollout-captured behavior logprobs on label positions (0
    # elsewhere), or None when the rollouts carried no capture
    logp_behavior: Optional[object] = None


def to_device(mb: MicroBatch, device) -> MicroBatch:
    """Host-packed (numpy) micro-batch -> tensors on ``device``; a missing
    ``logp_behavior`` stays None."""
    def move(a):
        return None if a is None else torch.as_tensor(np.asarray(a)).to(device)
    return mb._replace(tokens=move(mb.tokens), labels=move(mb.labels),
                       positions=move(mb.positions),
                       segments=move(mb.segments),
                       loss_mask=move(mb.loss_mask),
                       advantages=move(mb.advantages),
                       n_samples=float(mb.n_samples),
                       logp_behavior=move(mb.logp_behavior))


def group_advantages(rewards, eps: float = 1e-4) -> torch.Tensor:
    """GRPO advantages: per-group standardised rewards (population std).
    rewards: (G,). Returns (G,) float32."""
    r = torch.as_tensor(np.asarray(rewards, np.float32))
    return (r - r.mean()) / (r.std(correction=0) + eps)


def _model_logprobs(params, cfg: ModelConfig, mb: MicroBatch, *,
                    want_aux: bool = False):
    """Per-token log-probs (m, S); with ``want_aux`` (log-probs, the
    forward's summed MoE load-balance loss). Capacity is sized from the
    micro-batch's m x S tokens, as in the JAX grad step."""
    out = forward_hidden(params, cfg, mb.tokens, positions=mb.positions,
                         segments=mb.segments, want_aux=want_aux)
    logp = token_logprobs(params, cfg, out[0], mb.labels)
    return (logp, out[2]) if want_aux else logp


def trimodel_ref_old_logprobs(old_params, ref_params, cfg: ModelConfig,
                              mb: MicroBatch):
    """The no-grad old and reference forwards. Returns (old, ref)."""
    with torch.no_grad():
        return (_model_logprobs(old_params, cfg, mb),
                _model_logprobs(ref_params, cfg, mb))


def grpo_loss(policy_params, cfg: ModelConfig, rl: RLConfig, mb: MicroBatch,
              logp_old, logp_ref):
    """Returns (loss, metrics); metrics are 0-d tensors. The loss carries
    the policy forward's MoE load-balance loss (0 for a dense model), which
    trains the routers as in the JAX package."""
    logp, aux = _model_logprobs(policy_params, cfg, mb, want_aux=True)
    ratio = torch.exp(logp - logp_old)
    clipped = torch.clamp(ratio, 1.0 - rl.clip_eps_low, 1.0 + rl.clip_eps_high)
    adv = mb.advantages
    surr = torch.minimum(ratio * adv, clipped * adv)
    d = logp_ref - logp
    kl = torch.exp(d) - d - 1.0
    per_tok = surr - rl.kl_coef * kl
    j = (per_tok * mb.loss_mask).sum() / max(float(mb.n_samples), 1.0)
    loss = -j + aux
    hard_mask = (mb.loss_mask > 0).float()
    denom = torch.clamp(hard_mask.sum(), min=1.0)
    metrics = {
        "loss": loss.detach(),
        "kl": ((kl * hard_mask).sum() / denom).detach(),
        "ratio_mean": ((ratio * hard_mask).sum() / denom).detach(),
        "aux": aux.detach(),
        "n_tokens": hard_mask.sum(),
    }
    return loss, metrics


def _per_layer_leaves(params: dict, cfg: ModelConfig):
    """Leaves to differentiate: every top-level leaf detached, and each
    stacked layer tree (the dense ``prelude``'s ``num_prelude`` layers and
    the ``layers`` body's rest) split into one dict of detached views per
    layer, so each layer's gradient is its own tensor: a gradient through
    the views of one stacked leaf would materialise a full-size zero
    tensor per layer (an f32 deepseek-v2-lite expert leaf holds 738 MB a
    layer). No parameter is copied."""
    def detach(tree):
        return {k: detach(v) if isinstance(v, dict)
                else v.detach().requires_grad_() for k, v in tree.items()}
    n_pre = num_prelude(cfg)
    counts = {"prelude": n_pre, "layers": cfg.num_layers - n_pre}
    return {k: [detach(layer(v, i)) for i in range(counts[k])]
            if k in counts else detach(v) for k, v in params.items()}


def _flat(tree):
    if isinstance(tree, list):
        for t in tree:
            yield from _flat(t)
    elif isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat(tree[k])
    else:
        yield tree


def _stacked_grads(leaves: dict, grads: list) -> dict:
    """The gradient tree in the parameters' layout (the prelude and the
    body stacked again). Given the deque it pops from, each per-layer
    gradient is dropped once its leaf is stacked: the gradient is held
    once, plus one stacked leaf, where a list would hold it twice."""
    if not isinstance(grads, collections.deque):
        grads = collections.deque(grads)

    def rebuild(tree):
        if isinstance(tree, list):
            return _stack([rebuild(t) for t in tree])
        if isinstance(tree, dict):
            return {k: rebuild(tree[k]) for k in sorted(tree)}
        return grads.popleft()
    return rebuild(leaves)


def _stack(per_layer: list):
    """Stacks per-layer trees leaf by leaf, emptying them as it goes."""
    if isinstance(per_layer[0], dict):
        return {k: _stack([p.pop(k) for p in per_layer])
                for k in list(per_layer[0])}
    return torch.stack(per_layer)


def _value_and_grad(policy_params, cfg, rl, mb, logp_old, logp_ref):
    leaves = _per_layer_leaves(policy_params, cfg)
    with torch.enable_grad():
        loss, metrics = grpo_loss(leaves, cfg, rl, mb, logp_old, logp_ref)
        grads = collections.deque(
            torch.autograd.grad(loss, list(_flat(leaves))))
    return _stacked_grads(leaves, grads), metrics


def make_grad_step(cfg: ModelConfig, rl: RLConfig):
    """grad_step(policy, old, ref, mb) -> (grads, metrics): the stacked-
    tree gradient of the GRPO loss with old and reference log-probs from
    the two no-grad forwards. The consumer accumulates these over the
    rollouts of an iteration (Algorithm 1, lines 7-9)."""

    def grad_step(policy_params, old_params, ref_params, mb: MicroBatch):
        logp_old, logp_ref = trimodel_ref_old_logprobs(old_params, ref_params,
                                                       cfg, mb)
        return _value_and_grad(policy_params, cfg, rl, mb, logp_old, logp_ref)

    return grad_step


def make_grad_step_captured(cfg: ModelConfig, rl: RLConfig):
    """Capture-path grad step: the ratio's denominator is
    ``mb.logp_behavior`` — the logprobs the rollout engine evaluated while
    sampling — so the no-grad pass is a single reference forward. Same
    signature as ``make_grad_step``; ``old_params`` is accepted and
    unused."""

    def grad_step(policy_params, old_params, ref_params, mb: MicroBatch):
        del old_params                   # behavior logprobs ride the batch
        with torch.no_grad():
            logp_ref = _model_logprobs(ref_params, cfg, mb)
        return _value_and_grad(policy_params, cfg, rl, mb, mb.logp_behavior,
                               logp_ref)

    return grad_step


def make_apply_update(cfg: ModelConfig, rl: RLConfig):
    def apply_update(policy_params, opt_state, grads):
        return adam_update(policy_params, grads, opt_state,
                           lr=rl.learning_rate, b1=rl.adam_b1, b2=rl.adam_b2,
                           weight_decay=rl.weight_decay,
                           grad_clip=rl.grad_clip)
    return apply_update
