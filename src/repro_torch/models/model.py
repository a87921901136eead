"""Public model API of the port: init / forward / logits / per-token
log-probs.

``token_logprobs`` computes log p(label) chunk by chunk along the sequence,
so the (B, S, V) logits tensor never exists; each chunk's backward
recomputes its logits (``_ChunkLogprob``, the port of the JAX package's
``_chunk_logprob`` custom VJP). Its products are plain ``torch.matmul``, as
the JAX package leaves them to XLA."""
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


class _ChunkLogprob(torch.autograd.Function):
    """log p(y | h) for one sequence chunk, f32 logits. The backward
    recomputes the chunk's logits: d/dlogits = g * (onehot(y) - softmax)."""

    @staticmethod
    def forward(ctx, h_c, W, y_c):
        lg = h_c.float() @ W.float()                       # (B, C, V)
        lse = torch.logsumexp(lg, dim=-1)
        picked = torch.gather(lg, -1, y_c[..., None])[..., 0]
        ctx.save_for_backward(h_c, W, y_c)
        return picked - lse

    @staticmethod
    def backward(ctx, g):
        h_c, W, y_c = ctx.saved_tensors
        W32 = W.float()
        dlg = torch.softmax(h_c.float() @ W32, dim=-1)      # recompute
        dlg.mul_(-g[..., None])
        dlg.scatter_add_(-1, y_c[..., None], g[..., None])  # g * (onehot - p)
        dh = dlg @ W32.T
        dW = h_c.float().flatten(0, -2).T @ dlg.flatten(0, -2)
        return dh.to(h_c.dtype), dW.to(W.dtype), None


def token_logprobs(params: dict, cfg: ModelConfig, hidden: torch.Tensor,
                   labels: torch.Tensor) -> torch.Tensor:
    """hidden: (B, S, d); labels: (B, S) next-token ids aligned with hidden
    (labels[t] is the target predicted from hidden[t]). Returns (B, S)
    float32 log-probabilities, ``cfg.loss_chunk_size`` positions at a time."""
    W = lm_head_weight(params["embed"], cfg).to(hidden.dtype)
    labels = labels.long()
    S = hidden.shape[1]
    C = min(cfg.loss_chunk_size, S)
    return torch.cat([_ChunkLogprob.apply(hidden[:, c0:c0 + C], W,
                                          labels[:, c0:c0 + C])
                      for c0 in range(0, S, C)], dim=1)


def forward(params: dict, cfg: ModelConfig, tokens: torch.Tensor, **kw):
    """Full-logits forward (small models / tests). Returns (logits, caches)."""
    h, caches = forward_hidden(params, cfg, tokens, **kw)
    return logits(params, cfg, h), caches


__all__ = ["init", "forward", "forward_hidden", "init_caches",
           "init_paged_caches", "logits", "token_logprobs"]
