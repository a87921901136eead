"""AdamW with f32 optimizer state and global-norm gradient clipping — the
paper's optimization settings (Table 7): Adam(b1=0.9, b2=0.95), lr 1e-6,
weight decay 0.01, clip 1.0. The port of ``src/repro/optim/adam.py``.

Parameters are updated OUT OF PLACE, leaf by leaf: the tri-model's
``refresh_old`` makes ``old`` the same tensors as ``policy`` (JAX arrays
are immutable, so aliasing is free there), and an in-place update would
silently move ``old`` too. The moments ``mu``/``nu`` belong to the
optimizer alone — nothing aliases them — so they are updated in place,
which keeps two f32 trees out of the update's peak memory.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class AdamState(NamedTuple):
    step: int           # updates applied so far
    mu: dict            # f32 first moment (params tree)
    nu: dict            # f32 second moment


def _map(fn, *trees):
    first = trees[0]
    return {k: _map(fn, *(t[k] for t in trees)) if isinstance(first[k], dict)
            else fn(*(t[k] for t in trees)) for k in first}


def _leaves(tree):
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


def adam_init(params) -> AdamState:
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    return AdamState(step=0, mu=_map(zeros, params), nu=_map(zeros, params))


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(l.float()))
                          for l in _leaves(tree)))


def adam_update(params, grads, state: AdamState, *, lr: float,
                b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
                weight_decay: float = 0.01, grad_clip: float = 1.0):
    """Returns (new_params, new_state, metrics). ``params`` is left as it
    was; ``state``'s moments are advanced in place."""
    gnorm = global_norm(grads)
    scale = torch.clamp(grad_clip / torch.clamp(gnorm, min=1e-12), max=1.0)
    step = state.step + 1
    bc1 = 1.0 - b1 ** step
    bc2 = 1.0 - b2 ** step

    def upd(p, g, m, v):
        g = g.float() * scale
        m.mul_(b1).add_(g, alpha=1 - b1)
        v.mul_(b2).addcmul_(g, g, value=1 - b2)
        p32 = p.float()
        delta = (m / bc1) / (torch.sqrt(v / bc2) + eps) + weight_decay * p32
        return (p32 - lr * delta).to(p.dtype)

    new_p = _map(upd, params, grads, state.mu, state.nu)
    return new_p, AdamState(step, state.mu, state.nu), {"grad_norm": gnorm}
