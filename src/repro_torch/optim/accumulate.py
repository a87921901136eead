"""Micro-batch gradient accumulation (paper §3, Eq. 1), the port of
``src/repro/optim/accumulate.py``.

J_batch = (1/M) sum_i (1/m) sum_j (...) — the consumer accumulates
micro-batch gradients as rollouts arrive from the queue and applies one
parameter update per iteration. Commutativity of the finite sum is what
makes completion-order consumption gradient-equivalent (Remark 1). The sum
is the accumulator's own tree, so it grows in place.
"""
from __future__ import annotations


def _map(fn, *trees):
    first = trees[0]
    return {k: _map(fn, *(t[k] for t in trees)) if isinstance(first[k], dict)
            else fn(*(t[k] for t in trees)) for k in first}


class GradAccumulator:
    """O <- O + weight * grad(micro_batch); ``mean`` divides by the summed
    weight."""

    def __init__(self):
        self._sum = None
        self._weight = 0.0

    def add(self, grads, weight: float = 1.0) -> None:
        """weight = number of samples in the micro-batch, so unequal
        micro-batches still average to the exact full-batch mean."""
        if self._sum is None:
            self._sum = _map(lambda g: g.float() * weight, grads)
        else:
            _map(lambda a, g: a.add_(g.float(), alpha=weight), self._sum,
                 grads)
        self._weight += float(weight)

    def mean(self):
        if self._sum is None:
            raise ValueError("no gradients accumulated")
        w = self._weight
        return _map(lambda a: a / w, self._sum)

    def reset(self) -> None:
        self._sum = None
        self._weight = 0.0


__all__ = ["GradAccumulator"]
