"""Unified tri-model state (paper §4.2.1, Figure 2), the port of
``src/repro/core/trimodel.py``.

Policy, old-policy and reference parameters share one layout. The
scheduler calls ``refresh_old`` (Algorithm 1 line 10) at the ITERATION
BOUNDARY — right after the weight-plane flips the rollout pool to the
(pre-update) policy and before any grad step — so during iteration t the
old policy holds exactly the weights that generate iteration t's rollouts.

``refresh_old`` makes ``old`` the very tensors of ``policy``, as the JAX
package does with immutable arrays: nothing in the port updates a
parameter in place (``optim/adam.py`` builds a new tree), so the alias is
safe and costs no memory.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

from repro_torch.optim.adam import AdamState, adam_init


def _copy(tree):
    return {k: _copy(v) if isinstance(v, dict) else v.clone()
            for k, v in tree.items()}


@dataclasses.dataclass
class TriModelState:
    policy: Any
    old: Any
    ref: Any
    opt: AdamState
    version: int = 0          # iteration t whose weights the policy holds

    @classmethod
    def create(cls, params) -> "TriModelState":
        return cls(policy=params, old=_copy(params), ref=_copy(params),
                   opt=adam_init(params), version=0)

    def refresh_old(self, expected_rollout_version: Optional[int] = None
                    ) -> None:
        """Algorithm 1 line 10: old <- policy (pre-update), at the
        iteration boundary after the pool weight sync. Passing the version
        the weight-plane just flipped the pool to turns "rollout weights ==
        old-policy weights" into an assertion."""
        assert (expected_rollout_version is None
                or expected_rollout_version == self.version), \
            f"boundary invariant broken: pool flipped to version " \
            f"{expected_rollout_version} but policy holds {self.version}"
        self.old = self.policy

    def apply_update(self, new_params, new_opt) -> None:
        """Algorithm 1 line 11: the accumulated-gradient update."""
        self.policy = new_params
        self.opt = new_opt
        self.version += 1
