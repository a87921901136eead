"""On-policy invariant enforcement (Proposition 1).

Every rollout group is tagged with the weight version under which it was
generated. In periodic-async (and sync) mode the trainer asserts that every
group consumed during iteration t carries version t — turning the paper's
proof obligation into a runtime check. The off-policy baseline instead
*measures* staleness, which is what its algorithm tolerates.
"""
from __future__ import annotations

import dataclasses

from repro_torch.core.queue import RolloutGroup


class OnPolicyViolation(AssertionError):
    pass


@dataclasses.dataclass
class OnPolicyMonitor:
    strict: bool = True
    checked: int = 0
    max_staleness_seen: int = 0

    def check(self, group: RolloutGroup, current_version: int) -> int:
        staleness = current_version - group.weight_version
        self.checked += 1
        self.max_staleness_seen = max(self.max_staleness_seen, staleness)
        if self.strict and staleness != 0:
            raise OnPolicyViolation(
                f"rollout group {group.uid} generated under version "
                f"{group.weight_version} but consumed at version "
                f"{current_version} — Proposition 1 violated")
        return staleness
