"""Hereditary constraints (counterpart of ``repro.core.constraints``).

This slice ports the trivial constraint only: the cardinality bound is the
greedy loop bound ``k``.  Knapsack, partition matroid, their intersection
and the NumPy feasibility checker come with ROADMAP queue 1 item 7.
"""
from __future__ import annotations

import dataclasses

import torch

# slack shared by the feasibility test and the NumPy checker — fp32 weight
# accumulation must not reject an exactly-at-budget set.
KNAPSACK_TOL = 1e-6


@dataclasses.dataclass(frozen=True)
class Unconstrained:
    """Only the cardinality bound of the greedy loop applies."""

    def init_state(self):
        return torch.tensor(0.0)

    def feasible(self, cstate, attrs: torch.Tensor) -> torch.Tensor:
        return torch.ones(attrs.shape[:-1], dtype=torch.bool,
                          device=attrs.device)

    def update(self, cstate, attrs, idx):
        return cstate

    def check_np(self, attrs, mask) -> tuple[bool, str]:
        return True, "unconstrained"
