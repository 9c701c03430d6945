"""Hereditary constraints (paper §3.2; counterpart of
``repro.core.constraints``).

A constraint ℐ is *hereditary* iff S ∈ ℐ implies every subset of S ∈ ℐ.
Theorem 3.5 shows Algorithm 1 with GREEDY achieves α/r for any hereditary ℐ.

Interface on a per-item attribute tensor ``attrs`` of shape
``(..., cap, a)`` carried alongside the item block, with a leading machine
axis where the block has one (the JAX package's ``vmap``, written out):

    cstate = c.init_state(batch, device)   # per-machine state
    feas   = c.feasible(cstate, attrs)     # (..., cap) bool: addable NOW?
    cstate = c.update(cstate, attrs, idx)  # commit item idx (...,)

``Knapsack`` state is ``batch`` fp32 (the weight used), ``PartitionMatroid``
state ``batch + (G,)`` int32 (the count per group).  Cardinality is the
greedy loop bound.  A partition group id outside ``[0, G)`` belongs to no
open group, so such an item is never feasible (the JAX package's gathers
clamp it instead; its NumPy checker rejects it, as here).

:func:`check_feasible` answers the set-level question in pure NumPy, with
no code shared with the selection loops — the independent checker the tree
selection and the tests run on every returned coreset.

The serve layer's :class:`DynamicKnapsack` / :class:`DynamicPartitionMatroid`
carry their parameters as tensors on the solve's device (a per-request
operand, never read by the host during a solve), so one captured solve
serves every budget and every set of caps.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch.kernels.ref import dynamic_limit, group_open, knapsack_limit

# slack shared by the feasibility test and the NumPy checker — fp32 weight
# accumulation must not reject an exactly-at-budget set.
KNAPSACK_TOL = 1e-6


@dataclasses.dataclass(frozen=True)
class Unconstrained:
    """Only the cardinality bound of the greedy loop applies."""

    def init_state(self, batch=(), device="cpu"):
        return torch.zeros(batch, dtype=torch.float32, device=device)

    def feasible(self, cstate, attrs: torch.Tensor) -> torch.Tensor:
        return torch.ones(attrs.shape[:-1], dtype=torch.bool,
                          device=attrs.device)

    def update(self, cstate, attrs, idx):
        return cstate

    def check_np(self, attrs, mask) -> tuple[bool, str]:
        return True, "unconstrained"


def _take(attrs: torch.Tensor, col: int, idx: torch.Tensor) -> torch.Tensor:
    """``attrs[..., idx, col]`` for one index per machine."""
    return torch.take_along_dim(attrs[..., col], idx.long()[..., None],
                                dim=-1)[..., 0]


@dataclasses.dataclass(frozen=True)
class Knapsack:
    """Σ_{i∈S} w_i ≤ budget, with w_i = attrs[i, col]."""

    budget: float
    col: int = 0

    def init_state(self, batch=(), device="cpu"):
        return torch.zeros(batch, dtype=torch.float32, device=device)

    def feasible(self, cstate, attrs):
        return (cstate[..., None] + attrs[..., self.col]
                <= knapsack_limit(self.budget))

    def update(self, cstate, attrs, idx):
        return cstate + _take(attrs, self.col, idx)

    def check_np(self, attrs: np.ndarray, mask: np.ndarray) -> tuple[bool, str]:
        used = float(np.asarray(attrs, np.float64)[mask, self.col].sum())
        k_sel = max(1, int(mask.sum()))
        # the selection admits items under `used32 + w <= budget + TOL` with
        # a sequentially rounded fp32 running sum, so a legitimate
        # selection's exact total can exceed the budget by the absolute
        # slack plus the accumulated fp32 rounding (~k·ulp of the running
        # magnitude); the checker's bar covers both
        rel = 4 * np.finfo(np.float32).eps * k_sel * max(abs(self.budget), used)
        ok = used <= self.budget + KNAPSACK_TOL * k_sel + rel
        return ok, f"knapsack used={used:.6f} budget={self.budget}"


@dataclasses.dataclass(frozen=True)
class PartitionMatroid:
    """≤ caps[g] items from each group g; group id = attrs[i, col] (int)."""

    caps: tuple[int, ...]
    col: int = 0

    def init_state(self, batch=(), device="cpu"):
        return torch.zeros(tuple(batch) + (len(self.caps),), dtype=torch.int32,
                           device=device)

    def feasible(self, cstate, attrs):
        caps = torch.as_tensor(self.caps, dtype=torch.int32,
                               device=attrs.device)
        return group_open(cstate, attrs[..., self.col].to(torch.int64), caps)

    def update(self, cstate, attrs, idx):
        gid = _take(attrs, self.col, idx).to(torch.int64)
        groups = torch.arange(len(self.caps), device=cstate.device)
        return cstate + (groups == gid[..., None]).to(cstate.dtype)

    def check_np(self, attrs: np.ndarray, mask: np.ndarray) -> tuple[bool, str]:
        gid = np.asarray(attrs)[mask, self.col].astype(np.int64)
        # out-of-range ids are an infeasibility verdict, not a crash
        if gid.size and (gid.min() < 0 or gid.max() >= len(self.caps)):
            return False, (f"partition ids outside [0, {len(self.caps)}): "
                           f"{sorted(set(gid.tolist()))}")
        counts = np.bincount(gid, minlength=len(self.caps))
        ok = bool((counts <= np.asarray(self.caps)).all())
        return ok, f"partition counts={counts.tolist()} caps={list(self.caps)}"


@dataclasses.dataclass(frozen=True, eq=False)
class DynamicKnapsack:
    """:class:`Knapsack` with the budget as a ``()`` fp32 tensor on the
    solve's device (counterpart of ``repro.core.constraints.
    DynamicKnapsack``).  Its limit is ``budget + KNAPSACK_TOL`` as one fp32
    add on the device, the JAX class's arithmetic: it equals the static
    class's ``knapsack_limit`` (one rounding of the double sum) for every
    budget but fp32 budgets below about 2⁻¹⁸ (ROADMAP queue 3)."""

    budget: torch.Tensor   # () fp32
    col: int = 0

    def init_state(self, batch=(), device="cpu"):
        return torch.zeros(batch, dtype=torch.float32, device=device)

    def feasible(self, cstate, attrs):
        return (cstate[..., None] + attrs[..., self.col]
                <= dynamic_limit(self.budget))

    def update(self, cstate, attrs, idx):
        return cstate + _take(attrs, self.col, idx)

    def check_np(self, attrs, mask) -> tuple[bool, str]:
        return Knapsack(float(self.budget), self.col).check_np(attrs, mask)


@dataclasses.dataclass(frozen=True, eq=False)
class DynamicPartitionMatroid:
    """:class:`PartitionMatroid` with the caps as a ``(G,)`` int32 tensor
    on the solve's device (counterpart of ``repro.core.constraints.
    DynamicPartitionMatroid``); G, a shape, stays static."""

    caps: torch.Tensor     # (G,) int32
    col: int = 0

    def init_state(self, batch=(), device="cpu"):
        return torch.zeros(tuple(batch) + (self.caps.shape[0],),
                           dtype=torch.int32, device=device)

    def feasible(self, cstate, attrs):
        return group_open(cstate, attrs[..., self.col].to(torch.int64),
                          self.caps.to(torch.int32))

    def update(self, cstate, attrs, idx):
        gid = _take(attrs, self.col, idx).to(torch.int64)
        groups = torch.arange(self.caps.shape[0], device=cstate.device)
        return cstate + (groups == gid[..., None]).to(cstate.dtype)

    def check_np(self, attrs, mask) -> tuple[bool, str]:
        caps = tuple(int(c) for c in self.caps.cpu().tolist())
        return PartitionMatroid(caps, self.col).check_np(attrs, mask)


@dataclasses.dataclass(frozen=True)
class Intersection:
    """Intersection of hereditary constraints is hereditary."""

    parts: tuple[Any, ...]

    def init_state(self, batch=(), device="cpu"):
        return tuple(p.init_state(batch, device) for p in self.parts)

    def feasible(self, cstate, attrs):
        feas = torch.ones(attrs.shape[:-1], dtype=torch.bool,
                          device=attrs.device)
        for p, s in zip(self.parts, cstate):
            feas = feas & p.feasible(s, attrs)
        return feas

    def update(self, cstate, attrs, idx):
        return tuple(p.update(s, attrs, idx)
                     for p, s in zip(self.parts, cstate))

    def check_np(self, attrs: np.ndarray, mask: np.ndarray) -> tuple[bool, str]:
        oks, msgs = zip(*(p.check_np(attrs, mask) for p in self.parts))
        return all(oks), " & ".join(msgs)


# ---------------------------------------------------------------------------
# independent NumPy verification + spec parsing
# ---------------------------------------------------------------------------


def check_feasible(constraint, attrs, mask) -> tuple[bool, str]:
    """Set-level feasibility of a selected coreset, pure NumPy.

    ``attrs``: (k, a) per-item attribute rows of the selection (zero rows on
    padding slots are fine — only ``mask``-True rows are inspected).  Returns
    ``(ok, detail)``; callers assert ``ok`` and surface ``detail``.
    """
    if constraint is None:
        return True, "unconstrained"
    attrs = np.asarray(attrs)
    mask = np.asarray(mask, bool)
    if attrs.ndim != 2 or attrs.shape[0] != mask.shape[0]:
        return False, f"attrs shape {attrs.shape} vs mask {mask.shape}"
    return constraint.check_np(attrs, mask)


def attr_dim(constraint) -> int:
    """Smallest attribute width the constraint's columns require (0 = none)."""
    if constraint is None or isinstance(constraint, Unconstrained):
        return 0
    if isinstance(constraint, Intersection):
        return max((attr_dim(p) for p in constraint.parts), default=0)
    return constraint.col + 1


def from_spec(spec: str):
    """Parse a CLI constraint spec into a constraint object.

    Grammar (colon-separated ``key=value`` after the class name):
      ``knapsack:budget=2.5[:col=0]``
      ``partition:caps=2,3,4[:col=0]``
      ``intersection:<spec>+<spec>``        (``+``-joined sub-specs)
    """
    spec = spec.strip()
    name, _, rest = spec.partition(":")
    if name == "intersection":
        return Intersection(tuple(from_spec(s) for s in rest.split("+")))
    kv = {}
    for part in filter(None, rest.split(":")):
        k, _, v = part.partition("=")
        kv[k.strip()] = v.strip()
    if name == "knapsack":
        return Knapsack(budget=float(kv["budget"]), col=int(kv.get("col", 0)))
    if name == "partition":
        caps = tuple(int(c) for c in kv["caps"].split(","))
        return PartitionMatroid(caps=caps, col=int(kv.get("col", 0)))
    if name in ("none", "unconstrained", ""):
        return None
    raise ValueError(f"unknown constraint spec {spec!r}")


constraint_from_spec = from_spec   # package-level export name
