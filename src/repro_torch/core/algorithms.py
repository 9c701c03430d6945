"""β-nice single-machine algorithms (counterpart of ``repro.core.algorithms``).

Every algorithm takes a ``(cap, d)`` block or a ``(M, cap, d)`` stack of
machine blocks with a matching validity mask, and returns at most ``k``
selected block positions per machine.  The leading machine axis is JAX's
``vmap`` written out: one call solves every machine of a round.

This slice ports :func:`greedy` (1-nice, lowest-index tie-breaking), with
both the step-wise scan and the fused single-call path.  The other three
names of :data:`ALGORITHM_KWARGS` raise until ROADMAP queue 1 item 8.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.constraints import Unconstrained

NEG_INF = -1e30


class SelectResult(NamedTuple):
    """Result of a selection run (leading machine axis where T had one)."""

    sel_idx: torch.Tensor       # (..., k) int64 block positions, -1 unused
    sel_mask: torch.Tensor      # (..., k) bool
    value: torch.Tensor         # (...,) f(selected)
    oracle_calls: torch.Tensor  # (...,) int64 marginal-gain evaluations
    depth: torch.Tensor         # (...,) int64 sequential solve depth: the
    #   dependent argmax steps the solve cannot parallelise away (k here)


def _fusable(obj, constraint, attrs) -> bool:
    """May the fused selection replace the step-wise scan?  Unconstrained
    selection fuses whenever the objective exposes ``fused_select``; the
    fused constraint encodings come with ROADMAP queue 1 item 7."""
    if not (getattr(obj, "rowwise_gains", False)
            and hasattr(obj, "fused_select")):
        return False
    if constraint is None or isinstance(constraint, Unconstrained):
        return attrs is None
    return False


def _reject_constraint(constraint, attrs) -> None:
    if (constraint is not None and not isinstance(constraint, Unconstrained)
            or attrs is not None):
        raise NotImplementedError(
            "constrained selection is not ported yet: ROADMAP queue 1 item 7 "
            "(constraints)")


def greedy(obj, T: torch.Tensor, mask: torch.Tensor, k: int, *,
           constraint=None, attrs=None, fused: bool | None = None,
           qmeta=None) -> SelectResult:
    """Classic greedy with consistent (lowest-index) tie-breaking.

    ``fused=None`` (auto) routes unconstrained selection through the
    objective's ``fused_select`` hook (``ops.greedy_select``: one call for
    the whole k-step loop on every machine); ``fused=False`` forces the
    step-wise scan, ``fused=True`` asserts the fast path.
    """
    _reject_constraint(constraint, attrs)
    if qmeta is not None:
        raise NotImplementedError("quantized blocks are not ported yet: "
                                  "ROADMAP queue 1 item 10 (narrow operands)")
    batch = T.shape[:-2]
    depth = torch.full(batch, k, dtype=torch.long, device=T.device)
    if fused is None:
        fused = _fusable(obj, constraint, attrs)
    if fused:
        assert _fusable(obj, constraint, attrs), (
            "fused=True needs a rowwise objective with a fused_select hook "
            "and an unconstrained selection")
        sel_idx, sel_mask, value, calls = obj.fused_select(T, mask, k)
        return SelectResult(sel_idx, sel_mask, value, calls, depth)

    state = obj.init_state(T, mask)
    avail = mask.bool()
    calls = torch.zeros(batch, dtype=torch.long, device=T.device)
    sel_idx, sel_mask = [], []
    for _ in range(k):
        cand = avail
        gains = obj.gains(state, T, cand)
        best = torch.argmax(gains, dim=-1)              # lowest index on ties
        ok = torch.take_along_dim(gains, best[..., None], dim=-1)[..., 0] \
            > NEG_INF / 2                               # any candidate at all?
        new = obj.update(state, T, best)
        state = {key: torch.where(ok.reshape(ok.shape + (1,) * (
            new[key].dim() - ok.dim())), new[key], state[key]) for key in state}
        hit = torch.nn.functional.one_hot(best, T.shape[-2]).bool()
        avail = avail & ~(ok[..., None] & hit)
        calls = calls + torch.sum(cand.long(), dim=-1)
        sel_idx.append(torch.where(ok, best, torch.full_like(best, -1)))
        sel_mask.append(ok)
    return SelectResult(torch.stack(sel_idx, dim=-1),
                        torch.stack(sel_mask, dim=-1), obj.value(state),
                        calls, depth)


#: kwargs each algorithm consumes; anything else passed explicitly to
#: :func:`run_algorithm` is an error, not a silent no-op.
ALGORITHM_KWARGS = {
    "greedy": frozenset({"constraint", "attrs", "fused", "qmeta"}),
    "stochastic_greedy": frozenset({"key", "eps", "constraint", "attrs",
                                    "qmeta"}),
    "threshold_greedy": frozenset({"eps", "constraint", "attrs", "qmeta"}),
    "threshold_batch": frozenset({"eps", "constraint", "attrs", "qmeta"}),
}


def driver_kwargs(name: str, *, key=None, eps=None) -> dict:
    """The subset of uniform driver state (key, ε) the named algorithm
    accepts; unknown names return ``{}`` — :func:`run_algorithm` owns that
    error."""
    allowed = ALGORITHM_KWARGS.get(name, frozenset())
    kw = {}
    if "key" in allowed and key is not None:
        kw["key"] = key
    if "eps" in allowed and eps is not None:
        kw["eps"] = eps
    return kw


def run_algorithm(name: str, obj, T, mask, k, *, key=None, eps=None,
                  constraint=None, attrs=None, fused: bool | None = None,
                  qmeta=None) -> SelectResult:
    """Dispatch to a selection algorithm by name, rejecting misuse.

    Unknown names and algorithm-inapplicable kwargs (a ``key`` for anything
    but stochastic_greedy, ``eps`` for plain greedy, ``fused`` for anything
    but greedy) raise ``ValueError``.
    """
    allowed = ALGORITHM_KWARGS.get(name)
    if allowed is None:
        raise ValueError(
            f"unknown algorithm {name!r}; expected one of "
            f"{sorted(ALGORITHM_KWARGS)}")
    extras = [n for n, v in (("key", key), ("eps", eps), ("fused", fused))
              if v is not None and n not in allowed]
    if extras:
        raise ValueError(
            f"algorithm {name!r} does not accept {extras} "
            f"(it takes {sorted(allowed)})")
    if name == "greedy":
        return greedy(obj, T, mask, k, constraint=constraint, attrs=attrs,
                      fused=fused, qmeta=qmeta)
    raise NotImplementedError(
        f"algorithm {name!r} is not ported yet: ROADMAP queue 1 item 8 "
        "(remaining algorithms)")
