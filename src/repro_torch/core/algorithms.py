"""β-nice single-machine algorithms (counterpart of ``repro.core.algorithms``).

Every algorithm takes a ``(cap, d)`` block or a ``(M, cap, d)`` stack of
machine blocks with a matching validity mask, and returns at most ``k``
selected block positions per machine.  The leading machine axis is JAX's
``vmap`` written out: one call solves every machine of a round.

:func:`greedy` (1-nice, lowest-index tie-breaking; the step-wise scan
under any hereditary constraint and the fused path under the knapsack /
partition-matroid encodings), :func:`stochastic_greedy` (a random sample
of candidates a step, its draws from the round plan),
:func:`threshold_greedy` (descending thresholds, swept take by take) and
:func:`threshold_batch` (the low-adaptivity τ-ladder), all on narrow
blocks (``qmeta``: a streaming round 0's bf16 or int8 waves).
"""
from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch

from repro_torch.core.constraints import (DynamicKnapsack,
                                          DynamicPartitionMatroid,
                                          Intersection, Knapsack,
                                          PartitionMatroid, Unconstrained)
from repro_torch.kernels import ref

NEG_INF = -1e30


class SelectResult(NamedTuple):
    """Result of a selection run (leading machine axis where T had one)."""

    sel_idx: torch.Tensor       # (..., k) int64 block positions, -1 unused
    sel_mask: torch.Tensor      # (..., k) bool
    value: torch.Tensor         # (...,) f(selected)
    oracle_calls: torch.Tensor  # (...,) int64 marginal-gain evaluations
    depth: torch.Tensor         # (...,) int64 sequential solve depth: the
    #   dependent launches the solve cannot parallelise away: k for greedy
    #   and stochastic_greedy, 1 + τ-levels for the threshold algorithms


def _dequant_block(T: torch.Tensor, qmeta) -> torch.Tensor:
    """Narrow candidate block → fp32 (the upcast for fp32 and bf16).

    ``qmeta`` ``(..., cap, qcols)`` holds the per-row dequant parameters a
    source served out of band (scale, zero-point for int8; zero columns
    for bf16).  The scan dequantizes once up front, so its rows are the
    bits the fused kernels' in-kernel dequant gives the same bytes.
    """
    if qmeta is not None and qmeta.shape[-1] >= 2:
        return ref.dequantize_rows(T, qmeta[..., 0], qmeta[..., 1])
    return T.float()


def _fused_quant_kwargs(qmeta) -> dict:
    """The fused hooks' ``x_scale``/``x_zp`` of a quantized block."""
    if qmeta is None or qmeta.shape[-1] < 2:
        return {}
    return {"x_scale": qmeta[..., 0], "x_zp": qmeta[..., 1]}


def _fused_parts(constraint) -> tuple | None:
    """Decompose a constraint into fused-encodable parts, or None.

    Fused encodings exist for :class:`Knapsack` (one running used weight)
    and :class:`PartitionMatroid` (one running count per group); an
    :class:`Intersection` of at most one of each composes (masks AND = the
    scan's conjunction).  Anything else — two of a kind, nested
    intersections, custom constraints — returns None.  The ``Dynamic*``
    classes count as their static family: the same encoding, with the
    budget or caps a device tensor (``ref.Encoding`` takes either).
    """
    parts = (constraint.parts if isinstance(constraint, Intersection)
             else (constraint,))
    n_knap = sum(isinstance(p, _KNAPSACK_KINDS) for p in parts)
    n_part = sum(isinstance(p, _PARTITION_KINDS) for p in parts)
    if n_knap + n_part != len(parts) or n_knap > 1 or n_part > 1:
        return None
    return parts


_KNAPSACK_KINDS = (Knapsack, DynamicKnapsack)
_PARTITION_KINDS = (PartitionMatroid, DynamicPartitionMatroid)


def _fused_constraint_kwargs(constraint, attrs) -> dict:
    """Fused-hook operands of a fused-encodable constraint."""
    kw = {}
    for p in _fused_parts(constraint):
        if isinstance(p, _KNAPSACK_KINDS):
            kw["weights"] = attrs[..., p.col]
            kw["budget"] = p.budget
        else:
            kw["group_ids"] = attrs[..., p.col]
            kw["caps"] = p.caps
    return kw


def _constrained(constraint) -> bool:
    return constraint is not None and not isinstance(constraint,
                                                     Unconstrained)


def _fusable(obj, constraint, attrs) -> bool:
    """May the fused selection replace the step-wise scan?

    Unconstrained selection fuses whenever the objective exposes
    ``fused_select``.  Knapsack (``fused_knapsack`` on the objective),
    partition matroid (``fused_partition``) and an intersection of at most
    one of each fuse too; everything else takes the feasibility-masked
    step-wise scan.
    """
    if not (getattr(obj, "rowwise_gains", False)
            and hasattr(obj, "fused_select")):
        return False
    if not _constrained(constraint):
        return attrs is None
    parts = _fused_parts(constraint)
    if parts is None or attrs is None:
        return False
    return all(getattr(obj, "fused_knapsack"
                       if isinstance(p, _KNAPSACK_KINDS)
                       else "fused_partition", False) for p in parts)


def _where_state(ok: torch.Tensor, new, old):
    """Per-machine select over a (possibly nested) tuple of state tensors."""
    if isinstance(new, tuple):
        return tuple(_where_state(ok, a, b) for a, b in zip(new, old))
    if isinstance(new, dict):
        return {key: _where_state(ok, new[key], old[key]) for key in new}
    return torch.where(ok.reshape(ok.shape + (1,) * (new.dim() - ok.dim())),
                       new, old)


def greedy(obj, T: torch.Tensor, mask: torch.Tensor, k: int, *,
           constraint=None, attrs=None, fused: bool | None = None,
           qmeta=None) -> SelectResult:
    """Classic greedy with consistent (lowest-index) tie-breaking.

    Supports any hereditary constraint over per-item ``attrs``
    ``(..., cap, a)``; the cardinality bound is the loop bound ``k``.
    ``fused=None`` (auto) routes unconstrained, knapsack-, partition- and
    knapsack∩partition-constrained selection through the objective's
    ``fused_select`` hook (``ops.greedy_select``: one call for the whole
    k-step loop on every machine); ``fused=False`` forces the step-wise
    scan, ``fused=True`` asserts the fast path.  The scan commits a step
    through the objective's ``masked_update`` where it has one (a state
    too large to copy per step, updated in place where ``ok``), else
    through ``update`` and a per-machine select.  An objective with a
    ``k_max`` refuses ``k > k_max``.

    ``qmeta`` marks a narrow block (``(..., cap, qcols)`` per-row dequant
    parameters, zero columns for bf16): the fused path ships it narrow to
    the kernel, the scan dequantizes it up front; both see the same fp32
    rows.
    """
    k_max = getattr(obj, "k_max", None)
    if k_max is not None and k > k_max:
        raise ValueError(f"k = {k} exceeds {type(obj).__name__}.k_max = "
                         f"{k_max}: its state holds k_max selections")
    batch = T.shape[:-2]
    depth = torch.full(batch, k, dtype=torch.long, device=T.device)
    if fused is None:
        fused = _fusable(obj, constraint, attrs)
    if fused:
        assert _fusable(obj, constraint, attrs), (
            "fused=True needs a rowwise objective with a fused_select hook "
            "and an unconstrained, fused-knapsack or fused-partition "
            "selection")
        ckw = (_fused_constraint_kwargs(constraint, attrs)
               if _constrained(constraint) else {})
        sel_idx, sel_mask, value, calls = obj.fused_select(
            T, mask, k, **ckw, **_fused_quant_kwargs(qmeta))
        return SelectResult(sel_idx, sel_mask, value, calls, depth)

    if qmeta is not None:
        T = _dequant_block(T, qmeta)
    constraint = constraint or Unconstrained()
    if attrs is None:
        attrs = torch.zeros(T.shape[:-1] + (1,), dtype=torch.float32,
                            device=T.device)
    state = obj.init_state(T, mask)
    cstate = constraint.init_state(batch, T.device)
    avail = mask.bool()
    calls = torch.zeros(batch, dtype=torch.long, device=T.device)
    sel_idx, sel_mask = [], []
    for _ in range(k):
        cand = avail & constraint.feasible(cstate, attrs)
        gains = obj.gains(state, T, cand)
        best = torch.argmax(gains, dim=-1)              # lowest index on ties
        ok = torch.take_along_dim(gains, best[..., None], dim=-1)[..., 0] \
            > NEG_INF / 2                               # any candidate at all?
        state = _commit(obj, state, T, best, ok)
        cstate = _where_state(ok, constraint.update(cstate, attrs, best),
                              cstate)
        hit = torch.nn.functional.one_hot(best, T.shape[-2]).bool()
        avail = avail & ~(ok[..., None] & hit)
        calls = calls + torch.sum(cand.long(), dim=-1)
        sel_idx.append(torch.where(ok, best, torch.full_like(best, -1)))
        sel_mask.append(ok)
    return SelectResult(torch.stack(sel_idx, dim=-1),
                        torch.stack(sel_mask, dim=-1), obj.value(state),
                        calls, depth)


def _commit(obj, state, T, idx, ok):
    """The objective's state after taking ``idx`` where ``ok`` per machine
    (in place through ``masked_update`` where the objective has one)."""
    if hasattr(obj, "masked_update"):
        return obj.masked_update(state, T, idx, ok)
    return _where_state(ok, obj.update(state, T, idx), state)


def _setup(T, qmeta, constraint, attrs):
    """The fp32 block, the constraint (Unconstrained for None) and the
    attributes (one zero column for None) of a step-wise selection."""
    T = _dequant_block(T, qmeta)
    constraint = constraint or Unconstrained()
    if attrs is None:
        attrs = torch.zeros(T.shape[:-1] + (1,), dtype=torch.float32,
                            device=T.device)
    return T, constraint, attrs


def sample_size(cap: int, k: int, eps: float) -> int:
    """``s = min(cap, max(1, ⌈cap/k · ln(1/ε)⌉))``, stochastic greedy's
    sample per step."""
    return min(cap, max(1, math.ceil(cap / k * math.log(1.0 / eps))))


def stochastic_sample(scores: torch.Tensor, cand: torch.Tensor,
                      s: int) -> torch.Tensor:
    """The sample of one step: the ``s`` slots of smallest score, with
    non-candidates scored 2.0 and ties to the lower slot, in that order
    ``(…, s)``.  A non-negative float's bits order like its value, so the
    bits and the slot make one int64 key: the order is exact on any
    device."""
    pos = torch.arange(scores.shape[-1], dtype=torch.int64,
                       device=scores.device)
    scores = torch.where(cand, scores, 2.0)
    order = (scores.view(torch.int32).long() << 32) | pos
    return torch.topk(order, s, dim=-1, largest=False, sorted=True).indices


def stochastic_greedy(obj, T: torch.Tensor, mask: torch.Tensor, k: int,
                      key: Callable[[int], torch.Tensor], *, eps: float = 0.5,
                      constraint=None, attrs=None, qmeta=None
                      ) -> SelectResult:
    """Each step takes the best of a uniform random sample of
    ``s = min(cap, max(1, ⌈cap/k · ln(1/ε)⌉))`` candidates (lazier than
    lazy greedy).

    ``key(j)`` gives step j's scores, one uniform draw in [0, 1) per slot
    (``(…, cap)``; :func:`repro_torch.core.plan.round_draws` of the round
    plan); :func:`stochastic_sample` takes the sample, in the JAX package's
    ``top_k`` order.  A row-wise objective scores the sampled rows only, sorted by
    slot (``ExemplarClustering`` through the ``exemplar_gains`` kernel at
    ``(M, s)`` rows); another scores the whole block and reads the sample.
    A hereditary constraint limits the sample to feasible candidates and
    is committed at every take.  Oracle calls count the sampled
    candidates; depth is k.
    """
    cap, batch = T.shape[-2], T.shape[:-2]
    T, constraint, attrs = _setup(T, qmeta, constraint, attrs)
    s = sample_size(cap, k, eps)
    rowwise = getattr(obj, "rowwise_gains", False)
    dev = T.device
    pos = torch.arange(cap, dtype=torch.int64, device=dev)
    state = obj.init_state(T, mask)
    cstate = constraint.init_state(batch, dev)
    avail = mask.bool()
    calls = torch.zeros(batch, dtype=torch.long, device=dev)
    sel_idx, sel_mask = [], []
    for j in range(k):
        cand = avail & constraint.feasible(cstate, attrs)
        scores = key(j).to(device=dev, dtype=torch.float32).reshape(
            batch + (cap,))
        sub = stochastic_sample(scores, cand, s)
        if rowwise:
            # ascending slots: the gather of the sample walks rows forward
            sub = torch.sort(sub, dim=-1).values
            sub_cand = torch.take_along_dim(cand, sub, dim=-1)
            g = obj.gains(state, torch.take_along_dim(T, sub[..., None],
                                                      dim=-2), sub_cand)
        else:
            sub_cand = torch.take_along_dim(cand, sub, dim=-1)
            g = torch.take_along_dim(obj.gains(state, T, cand), sub, dim=-1)
            g = torch.where(sub_cand, g, NEG_INF)
        b = torch.argmax(g, dim=-1)                     # lowest index on ties
        best = torch.take_along_dim(sub, b[..., None], dim=-1)[..., 0]
        ok = torch.take_along_dim(g, b[..., None], dim=-1)[..., 0] \
            > NEG_INF / 2
        state = _commit(obj, state, T, best, ok)
        cstate = _where_state(ok, constraint.update(cstate, attrs, best),
                              cstate)
        avail = avail & ~(ok[..., None] & (pos == best[..., None]))
        calls = calls + torch.sum(sub_cand.long(), dim=-1)
        sel_idx.append(torch.where(ok, best, torch.full_like(best, -1)))
        sel_mask.append(ok)
    depth = torch.full(batch, k, dtype=torch.long, device=dev)
    return SelectResult(torch.stack(sel_idx, dim=-1),
                        torch.stack(sel_mask, dim=-1), obj.value(state),
                        calls, depth)


def threshold_greedy(obj, T: torch.Tensor, mask: torch.Tensor, k: int, *,
                     eps: float = 0.1, constraint=None, attrs=None,
                     qmeta=None) -> SelectResult:
    """Descending thresholds τ_l = d_max·(1 − ε)^l, l < n_levels =
    ⌈log(2k/ε)/ε⌉; at each level a sweep over the block in index order
    takes every available, feasible item whose gain meets τ, up to k
    (Badanidiyuru & Vondrák 2014; (1 + 2ε)-nice).

    The JAX package sweeps item by item.  Within a level the objective and
    constraint states change only at a take, so the next take is the
    first index at or past the cursor that is available, feasible, under
    k and at or above τ, under the current states.  Each pass here scores
    the whole block once, finds that index for every machine at once,
    takes it and moves the cursor past it; a machine with no such index
    ends its level.  The takes are the sweep's.  Oracle calls count the
    available, feasible items the sweep visits, under the constraint
    state at the visit, after the count reaches k too, plus the d_max
    pass's candidates; depth is 1 + n_levels.
    """
    cap, batch = T.shape[-2], T.shape[:-2]
    T, constraint, attrs = _setup(T, qmeta, constraint, attrs)
    n_levels = max(1, math.ceil(math.log(2.0 * k / eps) / eps))
    dev = T.device
    pos = torch.arange(cap, dtype=torch.int64, device=dev)
    state = obj.init_state(T, mask)
    cstate = constraint.init_state(batch, dev)
    cand0 = mask.bool() & constraint.feasible(cstate, attrs)
    d_max = torch.clamp_min(torch.amax(obj.gains(state, T, cand0), dim=-1),
                            1e-12)
    calls = torch.sum(cand0.long(), dim=-1)
    avail = mask.bool()
    every = torch.ones_like(avail)
    count = torch.zeros(batch, dtype=torch.long, device=dev)
    slot_k = torch.arange(k, dtype=torch.int64, device=dev)
    sel_idx = torch.full(batch + (k,), -1, dtype=torch.long, device=dev)
    ratio = torch.tensor(1.0 - eps, dtype=torch.float32, device=dev)
    for level in range(n_levels):
        tau = d_max * torch.pow(ratio, torch.tensor(float(level),
                                                    device=dev))
        cursor = torch.zeros(batch, dtype=torch.long, device=dev)
        sweeping = torch.ones(batch, dtype=torch.bool, device=dev)
        while True:
            visit = avail & constraint.feasible(cstate, attrs)
            g = obj.gains(state, T, every)
            ahead = pos >= cursor[..., None]
            take = (visit & ahead & (count < k)[..., None]
                    & (g >= tau[..., None]))
            hit = torch.any(take, dim=-1) & sweeping
            first = torch.argmax(take.to(torch.uint8), dim=-1)  # first True
            end = torch.where(hit, first, cap - 1)
            seen = ahead & (pos <= end[..., None]) & sweeping[..., None]
            calls = calls + torch.sum((visit & seen).long(), dim=-1)
            if not bool(torch.any(hit)):
                break
            state = _commit(obj, state, T, first, hit)
            cstate = _where_state(hit, constraint.update(cstate, attrs,
                                                         first), cstate)
            sel_idx = torch.where(hit[..., None]
                                  & (slot_k == count[..., None]),
                                  first[..., None], sel_idx)
            count = count + hit.long()
            avail = avail & ~(hit[..., None] & (pos == first[..., None]))
            cursor = torch.where(hit, first + 1, cursor)
            sweeping = hit
    depth = torch.full(batch, 1 + n_levels, dtype=torch.long, device=dev)
    return SelectResult(sel_idx, slot_k < count[..., None], obj.value(state),
                        calls, depth)


def threshold_batch(obj, T: torch.Tensor, mask: torch.Tensor, k: int, *,
                    eps: float = 0.5, constraint=None, attrs=None,
                    qmeta=None) -> SelectResult:
    """Batch-accepting descending-threshold selection (adaptive sequencing).

    One ``threshold_select`` launch per τ-level scores every candidate
    against τ and accepts the prefix-feasible batch of qualifying items;
    the ladder lowers τ ← τ(1−ε) between launches.  Sequential solve depth
    is ``1 + launches ≤ 1 + ⌈log(2k/ε)/ε⌉`` per machine instead of
    greedy's k.

    Needs a row-wise objective with the ``fused_threshold_select`` hook,
    and a fused-encodable constraint (knapsack, partition matroid, one of
    each); anything else raises rather than degrading to a sequential path.
    A narrow block (``qmeta``) goes to the kernels as it is.
    """
    if not (getattr(obj, "rowwise_gains", False)
            and hasattr(obj, "fused_threshold_select")):
        raise ValueError(
            "threshold_batch needs a row-wise objective with a "
            f"fused_threshold_select hook; {type(obj).__name__} has none "
            "(use algorithm='threshold_greedy' for the sequential ladder)")
    ckw = {}
    if _constrained(constraint):
        if _fused_parts(constraint) is None:
            raise ValueError(
                "threshold_batch supports knapsack, partition-matroid, and "
                "one-of-each intersection constraints; "
                f"{type(constraint).__name__} has no fused encoding")
        if attrs is None:
            raise ValueError(
                "constrained threshold_batch needs per-item attrs")
        ckw = _fused_constraint_kwargs(constraint, attrs)
    sel_idx, sel_mask, value, calls, launches = obj.fused_threshold_select(
        T, mask, k, eps=eps, **ckw, **_fused_quant_kwargs(qmeta))
    # depth: the d_max init pass plus the launches the ladder ran
    return SelectResult(sel_idx, sel_mask, value, calls, 1 + launches)


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
    but greedy) raise ``ValueError``.  ``key`` is stochastic_greedy's draws
    (step → scores, :func:`repro_torch.core.plan.round_draws`).
    ``eps=None`` takes the algorithm's own default: 0.1 for
    threshold_greedy, 0.5 for the others.
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
    ekw = {} if eps is None else {"eps": eps}
    if name == "greedy":
        return greedy(obj, T, mask, k, constraint=constraint, attrs=attrs,
                      fused=fused, qmeta=qmeta)
    if name == "stochastic_greedy":
        if key is None:
            raise ValueError("stochastic_greedy needs its draws (key=, e.g. "
                             "plan.round_draws of the round plan)")
        return stochastic_greedy(obj, T, mask, k, key, **ekw,
                                 constraint=constraint, attrs=attrs,
                                 qmeta=qmeta)
    if name == "threshold_greedy":
        return threshold_greedy(obj, T, mask, k, **ekw,
                                constraint=constraint, attrs=attrs,
                                qmeta=qmeta)
    return threshold_batch(obj, T, mask, k, **ekw, constraint=constraint,
                           attrs=attrs, qmeta=qmeta)
