"""Baselines the paper compares against (§4.3) (counterpart of
``repro.core.baselines``): centralized GREEDY under any hereditary
constraint, over a resident array or, chunk by chunk, over a
:class:`GroundSetSource`; RANDOM-k; and the fp32 re-score of a coreset.
RandGreedI stays open under ROADMAP queue 1 item 6.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import algorithms
from repro_torch.core.sources import (GroundSetSource, QuantizedSource,
                                      host_rows, prefetch_chunks)
from repro_torch.device import as_tensor, resolve_device


class BaselineResult(NamedTuple):
    sel_rows: torch.Tensor
    sel_mask: torch.Tensor
    value: torch.Tensor
    sel_attrs: torch.Tensor | None = None   # (k, a) where attrs were given


def fp32_recheck_value(obj, rows, mask) -> float:
    """The exact fp32 objective of a coreset's rows, scored where ``obj``
    lives: what a run on narrow rows reports as its value (the solve may
    have scored dequantized rows; the claim is this number)."""
    rows_t = as_tensor(host_rows(rows).astype(np.float32), obj.device)
    mask_t = torch.as_tensor(np.asarray(host_rows(mask), bool),
                             device=obj.device)
    return float(obj.evaluate(rows_t, mask_t))


def _check_device(obj, device) -> torch.device:
    dev = resolve_device(device)
    if obj.device != dev:
        raise ValueError(f"objective lives on {obj.device}, run asks {dev}")
    return dev


def centralized_greedy(obj, data, k: int, *, constraint=None, attrs=None,
                       device="cuda", chunk_rows: int = 8192,
                       prefetch_depth: int = 2) -> BaselineResult:
    """GREEDY on the full ground set (μ ≥ n regime; 1 − 1/e): one machine
    whose block is all n rows, under ``constraint`` over the per-item
    ``attrs`` ``(n, a)``.  Runs on the card unless ``device="cpu"``.  A
    :class:`GroundSetSource` takes the chunked lazy pass
    (:func:`streaming_centralized_greedy`, ``chunk_rows`` and
    ``prefetch_depth`` its chunking), so the ground set need not fit on the
    card."""
    if isinstance(data, GroundSetSource):
        return streaming_centralized_greedy(
            obj, data, k, constraint=constraint, attrs=attrs, device=device,
            chunk_rows=chunk_rows, prefetch_depth=prefetch_depth)
    dev = _check_device(obj, device)
    data = as_tensor(data, dev)
    n = data.shape[0]
    attrs_t = None if attrs is None else as_tensor(attrs, dev)
    res = algorithms.greedy(obj, data,
                            torch.ones((n,), dtype=torch.bool, device=dev), k,
                            constraint=constraint, attrs=attrs_t)
    safe = torch.clamp_min(res.sel_idx, 0)
    rows = torch.where(res.sel_mask[:, None], data[safe], 0.0)
    sel_attrs = (None if attrs_t is None
                 else torch.where(res.sel_mask[:, None], attrs_t[safe], 0.0))
    return BaselineResult(rows, res.sel_mask, res.value, sel_attrs)


def streaming_centralized_greedy(obj, source: GroundSetSource, k: int, *,
                                 constraint=None, attrs=None, device="cuda",
                                 chunk_rows: int = 8192,
                                 prefetch_depth: int = 2) -> BaselineResult:
    """Centralized lazy greedy over a chunk-streamable ground set.

    Each step streams the source in chunks (:func:`prefetch_chunks`,
    ``prefetch_depth`` ahead) and keeps one upper bound per chunk, its best
    gain when last scored.  Gains and hereditary feasibility only fall as
    the solution grows, so a chunk whose bound does not beat the step's
    best so far is skipped unscored (lazy greedy at chunk granularity).
    Chunks are visited in index order with strict-improvement comparison,
    which is the global lowest-index tie rule; a row's gain does not depend
    on the chunk it is scored in, so the selection, value and attribute
    rows are those of the resident pass.  Host memory is O(chunk + k) rows,
    device memory O(chunk).  Needs a row-wise objective.  bf16 rows are
    upcast exactly; other rows are read as their fp32 values.
    """
    if not getattr(obj, "rowwise_gains", False):
        raise ValueError("streaming centralized greedy needs a row-wise "
                         "objective (gains independent of block position)")
    dev = _check_device(obj, device)
    d = source.d
    attrs_np = (None if attrs is None
                else np.asarray(host_rows(attrs), np.float32))
    a = 0
    if constraint is not None:
        a = attrs_np.shape[1] if attrs_np is not None else source.a
        if a <= 0:
            raise ValueError("constraint needs attrs (pass attrs= or an "
                             "attributed source)")
    state = obj.init_state(torch.zeros((1, d), device=dev),
                           torch.ones((1,), dtype=torch.bool, device=dev))
    cstate = None if constraint is None else constraint.init_state((), dev)
    bounds: dict[int, float] = {}            # chunk start → stale best gain
    taken: list[int] = []                    # selected global indices
    sel_rows = np.zeros((k, d), np.float32)
    sel_attrs = np.zeros((k, a), np.float32)
    sel_mask = np.zeros((k,), bool)

    def chunks():
        if a and attrs_np is None:
            yield from prefetch_chunks(source, chunk_rows,
                                       depth=prefetch_depth, with_attrs=True)
            return
        for start, rows in prefetch_chunks(source, chunk_rows,
                                           depth=prefetch_depth):
            yield start, rows, (attrs_np[start:start + len(rows)] if a
                                else None)

    for t in range(k):
        best_g, best_idx, best_row, best_attr = -np.inf, -1, None, None
        for start, rows, chunk_attrs in chunks():
            if bounds.get(start, np.inf) <= best_g:
                continue                     # lazily skipped, bound stale-safe
            rows32 = QuantizedSource.dequantize(rows, None)
            cand = np.ones((len(rows),), bool)
            for g_idx in taken:              # k is small: mask the selected
                if start <= g_idx < start + len(rows):
                    cand[g_idx - start] = False
            cand_t = torch.as_tensor(cand, device=dev)
            if constraint is not None:
                cand_t = cand_t & constraint.feasible(
                    cstate, as_tensor(chunk_attrs, dev))
            g = obj.gains(state, as_tensor(rows32, dev), cand_t)
            j = int(torch.argmax(g))         # lowest index on ties
            g_j = float(g[j])
            bounds[start] = g_j
            if g_j > best_g:                 # strict: the lower chunk wins
                best_g, best_idx, best_row = g_j, start + j, rows32[j].copy()
                best_attr = (np.asarray(chunk_attrs[j], np.float32).copy()
                             if a else None)
        if best_idx < 0 or best_g <= algorithms.NEG_INF / 2:
            break                            # no feasible candidate remains
        zero = torch.zeros((), dtype=torch.long, device=dev)
        state = obj.update(state, as_tensor(best_row[None], dev), zero)
        if constraint is not None:
            cstate = constraint.update(cstate,
                                       as_tensor(best_attr[None], dev), zero)
        taken.append(best_idx)
        sel_rows[t], sel_mask[t] = best_row, True
        if a:
            sel_attrs[t] = best_attr
    return BaselineResult(as_tensor(sel_rows, dev),
                          torch.as_tensor(sel_mask, device=dev),
                          obj.value(state),
                          as_tensor(sel_attrs, dev) if a else None)


def random_subset(obj, data, k: int, generator: torch.Generator
                  ) -> BaselineResult:
    """k distinct rows drawn uniformly with ``generator`` (a CPU generator),
    scored where ``obj`` lives."""
    data = as_tensor(data, obj.device)
    idx = torch.randperm(data.shape[0], generator=generator)[:k]
    rows = data[idx.to(obj.device)]
    mask = torch.ones((k,), dtype=torch.bool, device=obj.device)
    return BaselineResult(rows, mask, obj.evaluate(rows, mask))
