"""Baselines the paper compares against (§4.3) (counterpart of
``repro.core.baselines``): centralized GREEDY under any hereditary
constraint, over a resident array or, chunk by chunk, over a
:class:`GroundSetSource`; RandGreedI (two rounds over a random partition,
from an array or a source); RANDOM-k; and the fp32 re-score of a coreset.
"""
from __future__ import annotations

import functools
import math
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import algorithms
from repro_torch.core import partition as part_lib
from repro_torch.core.distributed import _solve_block, pack_wave
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
    upcast exactly, int8 rows dequantized with their ``gather_qmeta``
    parameters: the rows ``QuantizedSource.dequantized`` holds.
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
            rows32 = QuantizedSource.dequantize(rows, source.gather_qmeta(
                np.arange(start, start + len(rows))) if source.qcols else None)
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


def randgreedi(obj, data, k: int, m: int, plan, *, constraint=None,
               attrs=None, machine_chunk: int | None = None,
               device="cuda") -> BaselineResult:
    """Two-round RandGreedI (Barbosa et al. 2015; the paper's §4.3
    comparison): a random partition of the n items to m machines of
    ``cap = ⌈n/m⌉`` slots, GREEDY(k) on each, GREEDY(k) on the union of
    the m·k partial solutions; the better of the union's solution and the
    best machine's ((1 − 1/e)/2 in expectation).

    The partition is ``balanced_partition`` with round 0's slot
    permutation of ``plan`` (a ``TorchPlan``; the parity tests replay the
    JAX package's key through an ``ArrayPlan``).  ``data`` is an ``(n, d)``
    array, solved at once, or a :class:`GroundSetSource`, whose machine
    blocks are gathered on the host and solved ``machine_chunk`` machines
    at a time (default ⌈√m⌉), so the card holds O(chunk · cap · d) rows.
    A narrow source (bf16, int8) ships its storage dtype with its dequant
    parameters, as TREE's streaming waves do, and the kernels dequantize;
    both paths give the bits of the array path on the rows the solve sees
    (``QuantizedSource.dequantized``).  The machines and the union go
    through ``greedy_select`` on the card (a constraint takes the fused
    path where it has an encoding).  A hereditary constraint applies to
    both rounds, with ``attrs`` ``(n, a)`` or an attributed source.  Runs
    on the card unless ``device="cpu"``.
    """
    dev = _check_device(obj, device)
    source = data if isinstance(data, GroundSetSource) else None
    n, d = (source.n, source.d) if source is not None else tuple(
        data.shape)
    attrs_np = (None if attrs is None
                else np.asarray(host_rows(attrs), np.float32))
    a = 0
    if constraint is not None:
        a = attrs_np.shape[1] if attrs_np is not None else (
            source.a if source is not None else 0)
        if a <= 0:
            raise ValueError("constraint needs attrs (pass attrs= or an "
                             "attributed source)")
    solve = functools.partial(_solve_block, obj, k=k, alg="greedy",
                              eps=None, attr_dim=a, constraint=constraint)
    cap = math.ceil(n / m)
    part = part_lib.balanced_partition(plan, 0, n, m, cap=cap)
    if source is None:
        wide = as_tensor(data, dev)
        if a:
            wide = torch.cat([wide, as_tensor(attrs_np, dev)], dim=1)
        blocks, bmask = part_lib.gather_partition(
            wide, part_lib.Partition(part.idx.to(dev), part.mask.to(dev)))
        rows, smask, vals = solve(blocks, bmask)[:3]
        del blocks, bmask
    else:
        narrow = np.dtype(source.dtype) != np.dtype(np.float32)
        qcols = source.qcols if narrow else 0
        slot_item = part.idx.numpy()
        chunk = machine_chunk or math.isqrt(m - 1) + 1
        out = []
        for c0 in range(0, m, chunk):
            idx_c = slot_item[c0:c0 + chunk]
            flat = np.maximum(idx_c, 0).reshape(-1)
            valid = idx_c >= 0
            if a and attrs_np is None:    # one pass of the source
                rows_np, att = source.gather_with_attrs(flat)
            else:
                rows_np = source.gather(flat)
                att = attrs_np[flat] if a else None
            shape = (len(idx_c), cap)
            meta = None
            if narrow:
                cols = ([np.asarray(att, np.float32)] if a else []) + (
                    [source.gather_qmeta(flat)] if qcols else [])
                blocks = pack_wave(np.asarray(rows_np).reshape(*shape, d),
                                   valid, False)
                meta = (pack_wave(np.concatenate(cols, axis=1).reshape(
                    *shape, a + qcols), valid, False) if cols
                    else torch.zeros(shape + (0,))).to(dev)
            else:
                rows_np = np.asarray(rows_np, np.float32)
                if a:
                    rows_np = np.concatenate(
                        [rows_np, np.asarray(att, np.float32)], axis=1)
                blocks = pack_wave(rows_np.reshape(*shape, d + a), valid,
                                   False)
            out.append(solve(blocks.to(dev), torch.from_numpy(valid).to(dev),
                             meta=meta)[:3])
        rows, smask, vals = (torch.cat(parts) for parts in zip(*out))
    union_rows = rows.reshape(m * k, d + a)
    union_mask = smask.reshape(m * k)
    feat = union_rows[:, :-a].contiguous() if a else union_rows
    res = algorithms.greedy(obj, feat, union_mask, k, constraint=constraint,
                            attrs=union_rows[:, -a:] if a else None)
    safe = torch.clamp_min(res.sel_idx, 0)
    final_rows = torch.where(res.sel_mask[:, None], union_rows[safe], 0.0)
    i = torch.argmax(vals)                          # lowest index on ties
    use_final = res.value >= vals[i]
    sel_wide = torch.where(use_final, final_rows, rows[i])
    sel_mask = torch.where(use_final, res.sel_mask, smask[i])
    value = torch.maximum(res.value, vals[i])
    if a:
        return BaselineResult(sel_wide[:, :-a], sel_mask, value,
                              sel_wide[:, -a:])
    return BaselineResult(sel_wide, sel_mask, value)


def random_subset(obj, data, k: int, generator: torch.Generator
                  ) -> BaselineResult:
    """k distinct rows drawn uniformly with ``generator`` (a CPU generator),
    scored where ``obj`` lives."""
    data = as_tensor(data, obj.device)
    idx = torch.randperm(data.shape[0], generator=generator)[:k]
    rows = data[idx.to(obj.device)]
    mask = torch.ones((k,), dtype=torch.bool, device=obj.device)
    return BaselineResult(rows, mask, obj.evaluate(rows, mask))
