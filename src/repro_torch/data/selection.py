"""The paper's technique as a data-selection stage (counterpart of
``repro.data.selection``).

Given a candidate pool too large for one machine and a fixed per-machine
capacity, select the k most representative examples by exemplar
clustering over their features with TREE (Algorithm 1).  The pool is an
``(n, d)`` array (resident round 0) or any
:class:`repro_torch.core.GroundSetSource` (streamed in waves, so neither
the host nor the card holds the whole pool); a :class:`QuantizedSource`
is solved on its narrow rows and re-scored at fp32 by
:func:`fp32_recheck`.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import (ExemplarClustering, GroundSetSource,
                              QuantizedSource, TorchPlan, TreeConfig,
                              as_source, tree_maximize)
from repro_torch.core.baselines import fp32_recheck_value
from repro_torch.core.sources import host_rows
from repro_torch.device import as_tensor, resolve_device


@dataclasses.dataclass(frozen=True)
class SelectionConfig:
    k: int                       # exemplars to keep
    capacity: int                # per-machine item capacity μ
    n_eval: int = 2_048          # eval subsample of the exemplar objective
    algorithm: str = "greedy"    # greedy | stochastic_greedy |
    #                              threshold_greedy | threshold_batch
    eps: float = 0.5
    seed: int = 0


def mean_pool_embeddings(params, tokens: torch.Tensor) -> torch.Tensor:
    """(B, S) tokens → (B, d) mean of their embedding-table rows, in the
    table's dtype (the mean taken in fp32)."""
    emb = params["emb"]
    return torch.mean(emb[tokens.long()].float(), dim=1).to(emb.dtype)


def match_rows(pool, rows, chunk_rows: int = 8192,
               device="cuda") -> np.ndarray:
    """The nearest pool index (squared L2) of each of ``rows``, the lowest
    on exact ties: each pool chunk scores every query row at once on
    ``device`` and a strict ``<`` merge keeps the first chunk's.  ``pool``
    is an array or a source; memory is O(chunk · d)."""
    dev = resolve_device(device)
    rows_t = as_tensor(np.asarray(host_rows(rows), np.float32), dev)
    r = int(rows_t.shape[0])
    if r == 0:
        return np.zeros((0,), np.int64)
    d = int(rows_t.shape[1])
    chunk_rows = max(1, min(chunk_rows, (1 << 24) // max(1, r * d)))
    best_d = np.full((r,), np.inf, np.float32)
    best_i = np.zeros((r,), np.int64)
    for start, block in as_source(pool).iter_chunks(chunk_rows):
        block = QuantizedSource.dequantize(block, None)
        for s in range(0, len(block), chunk_rows):
            sub = as_tensor(block[s:s + chunk_rows], dev)
            d2 = torch.sum((sub[:, None, :] - rows_t[None, :, :]) ** 2, -1)
            cd, ci = torch.min(d2, dim=0)        # the first on ties
            cd, ci = cd.cpu().numpy(), ci.cpu().numpy()
            better = cd < best_d                 # strict: earlier chunk wins
            best_d = np.where(better, cd, best_d)
            best_i = np.where(better, ci + start + s, best_i)
    return best_i


@dataclasses.dataclass(frozen=True)
class RecheckResult:
    indices: np.ndarray      # pool indices of the selected rows
    rows_fp32: np.ndarray    # the same rows read again at full precision
    value: float             # exact fp32 objective of those rows
    solve_value: float       # the value the (maybe narrow) solve reported


def fp32_recheck(obj, source, sel_rows, sel_mask,
                 solve_value: float | None = None) -> RecheckResult:
    """Exact fp32 re-score of a coreset solved on (maybe) narrow rows.

    The solve on a :class:`QuantizedSource` picks rows by their dequantized
    values; they are mapped back to pool indices (nearest match among the
    dequantized rows: rows are copied verbatim through the rounds), read
    again from the fp32 parent and scored by the exact objective — the
    value a quantized run reports.  On an fp32 source it is a consistency
    check.
    """
    src = as_source(source)
    sel_mask = np.asarray(host_rows(sel_mask), bool)
    sel = np.asarray(host_rows(sel_rows), np.float32)[sel_mask]
    if len(sel) == 0:
        return RecheckResult(np.zeros((0,), np.int64),
                             np.zeros((0, src.d), np.float32), float("-inf"),
                             float("-inf") if solve_value is None
                             else float(solve_value))
    quant = isinstance(src, QuantizedSource)
    idx = match_rows(src.dequantized() if quant else src, sel,
                     device=obj.device)
    rows32 = (src.gather_fp32(idx) if quant
              else QuantizedSource.dequantize(src.gather(idx), None))
    value = fp32_recheck_value(obj, rows32, np.ones((len(idx),), bool))
    return RecheckResult(idx, rows32, value,
                         value if solve_value is None else float(solve_value))


def select_coreset(features, sel_cfg: SelectionConfig, *, device="cuda",
                   plan=None, wave_machines: int | None = None):
    """TREE over example features; returns ``(indices, TreeResult)``.

    ``features`` is an (n, d) array (resident round 0) or a source
    (streamed).  The eval rows are ``plan.eval_indices`` of the pool
    (default ``TorchPlan(sel_cfg.seed)``), read at fp32 (dequantized from
    a quantized source).  TREE returns rows; they map back to pool indices
    by :func:`match_rows`.  ``algorithm="stochastic_greedy"`` draws its
    samples from the same plan (``plan.stochastic_scores``).
    """
    dev = resolve_device(device)
    plan = TorchPlan(sel_cfg.seed) if plan is None else plan
    streaming = (isinstance(features, GroundSetSource)
                 or wave_machines is not None)
    source = as_source(features)
    ev_idx = plan.eval_indices(source.n, sel_cfg.n_eval)
    eval_rows = QuantizedSource.dequantize(
        source.gather(ev_idx), source.gather_qmeta(ev_idx))
    obj = ExemplarClustering(as_tensor(eval_rows, dev))
    cfg = TreeConfig(k=sel_cfg.k, capacity=sel_cfg.capacity,
                     algorithm=sel_cfg.algorithm, eps=sel_cfg.eps,
                     seed=sel_cfg.seed)
    res = tree_maximize(obj, source if streaming else features, cfg,
                        device=dev, plan=plan, wave_machines=wave_machines)
    return match_rows(source, res.sel_rows[res.sel_mask], device=dev), res
