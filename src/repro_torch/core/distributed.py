"""One TREE round over all machine blocks (counterpart of
``repro.core.distributed``).

On one card the paper's machines are a leading axis of the round's blocks:
the JAX package's ``vmap`` over machines becomes that axis, and the kernels
take it directly, so a round is one batched solve.  The device mesh,
``shard_map`` and wave staging wait for multi-GPU.

Fault model: ``dead_mask`` marks machines whose round output is lost.
Algorithm 1 takes a max over machine solutions and Lemma 3.4 degrades
gracefully under dropped partitions, so the dead machines' items are
simply pruned.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import algorithms


class RoundResult(NamedTuple):
    sol_rows: torch.Tensor      # (M, k, d + attr_dim)
    sol_mask: torch.Tensor      # (M, k)
    values: torch.Tensor        # (M,) f(S_i), -inf where no solution
    oracle_calls: torch.Tensor  # (M,) int64
    depth: torch.Tensor         # (M,) int64 sequential solve depth


def _solve_block(obj, T, mask, key=None, *, k: int, alg: str, eps: float,
                 attr_dim: int = 0, constraint=None):
    """Solve every machine block of ``T`` ``(M, cap, d + attr_dim)`` at once.

    ``T`` is the *carried* block: feature rows, optionally widened with
    ``attr_dim`` trailing per-item attribute columns (knapsack weights,
    partition ids).  The objective sees only the feature slice, made
    contiguous here once per round (the kernels then take it as it is at
    every step or τ-level); the constraint sees only the attribute slice;
    the returned rows keep the full width, so attributes travel with their
    items into the next round's union.
    """
    dkw = algorithms.driver_kwargs(alg, key=key, eps=eps)
    if attr_dim:
        feat, attrs = T[..., :-attr_dim].contiguous(), T[..., -attr_dim:]
    else:
        feat, attrs = T, None
    res = algorithms.run_algorithm(alg, obj, feat, mask, k,
                                   constraint=constraint, attrs=attrs, **dkw)
    safe = torch.clamp_min(res.sel_idx, 0)
    picked = torch.take_along_dim(T, safe[..., None], dim=-2)  # (M, k, d+a)
    rows = torch.where(res.sel_mask[..., None], picked, 0.0)
    any_sel = torch.any(res.sel_mask, dim=-1)
    value = torch.where(any_sel, res.value,
                        torch.full_like(res.value, -torch.inf))
    return rows, res.sel_mask, value, res.oracle_calls, res.depth


def run_round(obj, blocks: torch.Tensor, bmask: torch.Tensor, *, k: int,
              alg: str = "greedy", eps: float = 0.5,
              dead_mask: torch.Tensor | None = None, attr_dim: int = 0,
              constraint=None) -> RoundResult:
    """One round of Algorithm 1 over all M machine blocks.

    ``blocks`` ``(M, cap, d + attr_dim)`` items (the trailing ``attr_dim``
    columns are per-item constraint attributes that ride with the rows)
    and ``bmask`` ``(M, cap)`` validity; ``constraint`` applies to every
    machine's solve.  Runs where the tensors lie (the kernels on a CUDA
    device, their plain versions on the CPU).
    """
    M = blocks.shape[0]
    dead = (torch.zeros((M,), dtype=torch.bool, device=blocks.device)
            if dead_mask is None else dead_mask.to(blocks.device))
    rows, smask, vals, calls, depth = _solve_block(
        obj, blocks, bmask, k=k, alg=alg, eps=eps, attr_dim=attr_dim,
        constraint=constraint)
    alive = ~dead
    smask = smask & alive[:, None]
    vals = torch.where(alive, vals, torch.full_like(vals, -torch.inf))
    return RoundResult(rows, smask, vals, calls, depth)
