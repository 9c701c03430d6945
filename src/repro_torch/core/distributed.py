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
    sol_rows: torch.Tensor      # (M, k, d)
    sol_mask: torch.Tensor      # (M, k)
    values: torch.Tensor        # (M,) f(S_i), -inf where no solution
    oracle_calls: torch.Tensor  # (M,) int64
    depth: torch.Tensor         # (M,) int64 sequential solve depth


def _solve_block(obj, T, mask, key=None, *, k: int, alg: str, eps: float):
    """Solve every machine block of ``T`` ``(M, cap, d)`` at once."""
    dkw = algorithms.driver_kwargs(alg, key=key, eps=eps)
    res = algorithms.run_algorithm(alg, obj, T, mask, k, **dkw)
    safe = torch.clamp_min(res.sel_idx, 0)
    picked = torch.take_along_dim(T, safe[..., None], dim=-2)  # (M, k, d)
    rows = torch.where(res.sel_mask[..., None], picked, 0.0)
    any_sel = torch.any(res.sel_mask, dim=-1)
    value = torch.where(any_sel, res.value,
                        torch.full_like(res.value, -torch.inf))
    return rows, res.sel_mask, value, res.oracle_calls, res.depth


def run_round(obj, blocks: torch.Tensor, bmask: torch.Tensor, *, k: int,
              alg: str = "greedy", eps: float = 0.5,
              dead_mask: torch.Tensor | None = None) -> RoundResult:
    """One round of Algorithm 1 over all M machine blocks.

    ``blocks`` ``(M, cap, d)`` items and ``bmask`` ``(M, cap)`` validity;
    runs where the tensors lie (the kernels on a CUDA device, their plain
    versions on the CPU).
    """
    M = blocks.shape[0]
    dead = (torch.zeros((M,), dtype=torch.bool, device=blocks.device)
            if dead_mask is None else dead_mask.to(blocks.device))
    rows, smask, vals, calls, depth = _solve_block(obj, blocks, bmask, k=k,
                                                   alg=alg, eps=eps)
    alive = ~dead
    smask = smask & alive[:, None]
    vals = torch.where(alive, vals, torch.full_like(vals, -torch.inf))
    return RoundResult(rows, smask, vals, calls, depth)
