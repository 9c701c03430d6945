"""One TREE round over all machine blocks (counterpart of
``repro.core.distributed``).

On one card the paper's machines are a leading axis of the round's blocks:
the JAX package's ``vmap`` over machines becomes that axis, and the kernels
take it directly, so a round is one batched solve.  A streaming round 0
solves its waves of machines the same way; :func:`stage_wave_inputs`
brings each wave from host memory to the card.  The device mesh and
``shard_map`` wait for multi-GPU (ROADMAP queue 1 item 15).

Fault model: ``dead_mask`` marks machines whose round output is lost.
Algorithm 1 takes a max over machine solutions and Lemma 3.4 degrades
gracefully under dropped partitions, so the dead machines' items are
simply pruned.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import algorithms


class RoundResult(NamedTuple):
    sol_rows: torch.Tensor      # (M, k, d + attr_dim)
    sol_mask: torch.Tensor      # (M, k)
    values: torch.Tensor        # (M,) f(S_i), -inf where no solution
    oracle_calls: torch.Tensor  # (M,) int64
    depth: torch.Tensor         # (M,) int64 sequential solve depth


def _solve_block(obj, T, mask, key=None, meta=None, *, k: int, alg: str,
                 eps: float, attr_dim: int = 0, constraint=None):
    """Solve every machine block of ``T`` ``(M, cap, d + attr_dim)`` at once.

    ``T`` is the *carried* block: feature rows, optionally widened with
    ``attr_dim`` trailing per-item attribute columns (knapsack weights,
    partition ids).  The objective sees only the feature slice, made
    contiguous here once per round (the kernels then take it as it is at
    every step or τ-level); the constraint sees only the attribute slice;
    the returned rows keep the full width, so attributes travel with their
    items into the next round's union.

    A narrow round-0 wave instead ships ``T`` ``(M, cap, d)`` in its
    storage dtype (bf16, int8) beside one fp32 ``meta`` ``(M, cap,
    attr_dim + qcols)``, the attributes then the per-row dequant
    parameters.  The solve runs on the narrow block (the kernels
    dequantize), and the selected rows come back dequantized to fp32 with
    their attributes appended, so rounds ≥ 1 carry fp32 rows as always.

    ``key`` is ``stochastic_greedy``'s draws for these machines (step →
    ``(M, cap)`` scores, :func:`repro_torch.core.plan.round_draws`), in
    place of the JAX package's per-machine PRNG keys; other algorithms
    take none.
    """
    dkw = algorithms.driver_kwargs(alg, key=key, eps=eps)
    if meta is not None:
        attrs = meta[..., :attr_dim] if attr_dim else None
        qmeta = meta[..., attr_dim:]
        res = algorithms.run_algorithm(alg, obj, T, mask, k,
                                       constraint=constraint, attrs=attrs,
                                       qmeta=qmeta, **dkw)
        safe = torch.clamp_min(res.sel_idx, 0)[..., None]
        wide = algorithms._dequant_block(
            torch.take_along_dim(T, safe, dim=-2),
            torch.take_along_dim(qmeta, safe, dim=-2))
        if attr_dim:
            wide = torch.cat([wide, torch.take_along_dim(attrs, safe, dim=-2)],
                             dim=-1)
        rows = torch.where(res.sel_mask[..., None], wide, 0.0)
        value = torch.where(torch.any(res.sel_mask, dim=-1), res.value,
                            torch.full_like(res.value, -torch.inf))
        return rows, res.sel_mask, value, res.oracle_calls, res.depth
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
              constraint=None, meta: torch.Tensor | None = None,
              draws=None) -> RoundResult:
    """One round of Algorithm 1 over all M machine blocks.

    ``blocks`` ``(M, cap, d + attr_dim)`` items (the trailing ``attr_dim``
    columns are per-item constraint attributes that ride with the rows)
    and ``bmask`` ``(M, cap)`` validity; ``constraint`` applies to every
    machine's solve.  A narrow round-0 wave passes ``blocks`` ``(M, cap,
    d)`` in its storage dtype and the fp32 ``meta`` (see
    :func:`_solve_block`).  ``draws`` is ``stochastic_greedy``'s scores of
    these machines (:func:`repro_torch.core.plan.round_draws`).  Runs
    where the tensors lie (the kernels on a CUDA device, their plain
    versions on the CPU).
    """
    M = blocks.shape[0]
    dead = (torch.zeros((M,), dtype=torch.bool, device=blocks.device)
            if dead_mask is None else dead_mask.to(blocks.device))
    rows, smask, vals, calls, depth = _solve_block(
        obj, blocks, bmask, key=draws, meta=meta, k=k, alg=alg, eps=eps,
        attr_dim=attr_dim, constraint=constraint)
    alive = ~dead
    smask = smask & alive[:, None]
    vals = torch.where(alive, vals, torch.full_like(vals, -torch.inf))
    return RoundResult(rows, smask, vals, calls, depth)


def dead_wave_result(machines: int, k: int, width: int,
                     device: torch.device) -> RoundResult:
    """The fold contribution of machines that never ran.

    A wave the fault supervisor drops past its budget folds like
    ``dead_mask`` machines (value −inf, which never wins the best-solution
    max; solutions masked out, which the next repartition drops) but with
    zero oracle calls and depth: unlike a declared ``fail_machines``
    failure, which loses a machine's output after its work, a dropped
    wave's machines never received their blocks.
    """
    return RoundResult(
        sol_rows=torch.zeros((machines, k, width), dtype=torch.float32,
                             device=device),
        sol_mask=torch.zeros((machines, k), dtype=torch.bool, device=device),
        values=torch.full((machines,), -torch.inf, dtype=torch.float32,
                          device=device),
        oracle_calls=torch.zeros((machines,), dtype=torch.int64,
                                 device=device),
        depth=torch.zeros((machines,), dtype=torch.int64, device=device))


def host_tensor(a: np.ndarray, pinned: bool) -> torch.Tensor:
    """A host tensor holding a copy of ``a``, in page-locked memory where
    ``pinned``."""
    src = torch.from_numpy(np.ascontiguousarray(a))
    return torch.empty(src.shape, dtype=src.dtype,
                       pin_memory=pinned).copy_(src)


def pack_wave(x: np.ndarray, valid: np.ndarray, pinned: bool
              ) -> torch.Tensor:
    """A wave's ``(W, μ, c)`` block ``x`` as a fresh host tensor with the
    rows of empty slots (``~valid``) zeroed, in page-locked memory where
    ``pinned``: one pass of torch's multi-threaded ``where`` into the
    buffer the copy to the card reads.  bf16 bit patterns (uint16) land as
    ``torch.bfloat16``; a zeroed slot holds +0 in every dtype."""
    bf16 = x.dtype == np.uint16
    if not x.flags.writeable:           # torch.from_numpy wants to own it
        x = x.copy()
    src = torch.from_numpy(np.ascontiguousarray(x.view(np.int16) if bf16
                                                else x))
    out = torch.empty(src.shape, dtype=src.dtype, pin_memory=pinned)
    torch.where(torch.from_numpy(valid)[..., None], src,
                torch.zeros((), dtype=src.dtype), out=out)
    return out.view(torch.bfloat16) if bf16 else out


def stage_wave_inputs(device: torch.device, blocks: torch.Tensor,
                      bmask: torch.Tensor, meta: torch.Tensor | None = None,
                      copy_stream=None) -> tuple[torch.Tensor, ...]:
    """Host → device staging of one round-0 wave's packed host tensors
    (:func:`pack_wave`): ``(blocks, bmask)``, or ``(blocks, bmask, meta)``
    for a narrow wave.

    On the card each tensor is copied with ``non_blocking`` on
    ``copy_stream`` (a ``torch.cuda.Stream`` the caller keeps for its
    waves): that stream waits for the solve stream first (the destination
    memory's earlier users), and the solve stream waits on the copy's
    event, so a later solve never reads a partial wave and the caller's
    stream is never blocked on the host.  PyTorch's caching host allocator
    keeps a page-locked block from reuse until the copy that reads it has
    completed.  On the CPU the host tensors are the wave.
    """
    host = [blocks, bmask] + ([] if meta is None else [meta])
    if device.type != "cuda":
        return tuple(host)
    main = torch.cuda.current_stream(device)
    out = [torch.empty(h.shape, dtype=h.dtype, device=device) for h in host]
    copy_stream.wait_stream(main)
    with torch.cuda.stream(copy_stream):
        for dst, src in zip(out, host):
            dst.copy_(src, non_blocking=True)
        done = torch.cuda.Event()
        done.record(copy_stream)
    main.wait_event(done)
    return tuple(out)
