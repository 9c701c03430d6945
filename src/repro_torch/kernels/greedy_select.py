"""Fused k-step exemplar greedy: the CUDA kernels, plain version, launch.

Replaces the TPU kernel ``repro.kernels.greedy_select.greedy_select_pallas``
(``src/repro/kernels/greedy_select.py:207``, ``pl.pallas_call`` at
``:265``).  Source: ``csrc/greedy_select.cu`` with the gain tile of
``csrc/exemplar_tile.cuh`` (the same one ``exemplar_gains`` runs, so the
fused and the step-wise paths score a row with the same bits).

The TPU kernel is one launch whose sequential grid carries the running
state between steps.  Hopper blocks run in parallel and in no order, so
each greedy step is one launch of a persistent grid (resident CTAs per SM
times the SMs): each CTA scores a contiguous range of the flattened
(machine, 128-row tile) space and writes one (best value, lowest index)
winner per machine segment it covers; a per-machine ticket elects the last
CTA to finish a machine, which reduces the machine's winners (lowest index
on ties), refreshes ``cur_min`` in the difference form and clears the
winner's availability.  k launches per call; the running state, the
segment winners and the tickets live in device scratch allocated here.

What bounds it on the H100: the gain tile's CUDA-core epilogue, four fp32
issue slots per (candidate, eval column) pair per step, beside its
tensor-core products (three TF32 products per 8-deep k-step); the commit
is O(k·M·m·d).  The persistent grid fills the card at M = 1 too (the
centralized baseline over the whole ground set).

Constrained variant: the knapsack (``w``, ``limit``) and partition-matroid
(``gid``, ``caps``) encodings, either or both.  The step kernel masks rows
that are not feasible against the running per-machine ``used`` (M,) fp32
and ``counts`` (M, G) int32, which live in device scratch allocated here;
the commit adds the winner's weight (one fp32 add per step, the
reference's order) and increments its group.  ``limit`` is a ``(1,)``
fp32 tensor on the card (:func:`repro_torch.kernels.ref.limit_operand`),
read by the kernel, so a captured CUDA graph takes any budget.  A group
id outside ``[0, G)`` belongs to no open group, so such a row is never
selected.

Weighted variant: eval weights (``WeightedExemplarClustering``) weigh each
eval column's contribution in the step kernel's gains (its own template
instantiation, with or without a constraint); the commit does not depend
on them.  Its launches count as ``greedy_select_weighted``.

Narrow rows (bf16, or int8 with per-row ``x_scale``/``x_zp``: the TPU
kernel's ``quantized`` instantiation) and the bf16 x·e contraction
(``compute_dtype``) are the gain tile's operand instantiations, with or
without a constraint or eval weights: the step kernel scores the
dequantized rows, the commit refreshes ``cur_min`` from the winner's
dequantized fp32 row.  Their launches count once more as
``greedy_select_bf16``, ``_q8`` and ``_bf16dot``.

On the dry run's ``meta`` operands (``_build.dry``) each launch runs its
checks, allocates its outputs and scratch, bumps its counters and reports
``cost.greedy_select``'s work; it builds, loads and launches nothing.

The plain version is :func:`repro_torch.kernels.ref.greedy_select`; the
dispatch in :mod:`repro_torch.kernels.ops` takes it for CPU tensors only.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, cost
from repro_torch.kernels.exemplar_gains import (BM, BN, check_tile,
                                                count_launches, row_bytes,
                                                row_operand)
from repro_torch.kernels.ref import greedy_select as plain  # noqa: F401


def launch(X: torch.Tensor, E: torch.Tensor, cur_min: torch.Tensor,
           avail: torch.Tensor, k: int, m_true: int, *,
           w: torch.Tensor | None = None,
           limit: torch.Tensor | None = None,
           gid: torch.Tensor | None = None, caps: torch.Tensor | None = None,
           ew: torch.Tensor | None = None, x_scale=None, x_zp=None,
           bf16dot: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    """Run k greedy steps on the card; returns ``(sel (M, k) int32,
    cur_min (M, mp))``.

    X ``(M, n, d)`` fp32, bf16, or int8 with ``x_scale``/``x_zp`` ``(M, n)``
    fp32, and E ``(mp, d)`` fp32 with ``mp % BM == 0`` (zero rows past
    ``m_true``); ``bf16dot`` contracts x·e in bf16; cur_min ``(M, mp)``
    fp32 and avail ``(M, n)``
    uint8 are the running state and are updated in place.  ``w`` ``(M, n)``
    fp32 with ``limit`` ``(1,)`` fp32, and ``gid`` ``(M, n)`` int32 with
    ``caps`` ``(G,)`` int32, encode the constraint (``None`` switches a
    part off).  ``ew``
    ``(mp,)`` fp32 are the eval weights, zero-padded like cur_min (``None``:
    unweighted).
    """
    M, n, d = X.shape
    mp = E.shape[0]
    G = 0 if caps is None else caps.shape[0]
    xtype = row_operand(X, x_scale, x_zp, "greedy_select")
    checks = [(X, (M, n, d), X.dtype), (E, (mp, d), torch.float32),
              (cur_min, (M, mp), torch.float32), (avail, (M, n), torch.uint8)]
    if w is not None:
        if limit is None:
            raise ValueError("greedy_select kernel: knapsack weights need their "
                             "limit")
        checks += [(w, (M, n), torch.float32), (limit, (1,), torch.float32)]
    if gid is not None:
        checks += [(gid, (M, n), torch.int32), (caps, (G,), torch.int32)]
    if ew is not None:
        checks.append((ew, (mp,), torch.float32))
    for t, shape, dtype in checks:
        if (not _build.on_card(t) or t.device != X.device
                or t.dtype != dtype or not t.is_contiguous()
                or tuple(t.shape) != shape):
            raise ValueError(f"greedy_select kernel takes contiguous {dtype} "
                             f"CUDA tensors of shape {shape}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
    if (mp % BM or not 0 < M < 65536 or not 0 < n < 2 ** 31 or k < 0
            or (gid is not None and G == 0)):
        raise ValueError(f"greedy_select kernel: unsupported shape "
                         f"M={M} n={n} mp={mp} k={k} G={G}")
    sel = torch.empty((M, k), dtype=torch.int32, device=X.device)
    if k == 0:
        return sel, cur_min
    constrained = w is not None or gid is not None
    check_tile(X.device, d, mp, ew is not None, "greedy_select")
    dry = _build.dry(X)
    if dry:
        # the occupancy query needs the built kernel: one CTA an SM here
        # (the winners' scratch is 8·(M + P) bytes, a few KB either way)
        P = min(cost.H100.sms, M * -(-n // BN))
    else:
        lib = _build.load("greedy_select")
        P = lib.greedy_select_grid(M, n, d, mp, int(constrained),
                                   int(ew is not None), xtype, int(bf16dot))
        if P <= 0:
            raise RuntimeError("greedy_select: occupancy query failed")
    # one winner per (CTA, machine segment): segment (c, mach) has slot
    # c + mach; the tickets start at 0 and every commit sets its back to 0
    win_v = torch.empty((M + P,), dtype=torch.float32, device=X.device)
    win_i = torch.empty((M + P,), dtype=torch.int32, device=X.device)
    ticket = torch.zeros((M,), dtype=torch.int32, device=X.device)
    if constrained:  # the running constraint state, device scratch
        used = torch.zeros((M,), dtype=torch.float32, device=X.device)
        counts = torch.zeros((M, max(G, 1)), dtype=torch.int32,
                             device=X.device)
    name = ("greedy_select_weighted" if ew is not None
            else "greedy_select_constrained" if constrained
            else "greedy_select")
    if dry:
        count_launches("greedy_select", name, xtype, bf16dot, k)
        cost.report(name, cost.greedy_select(
            M, n, d, mp, k, row_bytes=row_bytes(X, xtype),
            constrained=constrained, weighted=ew is not None))
        return sel, cur_min
    stream = torch.cuda.current_stream(X.device).cuda_stream
    _build.check(lib.greedy_select_launch(
                    X.data_ptr(), xtype,
                    None if x_scale is None else x_scale.data_ptr(),
                    None if x_zp is None else x_zp.data_ptr(), int(bf16dot),
                    E.data_ptr(), cur_min.data_ptr(),
                    avail.data_ptr(), win_v.data_ptr(), win_i.data_ptr(),
                    ticket.data_ptr(), sel.data_ptr(), M, n, d, mp, m_true,
                    k, P, None if w is None else w.data_ptr(),
                    used.data_ptr() if constrained else None,
                    None if w is None else limit.data_ptr(),
                    None if gid is None else gid.data_ptr(),
                    None if caps is None else caps.data_ptr(),
                    counts.data_ptr() if constrained else None, G,
                    None if ew is None else ew.data_ptr(), stream),
                 "greedy_select")
    count_launches("greedy_select", name, xtype, bf16dot, k)
    return sel, cur_min
