"""One τ-level of threshold-batch selection: the CUDA kernel, its plain
version, its launch.

Replaces the TPU kernel
``repro.kernels.threshold_select.threshold_select_pallas``
(``src/repro/kernels/threshold_select.py:172``, ``pl.pallas_call`` at
``:238``).  Source: ``csrc/threshold_select.cu`` with the gain tile of
``csrc/exemplar_tile.cuh``.

The TPU kernel walks its candidate blocks in order on one core and carries
``cur_min``, the stop flag and the constraint scalars from block to block.
The semantics are block-sequential (block b's gains see the ``cur_min``
blocks < b left; a violation stops the launch).  Here one τ-level is three
launches.  The head, one CTA per machine, walks each machine's blocks in
order as the block-sequential walk does, until the machine is done or
``HEAD_EMPTIES`` blocks in a row have accepted nothing (a level at which
many rows qualify fills k or stops within a few blocks); it leaves the
other machines pending with their state in device scratch.  The pre-pass
scores every remaining row of the pending machines on the whole card (the
persistent tile pass ``greedy_select`` runs a step with) and flags each
``bn``-row block in which some row is available, reaches τ and is singly
feasible against the head's exit state.  The tail resumes the pending
machines and visits their flagged blocks only: it takes the pre-pass
gains as they are until the machine's first accept (the same tile at the
same ``cur_min``: the same bits), rescores a flagged block at its
block-entry ``cur_min`` after it, walks the qualifying rows in order to
find the accepted prefix, and folds the accepted rows' contraction-form
distances into ``cur_min``.  Every gain is the shared tile's, so the row
that sets ``d_max`` qualifies at level 0.  Skipping an unflagged block is
exact: gains only fall as ``cur_min`` falls, bit for bit, and ``used``
and the group counts only grow within a level (``csrc/threshold_select.cu``
says why).

``bn`` is part of the function's meaning: the kernel takes any
``1 ≤ bn ≤ 256``.  A machine with ``active == 0`` is left as it is (the
ladder's per-machine ``while`` condition).  Group ids outside
``[0, G)`` belong to no open group; the group counts live in shared memory,
so G is at most :func:`max_groups`.  Knapsack weights are non-negative.

What bounds it on the H100: the gain tile, four fp32 issue slots per
(candidate, eval column) pair scored beside its tensor-core products;
the head scores the blocks it walks, the pre-pass the pending machines'
rest, the tail rescores flagged blocks after a machine's first accept.
Eval weights (``WeightedExemplarClustering``)
weigh the gains' eval columns in the kernels' own weighted instantiations;
their heads count as ``threshold_select_weighted``.  Every pre-pass counts
as ``threshold_select_prepass`` and every tail as
``threshold_select_tail``.  Narrow rows (bf16, or int8 with per-row
``x_scale``/``x_zp``: the TPU kernel's ``quantized`` instantiation) and the
bf16 x·e contraction (``compute_dtype``) are the gain tile's operand
instantiations of all three kernels; the fold dequantizes the accepted
rows and, under the bf16 dot, takes their x·e in bf16 as the gains do.
Their heads count once more as ``threshold_select_bf16``, ``_q8`` and
``_bf16dot``.

The plain version is :func:`repro_torch.kernels.ref.threshold_select`; the
dispatch in :mod:`repro_torch.kernels.ops` takes it for CPU tensors only.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.exemplar_gains import (BM, check_tile,
                                                count_launches, row_operand)
from repro_torch.kernels.ref import threshold_select as plain  # noqa: F401

MAX_BN = 256  # rows per block the kernel takes (its block buffers)
HEAD_EMPTIES = 2  # csrc/threshold_select.cu's kHeadEmpties

_max_groups: dict[tuple[int, bool, int, int], int] = {}


def max_groups(device: torch.device, weighted: bool = False, d: int = 6,
               mp: int = BM) -> int:
    """The most partition groups one launch takes on ``device`` at feature
    width ``d`` and padded eval size ``mp``: the walk's group counts fill
    the block's opt-in shared memory less the kernel's static shared memory
    and the gain tile's (which grows with mp, and with the eval weights'
    stage where ``weighted``), as the built kernel reports them."""
    key = (torch.device(device).index or 0, bool(weighted), int(d), int(mp))
    if key not in _max_groups:
        got = _build.load("threshold_select").threshold_select_max_groups(
            *(int(v) for v in key))
        if got <= 0:
            raise RuntimeError(f"threshold_select: shared-memory query failed "
                               f"(CUDA error {-got})")
        _max_groups[key] = got
    return _max_groups[key]


def launch(X: torch.Tensor, E: torch.Tensor, cur_min: torch.Tensor,
           avail: torch.Tensor, tau: torch.Tensor, used: torch.Tensor,
           count: torch.Tensor, counts: torch.Tensor, active: torch.Tensor,
           k: int, bn: int, m_true: int, *, w: torch.Tensor | None = None,
           limit: torch.Tensor | None = None,
           gid: torch.Tensor | None = None,
           caps: torch.Tensor | None = None,
           ew: torch.Tensor | None = None,
           flags_out: torch.Tensor | None = None, x_scale=None, x_zp=None,
           bf16dot: bool = False) -> torch.Tensor:
    """Run one level on the card; returns ``accept`` ``(M, n)`` uint8.

    X ``(M, n, d)`` fp32, bf16, or int8 with ``x_scale``/``x_zp`` ``(M, n)``
    fp32, and E ``(mp, d)`` fp32 with ``mp % BM == 0`` (zero rows past
    ``m_true``); ``bf16dot`` contracts x·e in bf16; cur_min ``(M, mp)``
    fp32 is updated in place;
    avail ``(M, n)`` and active ``(M,)`` uint8; tau, used ``(M,)`` fp32;
    count ``(M,)`` int32; counts ``(M, G)`` int32.  ``w`` ``(M, n)`` fp32
    with ``limit`` ``(1,)`` fp32 (read on the card, as ``greedy_select``
    reads it), and ``gid`` ``(M, n)`` int32 with ``caps`` ``(G,)`` int32,
    encode the constraint (``None`` switches a part off).  ``ew``
    ``(mp,)`` fp32 are the eval weights, zero-padded like cur_min (``None``:
    unweighted).  ``flags_out`` ``(M, ceil(n / bn))`` uint8, where given,
    receives the pre-pass's block flags (1: the tail visits the block; the
    blocks the head walked and the machines it finished have none).
    """
    M, n, d = X.shape
    mp = E.shape[0]
    G = 0 if caps is None else caps.shape[0]
    xtype = row_operand(X, x_scale, x_zp, "threshold_select")
    checks = [(X, (M, n, d), X.dtype), (E, (mp, d), torch.float32),
              (cur_min, (M, mp), torch.float32), (avail, (M, n), torch.uint8),
              (tau, (M,), torch.float32), (used, (M,), torch.float32),
              (count, (M,), torch.int32), (active, (M,), torch.uint8),
              (counts, (M, max(G, 1)), torch.int32)]
    if w is not None:
        if limit is None:
            raise ValueError("threshold_select kernel: knapsack weights need their "
                             "limit")
        checks += [(w, (M, n), torch.float32), (limit, (1,), torch.float32)]
    if gid is not None:
        checks += [(gid, (M, n), torch.int32), (caps, (G,), torch.int32)]
    if ew is not None:
        checks.append((ew, (mp,), torch.float32))
    for t, shape, dtype in checks:
        if (t.device.type != "cuda" or t.device != X.device
                or t.dtype != dtype or not t.is_contiguous()
                or tuple(t.shape) != shape):
            raise ValueError(f"threshold_select kernel takes contiguous "
                             f"{dtype} CUDA tensors of shape {shape}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
    if (mp % BM or not 0 < M < 2 ** 31 or not 0 < n < 2 ** 31
            or not 1 <= bn <= MAX_BN
            or (gid is not None
                and not 0 < G <= max_groups(X.device, ew is not None, d,
                                            mp))):
        raise ValueError(f"threshold_select kernel: unsupported shape "
                         f"M={M} n={n} mp={mp} bn={bn} G={G}")
    check_tile(X.device, d, mp, ew is not None, "threshold_select")
    nblk = -(-n // bn)
    if flags_out is None:
        flags_out = torch.empty((M, nblk), dtype=torch.uint8,
                                device=X.device)
    elif (flags_out.device != X.device or flags_out.dtype != torch.uint8
          or not flags_out.is_contiguous()
          or tuple(flags_out.shape) != (M, nblk)):
        raise ValueError(f"threshold_select: flags_out must be a contiguous "
                         f"uint8 tensor of shape {(M, nblk)} on {X.device}")
    flags_out.zero_()
    accept = torch.zeros((M, n), dtype=torch.uint8, device=X.device)
    gains = torch.empty((M, n), dtype=torch.float32, device=X.device)
    # the head's exit state of the machines it leaves to the tail
    pending = torch.zeros((M,), dtype=torch.uint8, device=X.device)
    mid = [torch.empty((M,), dtype=dt, device=X.device)
           for dt in (torch.int32, torch.int32, torch.float32)]
    counts_mid = torch.empty_like(counts)
    fn = _build.load("threshold_select").threshold_select_launch
    stream = torch.cuda.current_stream(X.device).cuda_stream
    _build.check(fn(X.data_ptr(), xtype,
                    None if x_scale is None else x_scale.data_ptr(),
                    None if x_zp is None else x_zp.data_ptr(), int(bf16dot),
                    E.data_ptr(), cur_min.data_ptr(),
                    avail.data_ptr(), tau.data_ptr(), used.data_ptr(),
                    count.data_ptr(), counts.data_ptr(), active.data_ptr(),
                    None if w is None else w.data_ptr(),
                    None if gid is None else gid.data_ptr(),
                    None if caps is None else caps.data_ptr(),
                    accept.data_ptr(), gains.data_ptr(), flags_out.data_ptr(),
                    pending.data_ptr(), *(t.data_ptr() for t in mid),
                    counts_mid.data_ptr(), M, n, d, mp, m_true, k, bn, G,
                    None if w is None else limit.data_ptr(),
                    None if ew is None else ew.data_ptr(), stream),
                 "threshold_select")
    count_launches("threshold_select", "threshold_select" if ew is None
                   else "threshold_select_weighted", xtype, bf16dot)
    _build.launch_counts["threshold_select_prepass"] += 1
    _build.launch_counts["threshold_select_tail"] += 1
    return accept
