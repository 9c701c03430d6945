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
blocks < b left; a violation stops the launch), so here one CTA owns one
machine and loops over its ``bn``-row blocks, and the machines of a round
run in parallel: grid ``(M,)``, one launch per τ-level.  Per block it
scores the rows with the shared gain tile (the bits ``exemplar_gains``
gives them, so the row that sets ``d_max`` qualifies at level 0), walks
the qualifying rows in order to find the accepted prefix, and folds the
accepted rows' contraction-form distances into the machine's ``cur_min``.

``bn`` is part of the function's meaning: the kernel takes any
``1 ≤ bn ≤ 256``.  A machine with ``active == 0`` is left as it is (the
ladder's per-machine ``while`` condition).  Group ids outside
``[0, G)`` belong to no open group; the group counts live in shared memory,
so G is at most :func:`max_groups`.  Knapsack weights are non-negative.

What bounds it on the H100: fp32 FMA throughput of the gains, M·n·m·(2d + 3)
operations per level (the accept walk and the fold touch only qualifying
rows).  A round of M machines uses min(M, 132·2) CTAs at a time, so rounds
with a handful of machines leave most SMs idle.  Eval weights
(``WeightedExemplarClustering``) weigh the gains' eval columns in the
kernel's own weighted instantiation; its launches count as
``threshold_select_weighted``.

The plain version is :func:`repro_torch.kernels.ref.threshold_select`; the
dispatch in :mod:`repro_torch.kernels.ops` takes it for CPU tensors only.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.exemplar_gains import BM
from repro_torch.kernels.ref import threshold_select as plain  # noqa: F401

MAX_BN = 256  # rows per block the kernel takes (one thread each)

_max_groups: dict[tuple[int, bool], int] = {}


def max_groups(device: torch.device, weighted: bool = False) -> int:
    """The most partition groups one launch takes on ``device``: its group
    counts fill the block's opt-in shared memory less the kernel's static
    shared memory, as the built kernel reports them (the weighted
    instantiation stages its eval weights there too)."""
    key = (torch.device(device).index or 0, bool(weighted))
    if key not in _max_groups:
        got = _build.load("threshold_select").threshold_select_max_groups(
            key[0], int(key[1]))
        if got <= 0:
            raise RuntimeError(f"threshold_select: shared-memory query failed "
                               f"(CUDA error {-got})")
        _max_groups[key] = got
    return _max_groups[key]


def launch(X: torch.Tensor, E: torch.Tensor, cur_min: torch.Tensor,
           avail: torch.Tensor, tau: torch.Tensor, used: torch.Tensor,
           count: torch.Tensor, counts: torch.Tensor, active: torch.Tensor,
           k: int, bn: int, m_true: int, *, w: torch.Tensor | None = None,
           limit: float = 0.0, gid: torch.Tensor | None = None,
           caps: torch.Tensor | None = None,
           ew: torch.Tensor | None = None) -> torch.Tensor:
    """Run one level on the card; returns ``accept`` ``(M, n)`` uint8.

    X ``(M, n, d)`` and E ``(mp, d)`` fp32 with ``mp % BM == 0`` (zero
    rows past ``m_true``); cur_min ``(M, mp)`` fp32 is updated in place;
    avail ``(M, n)`` and active ``(M,)`` uint8; tau, used ``(M,)`` fp32;
    count ``(M,)`` int32; counts ``(M, G)`` int32.  ``w`` ``(M, n)`` fp32
    with ``limit``, and ``gid`` ``(M, n)`` int32 with ``caps`` ``(G,)``
    int32, encode the constraint (``None`` switches a part off).  ``ew``
    ``(mp,)`` fp32 are the eval weights, zero-padded like cur_min (``None``:
    unweighted).
    """
    M, n, d = X.shape
    mp = E.shape[0]
    G = 0 if caps is None else caps.shape[0]
    checks = [(X, (M, n, d), torch.float32), (E, (mp, d), torch.float32),
              (cur_min, (M, mp), torch.float32), (avail, (M, n), torch.uint8),
              (tau, (M,), torch.float32), (used, (M,), torch.float32),
              (count, (M,), torch.int32), (active, (M,), torch.uint8),
              (counts, (M, max(G, 1)), torch.int32)]
    if w is not None:
        checks.append((w, (M, n), torch.float32))
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
                and not 0 < G <= max_groups(X.device, ew is not None))):
        raise ValueError(f"threshold_select kernel: unsupported shape "
                         f"M={M} n={n} mp={mp} bn={bn} G={G}")
    accept = torch.zeros((M, n), dtype=torch.uint8, device=X.device)
    fn = _build.load("threshold_select").threshold_select_launch
    stream = torch.cuda.current_stream(X.device).cuda_stream
    _build.check(fn(X.data_ptr(), E.data_ptr(), cur_min.data_ptr(),
                    avail.data_ptr(), tau.data_ptr(), used.data_ptr(),
                    count.data_ptr(), counts.data_ptr(), active.data_ptr(),
                    None if w is None else w.data_ptr(),
                    None if gid is None else gid.data_ptr(),
                    None if caps is None else caps.data_ptr(),
                    accept.data_ptr(), M, n, d, mp, m_true, k, bn, G, limit,
                    None if ew is None else ew.data_ptr(), stream),
                 "threshold_select")
    _build.launch_counts["threshold_select" if ew is None
                         else "threshold_select_weighted"] += 1
    return accept
