"""Fused k-step exemplar greedy: the CUDA kernels, plain version, launch.

Replaces the TPU kernel ``repro.kernels.greedy_select.greedy_select_pallas``
(``src/repro/kernels/greedy_select.py:207``, ``pl.pallas_call`` at
``:265``).  Source: ``csrc/greedy_select.cu`` with the gain tile of
``csrc/exemplar_tile.cuh`` (the same one ``exemplar_gains`` runs, so the
fused and the step-wise paths score a row with the same bits).

The TPU kernel is one launch whose sequential grid carries the running
state between steps.  Hopper blocks run in parallel and in no order, so
each greedy step is two launches over all M machines: a gains + tile-argmax
kernel over (candidate tiles, M), then a commit kernel per machine that
reduces the tile winners (lowest index on ties), refreshes ``cur_min`` in
the difference form and clears the winner's availability.  2k launches per
call; the running state lives in device scratch allocated here.

What bounds it on the H100: fp32 FMA issue of the gains, k·M·n·m·(2d + 3)
operations per call; the commit is O(k·M·m·d).  The step kernel fills the
card at M = 1 too (the centralized baseline over the whole ground set).

The plain version is :func:`repro_torch.kernels.ref.greedy_select`; the
dispatch in :mod:`repro_torch.kernels.ops` takes it for CPU tensors only.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.exemplar_gains import BM, BN
from repro_torch.kernels.ref import greedy_select as plain  # noqa: F401


def launch(X: torch.Tensor, E: torch.Tensor, cur_min: torch.Tensor,
           avail: torch.Tensor, k: int, m_true: int
           ) -> tuple[torch.Tensor, torch.Tensor]:
    """Run k greedy steps on the card; returns ``(sel (M, k) int32,
    cur_min (M, mp))``.

    X ``(M, n, d)`` and E ``(mp, d)`` fp32 with ``mp % BM == 0`` (zero
    rows past ``m_true``); cur_min ``(M, mp)`` fp32 and avail ``(M, n)``
    uint8 are the running state and are updated in place.
    """
    M, n, d = X.shape
    mp = E.shape[0]
    for t, shape, dtype in ((X, (M, n, d), torch.float32),
                            (E, (mp, d), torch.float32),
                            (cur_min, (M, mp), torch.float32),
                            (avail, (M, n), torch.uint8)):
        if (t.device.type != "cuda" or t.device != X.device
                or t.dtype != dtype or not t.is_contiguous()
                or tuple(t.shape) != shape):
            raise ValueError(f"greedy_select kernel takes contiguous {dtype} "
                             f"CUDA tensors of shape {shape}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
    if mp % BM or not 0 < M < 65536 or not 0 < n < 2 ** 31 or k < 0:
        raise ValueError(f"greedy_select kernel: unsupported shape "
                         f"M={M} n={n} mp={mp} k={k}")
    ntiles = -(-n // BN)
    win_v = torch.empty((M, ntiles), dtype=torch.float32, device=X.device)
    win_i = torch.empty((M, ntiles), dtype=torch.int32, device=X.device)
    sel = torch.empty((M, k), dtype=torch.int32, device=X.device)
    if k == 0:
        return sel, cur_min
    fn = _build.load("greedy_select").greedy_select_launch
    stream = torch.cuda.current_stream(X.device).cuda_stream
    _build.check(fn(X.data_ptr(), E.data_ptr(), cur_min.data_ptr(),
                    avail.data_ptr(), win_v.data_ptr(), win_i.data_ptr(),
                    sel.data_ptr(), M, n, d, mp, m_true, k, stream),
                 "greedy_select")
    _build.launch_counts["greedy_select"] += 2 * k
    return sel, cur_min
