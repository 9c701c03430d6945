"""The port's one tolerance, the near-tie rule for selections and the
near-threshold rule for threshold-batch accept sets.

Used by the tests (plain versions against the JAX package on the CPU) and
by ``chip_smoke.py`` (kernels against their plain versions on the card).
Never loosen it to make a comparison pass.
"""
from __future__ import annotations

import numpy as np
import torch

#: float outputs (gains, cur_min, values) agree within |a − b| ≤ ATOL + RTOL·|b|
RTOL = 1e-5
ATOL = 1e-5


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def max_abs_err(a, b) -> float:
    a, b = _np(a).astype(np.float64), _np(b).astype(np.float64)
    return float(np.max(np.abs(a - b))) if a.size else 0.0


def assert_close(actual, expected, what: str = "value") -> None:
    np.testing.assert_allclose(_np(actual), _np(expected), rtol=RTOL,
                               atol=ATOL, err_msg=what)


def near_tie(gap: np.ndarray, best: np.ndarray) -> np.ndarray:
    """Steps whose top-2 gain gap is within the tolerance of the best gain."""
    return gap <= ATOL + RTOL * np.abs(best)


def selections_agree(sel, sel_ref, gaps, best) -> tuple[bool, int]:
    """Compare two ``(..., k)`` selections under the near-tie rule.

    ``gaps``/``best`` are the reference's per-step top-2 gain gap and best
    gain.  Each machine's selections must match exactly up to its first
    near-tie step; returns (they do, the number of near-tie steps).
    """
    k = _np(sel).shape[-1]
    sel, sel_ref = _np(sel).reshape(-1, k), _np(sel_ref).reshape(-1, k)
    tie = near_tie(_np(gaps), _np(best)).reshape(sel.shape)
    first = np.where(tie.any(axis=1), tie.argmax(axis=1), sel.shape[1])
    upto = np.arange(sel.shape[1])[None, :] < first[:, None]
    return bool(np.all((sel == sel_ref) | ~upto)), int(tie.sum())


def accepts_agree(acc, acc_ref, gains, tau, *, load=None, limit=None,
                  avail=None) -> tuple[bool, int, int]:
    """Compare two ``(M, n)`` accept sets of one τ-level under the
    near-threshold rule.

    ``gains`` are the reference's per-row gains as its blocks scored them
    and ``tau`` ``(M,)`` the level; ``load`` the reference's knapsack load
    ``used + cumw`` per row against ``limit`` (``None`` without a
    knapsack); ``avail`` restricts the rule to available rows.  A row is
    *near threshold* when ``|g − τ| ≤ ATOL + RTOL·|τ|`` and *near budget*
    when ``|load − limit| ≤ ATOL + RTOL·|limit|``.  Each machine's accept
    set must match exactly up to its first near row, in row order.
    Returns (they do, machines whose sets match in full, near rows).
    """
    acc, acc_ref = _np(acc).astype(bool), _np(acc_ref).astype(bool)
    acc, acc_ref = acc.reshape(-1, acc.shape[-1]), acc_ref.reshape(acc.shape)
    g = _np(gains).astype(np.float64).reshape(acc.shape)
    t = _np(tau).astype(np.float64).reshape(-1, 1)
    near = np.abs(g - t) <= ATOL + RTOL * np.abs(t)
    if load is not None:
        ld = _np(load).astype(np.float64).reshape(acc.shape)
        near |= np.abs(ld - limit) <= ATOL + RTOL * abs(limit)
    if avail is not None:
        near &= _np(avail).astype(bool).reshape(acc.shape)
    n = acc.shape[1]
    first = np.where(near.any(axis=1), near.argmax(axis=1), n)
    upto = np.arange(n)[None, :] < first[:, None]
    agree = bool(np.all((acc == acc_ref) | ~upto))
    full = int(np.all(acc == acc_ref, axis=1).sum())
    return agree, full, int(near.sum())
