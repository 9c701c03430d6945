"""The port's one tolerance, and the near-tie rule for selections.

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
