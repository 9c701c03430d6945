"""NumPy reference algorithms: plain GREEDY and LAZY GREEDY (Minoux 1978)
(counterpart of ``repro.core.reference``, the port's own copy).

The paper runs the lazy variant per machine (§4.3).  Lazy greedy selects
exactly what greedy selects (marginal gains only shrink under
submodularity, so a re-verified top of the heap is the global best) while
evaluating far fewer gains.  The port's :func:`repro_torch.core.greedy`
is plain greedy: on the card a full gain sweep is one launch, so laziness
buys nothing there.  These implementations are the third oracle of the
parity tests, beside the JAX package and the port's plain versions.
"""
from __future__ import annotations

import heapq
from typing import Callable, NamedTuple

import numpy as np


class RefResult(NamedTuple):
    sel_idx: np.ndarray     # (<=k,) selected indices, in selection order
    value: float
    oracle_calls: int


# ---------------------------------------------------------------------------
# Objective oracles (incremental, numpy)
# ---------------------------------------------------------------------------


class ExemplarOracle:
    """f(S) = mean(||E||²) - mean(min over S∪{0} of ||e - x||²)."""

    def __init__(self, data: np.ndarray, eval_set: np.ndarray):
        self.data = np.asarray(data, np.float32)
        self.E = np.asarray(eval_set, np.float32)
        self.e2 = np.sum(self.E * self.E, axis=1)
        self.cur_min = self.e2.copy()
        self.base = float(np.mean(self.e2))

    def gains_all(self, idx: np.ndarray) -> np.ndarray:
        X = self.data[idx]
        d2 = (np.sum(X * X, 1)[:, None] + self.e2[None, :]
              - 2.0 * X @ self.E.T)
        return np.maximum(self.cur_min[None, :] - np.maximum(d2, 0), 0).mean(1)

    def gain(self, i: int) -> float:
        x = self.data[i]
        d2 = np.maximum(self.e2 - 2.0 * self.E @ x + x @ x, 0)
        return float(np.maximum(self.cur_min - d2, 0).mean())

    def add(self, i: int) -> None:
        x = self.data[i]
        d2 = np.maximum(self.e2 - 2.0 * self.E @ x + x @ x, 0)
        self.cur_min = np.minimum(self.cur_min, d2)

    def value(self) -> float:
        return self.base - float(np.mean(self.cur_min))


class LogDetOracle:
    """f(S) = 1/2 logdet(I + σ⁻² K_SS), RBF kernel; incremental Cholesky.

    Maintains L = chol(I + σ⁻²K_SS); the marginal gain of candidate i is
    ½·log(1 + σ⁻²K_ii − cᵀc) with L c = σ⁻²K_{S,i} (Schur complement).
    """

    def __init__(self, data: np.ndarray, h: float = 0.5, sigma: float = 1.0):
        self.data = np.asarray(data, np.float64)
        self.h2 = h * h
        self.s2 = sigma * sigma
        self.sel: list[int] = []
        self.L = np.zeros((0, 0), np.float64)
        self._logdet = 0.0

    def _a_row(self, i) -> np.ndarray:
        if not self.sel:
            return np.zeros((0,), np.float64)
        x = self.data[i]
        Y = self.data[self.sel]
        d2 = np.sum((Y - x[None, :]) ** 2, axis=1)
        return np.exp(-d2 / self.h2) / self.s2

    def _schur(self, i) -> tuple[np.ndarray, float]:
        a = self._a_row(i)
        c = np.linalg.solve(self.L, a) if self.sel else a
        r = 1.0 + 1.0 / self.s2 - float(c @ c)
        return c, max(r, 1e-12)

    def gains_all(self, idx: np.ndarray) -> np.ndarray:
        return np.array([self.gain(int(i)) for i in idx])

    def gain(self, i: int) -> float:
        _, r = self._schur(i)
        return 0.5 * float(np.log(r))

    def add(self, i: int) -> None:
        c, r = self._schur(i)
        s = len(self.sel)
        L = np.zeros((s + 1, s + 1), np.float64)
        L[:s, :s] = self.L
        L[s, :s] = c
        L[s, s] = np.sqrt(r)
        self.L = L
        self.sel.append(int(i))
        self._logdet += float(np.log(r))

    def value(self) -> float:
        return 0.5 * self._logdet


# ---------------------------------------------------------------------------
# Algorithms
# ---------------------------------------------------------------------------


def plain_greedy(oracle, idx: np.ndarray, k: int) -> RefResult:
    """Batched plain greedy: one full gain sweep per step."""
    idx = np.asarray(idx)
    avail = np.ones(len(idx), bool)
    sel, calls = [], 0
    for _ in range(min(k, len(idx))):
        gains = oracle.gains_all(idx)
        gains[~avail] = -np.inf
        calls += int(avail.sum())
        b = int(np.argmax(gains))           # lowest index on ties
        if not np.isfinite(gains[b]):
            break
        sel.append(int(idx[b]))
        oracle.add(int(idx[b]))
        avail[b] = False
    return RefResult(np.array(sel, np.int64), oracle.value(), calls)


def lazy_greedy(oracle, idx: np.ndarray, k: int) -> RefResult:
    """Minoux lazy greedy with a max-heap of stale upper bounds."""
    idx = np.asarray(idx)
    gains = oracle.gains_all(idx)           # one full sweep
    calls = len(idx)
    # heap of (-gain, position, stale_flag round)
    heap = [(-g, p) for p, g in enumerate(gains)]
    heapq.heapify(heap)
    fresh = np.zeros(len(idx), np.int32)    # selection round when computed
    sel = []
    round_no = 0
    while heap and len(sel) < k:
        neg_g, p = heapq.heappop(heap)
        if fresh[p] == round_no:            # up to date → globally best
            sel.append(int(idx[p]))
            oracle.add(int(idx[p]))
            round_no += 1
        else:                               # stale → re-evaluate, push back
            g = oracle.gain(int(idx[p]))
            calls += 1
            fresh[p] = round_no
            heapq.heappush(heap, (-g, p))
    return RefResult(np.array(sel, np.int64), oracle.value(), calls)
