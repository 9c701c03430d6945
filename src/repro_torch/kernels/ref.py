"""Plain PyTorch versions of the selection kernels (counterpart of
``repro.kernels.ref``).

They are the semantic ground truth of the port: the CPU tests hold them
against the JAX package's ``ref`` functions, and ``chip_smoke.py`` holds the
CUDA kernels against them on the card.  On a CPU tensor the dispatch in
:mod:`repro_torch.kernels.ops` runs them as the production path.

Scope of this slice: fp32, unconstrained, no ``compute_dtype``, no
``x_scale``/``x_zp`` dequant and no ``eval_weights``.  Each of those raises
:class:`NotImplementedError` naming the ROADMAP item that brings it.

Every function takes an optional leading machine axis: ``X`` is ``(n, d)``
or ``(M, n, d)``; per-machine state (``cur_min``, ``mask``) follows it.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30

# the (M, n, m) distance tensor of the plain greedy is built this many
# elements at a time (machine chunks), so a full tree round fits the card
_CHUNK_ELEMS = 1 << 28

_ROADMAP_ITEM = {
    "compute_dtype": "ROADMAP queue 1 item 10 (narrow operands)",
    "x_scale": "ROADMAP queue 1 item 10 (narrow operands)",
    "x_zp": "ROADMAP queue 1 item 10 (narrow operands)",
    "eval_weights": "ROADMAP queue 1 item 9 (WeightedExemplarClustering)",
    "weights": "ROADMAP queue 1 item 7 (constraints)",
    "budget": "ROADMAP queue 1 item 7 (constraints)",
    "group_ids": "ROADMAP queue 1 item 7 (constraints)",
    "caps": "ROADMAP queue 1 item 7 (constraints)",
}


def reject_unported(**kwargs) -> None:
    """Raise for any argument of the JAX signature this slice does not port."""
    for name, value in kwargs.items():
        if value is not None:
            raise NotImplementedError(
                f"{name}= is not ported yet: {_ROADMAP_ITEM[name]}")


def _exact_fp32(t: torch.Tensor) -> None:
    # the plain versions are the card's reference: a float32 product there
    # must not drop to TF32 (three decimal digits), so say so explicitly
    if t.is_cuda:
        torch.backends.cuda.matmul.allow_tf32 = False


def pairwise_sqdist(X: torch.Tensor, Y: torch.Tensor) -> torch.Tensor:
    """(..., n, d), (m, d) -> (..., n, m) squared euclidean distances."""
    _exact_fp32(X)
    x2 = torch.sum(X * X, dim=-1, keepdim=True)            # (..., n, 1)
    y2 = torch.sum(Y * Y, dim=-1)                          # (m,)
    d2 = x2 + y2 - 2.0 * (X @ Y.T)
    return torch.clamp_min(d2, 0.0)


def _sqdist(X: torch.Tensor, E: torch.Tensor,
            compute_dtype=None) -> torch.Tensor:
    """The contraction shared by :func:`exemplar_gains` and
    :func:`greedy_select` (fp32 only in this slice)."""
    reject_unported(compute_dtype=compute_dtype)
    return pairwise_sqdist(X, E)


def exemplar_gains(X: torch.Tensor, E: torch.Tensor, cur_min: torch.Tensor,
                   compute_dtype=None, x_scale=None, x_zp=None,
                   eval_weights=None) -> torch.Tensor:
    """gains[..., i] = (1/m) Σ_j max(0, cur_min[..., j] − ‖X[..., i] − E[j]‖²).

    ``cur_min`` is ``(m,)`` or carries the machine axis of ``X``.
    """
    reject_unported(x_scale=x_scale, x_zp=x_zp, eval_weights=eval_weights)
    d2 = _sqdist(X, E, compute_dtype)                      # (..., n, m)
    contrib = torch.clamp_min(cur_min.unsqueeze(-2) - d2, 0.0)
    return torch.sum(contrib, dim=-1) / E.shape[0]


def _greedy_chunk(X, E, cm, avail, k):
    """Plain k-step greedy over a (C, n, d) machine chunk; returns
    (sel (C, k), cur_min (C, m), top-2 gain gap (C, k), best gain (C, k))."""
    C, n, _ = X.shape
    m = E.shape[0]
    d2 = _sqdist(X, E)                                     # step-invariant
    rows = torch.arange(C, device=X.device)
    sel = torch.full((C, k), -1, dtype=torch.long, device=X.device)
    gaps = torch.full((C, k), float("inf"), dtype=torch.float32,
                      device=X.device)
    tops = torch.empty((C, k), dtype=torch.float32, device=X.device)
    avail = avail.clone()
    for t in range(k):
        contrib = torch.clamp_min(cm.unsqueeze(1) - d2, 0.0)
        g = torch.sum(contrib, dim=-1) / m
        g = torch.where(avail, g, torch.full_like(g, NEG_INF))
        best = torch.argmax(g, dim=-1)                     # lowest index on ties
        gbest = g[rows, best]
        ok = gbest > NEG_INF / 2
        tops[:, t] = gbest
        if n >= 2:
            top2 = torch.topk(g, 2, dim=-1).values
            gap = top2[:, 0] - top2[:, 1]
            gaps[:, t] = torch.where(top2[:, 1] > NEG_INF / 2, gap,
                                     torch.full_like(gap, float("inf")))
        x = X[rows, best]                                  # (C, d)
        d2b = torch.sum((E.unsqueeze(0) - x.unsqueeze(1)) ** 2, dim=-1)
        cm = torch.where(ok.unsqueeze(1), torch.minimum(cm, d2b), cm)
        avail[rows, best] = avail[rows, best] & ~ok
        sel[:, t] = torch.where(ok, best, torch.full_like(best, -1))
    return sel, cm, gaps, tops


def _greedy_rows(X, E, cm, avail, k):
    """:func:`_greedy_chunk` for one machine ``(n, d)`` whose ``(n, m)``
    distance tensor is too large to hold: each step recomputes the gains
    in row chunks and merges the chunks' winners (lowest index on ties)."""
    n = X.shape[0]
    m = E.shape[0]
    rows = max(1, _CHUNK_ELEMS // m)
    sel = torch.full((k,), -1, dtype=torch.long, device=X.device)
    gaps = torch.full((k,), float("inf"), dtype=torch.float32,
                      device=X.device)
    tops = torch.empty((k,), dtype=torch.float32, device=X.device)
    avail = avail.clone()
    for t in range(k):
        best_v, best_i, top = [], [], []
        for r0 in range(0, n, rows):
            contrib = torch.clamp_min(cm - _sqdist(X[r0:r0 + rows], E), 0.0)
            g = torch.sum(contrib, dim=-1) / m
            g = torch.where(avail[r0:r0 + rows], g,
                            torch.full_like(g, NEG_INF))
            i = torch.argmax(g)                            # lowest in chunk
            best_v.append(g[i])
            best_i.append(i + r0)
            top.append(torch.topk(g, min(2, g.shape[0])).values)
        best_v = torch.stack(best_v)
        c = torch.argmax(best_v)                           # lowest chunk
        best, gbest = torch.stack(best_i)[c], best_v[c]
        ok = gbest > NEG_INF / 2
        tops[t] = gbest
        top = torch.cat(top)
        if top.shape[0] >= 2:
            top2 = torch.topk(top, 2).values
            gaps[t] = torch.where(top2[1] > NEG_INF / 2, top2[0] - top2[1],
                                  torch.full_like(top2[0], float("inf")))
        d2b = torch.sum((E - X[best]) ** 2, dim=-1)
        cm = torch.where(ok, torch.minimum(cm, d2b), cm)
        avail[best] = avail[best] & ~ok
        sel[t] = torch.where(ok, best, torch.full_like(best, -1))
    return sel, cm, gaps, tops


def greedy_select_trace(X: torch.Tensor, E: torch.Tensor,
                        cur_min: torch.Tensor, mask: torch.Tensor, k: int):
    """:func:`greedy_select` plus, per step, the top-2 gain gap (inf where
    at most one candidate remained) and the best gain — what the near-tie
    rule of :mod:`repro_torch.testing` needs.  Returns
    ``(sel, cur_min, gap, best)``."""
    batched = X.dim() == 3
    if not batched:
        X, mask = X.unsqueeze(0), mask.unsqueeze(0)
        cur_min = cur_min.unsqueeze(0) if cur_min.dim() == 1 else cur_min
    M, n, _ = X.shape
    m = E.shape[0]
    cm = cur_min.expand(M, m) if cur_min.dim() == 1 else cur_min
    if n * m > _CHUNK_ELEMS:            # one machine's distances do not fit
        parts = [tuple(o.unsqueeze(0) for o in
                       _greedy_rows(X[i], E, cm[i], mask[i].bool(), k))
                 for i in range(M)]
    else:
        step = _CHUNK_ELEMS // max(1, n * m)
        parts = [_greedy_chunk(X[i:i + step], E, cm[i:i + step],
                               mask[i:i + step].bool(), k)
                 for i in range(0, M, step)]
    out = tuple(torch.cat([p[j] for p in parts]) for j in range(4))
    return out if batched else tuple(o[0] for o in out)


def refresh_cur_min(X: torch.Tensor, E: torch.Tensor, cur_min: torch.Tensor,
                    sel: torch.Tensor) -> torch.Tensor:
    """The running minimum after the selections ``sel`` (block positions,
    −1 for none), refreshed from ``cur_min`` step by step in the difference
    form, as :func:`greedy_select` refreshes it — so a selection that
    parted from the plain one at a near tie still has its ``cur_min``
    checked."""
    batched = X.dim() == 3
    if not batched:
        X, sel = X.unsqueeze(0), sel.unsqueeze(0)
    M, m = X.shape[0], E.shape[0]
    rows = torch.arange(M, device=X.device)
    cm = cur_min.reshape(-1, m).expand(M, m)
    for t in range(sel.shape[1]):
        ok = sel[:, t] >= 0
        x = X[rows, torch.clamp_min(sel[:, t], 0).long()]
        d2b = torch.sum((E.unsqueeze(0) - x.unsqueeze(1)) ** 2, dim=-1)
        cm = torch.where(ok.unsqueeze(1), torch.minimum(cm, d2b), cm)
    return cm if batched else cm[0]


def greedy_select(X: torch.Tensor, E: torch.Tensor, cur_min: torch.Tensor,
                  mask: torch.Tensor, k: int, compute_dtype=None,
                  weights=None, budget=None, group_ids=None, caps=None,
                  x_scale=None, x_zp=None, eval_weights=None):
    """Fused k-step exemplar greedy (plain version).

    Returns ``(sel_idx, cur_min_out)``: the block position chosen at each
    step (−1 from the first step with no available candidate on) and the
    running minimum after all selections.  Gains use the contraction form
    of :func:`exemplar_gains`; the ``cur_min`` refresh uses the objective's
    difference form ``Σ(E − x)²`` — the mix the step-wise scan runs.
    """
    reject_unported(compute_dtype=compute_dtype, weights=weights,
                    budget=budget, group_ids=group_ids, caps=caps,
                    x_scale=x_scale, x_zp=x_zp, eval_weights=eval_weights)
    sel, cm, _, _ = greedy_select_trace(X, E, cur_min, mask, k)
    return sel, cm
