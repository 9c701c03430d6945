"""Plain PyTorch versions of the kernels (counterpart of
``repro.kernels.ref``): the selection kernels, ``rbf_kernel``,
``flash_attention`` and ``wkv6``.

They are the semantic ground truth of the port: the CPU tests hold them
against the JAX package's ``ref`` functions, and ``chip_smoke.py`` holds the
CUDA kernels against them on the card.  On a CPU tensor the dispatch in
:mod:`repro_torch.kernels.ops` runs them as the production path.

Narrow candidate rows: ``X`` may be bf16, or int8 with per-row
``x_scale``/``x_zp``; every selection kernel first takes
:func:`dequantize_rows` (``x·scale + zp`` in fp32, two roundings), so
every later read of a row sees those fp32 values.  ``compute_dtype=
torch.bfloat16`` contracts x·e over bf16 rows and eval rows with fp32
sums, while ‖x‖² and ‖e‖² stay fp32 (:func:`_sqdist`).  ``eval_weights``
``(m,)`` reweights the eval columns of every exemplar gain
(``WeightedExemplarClustering``): each column's clamped contribution is
multiplied by its weight before the sum, so a weight of exactly 1.0 gives
the unweighted bits.

Every function takes an optional leading machine axis: ``X`` is ``(n, d)``
or ``(M, n, d)``; per-machine state (``cur_min``, ``mask``, constraint
operands and state) follows it.

Constraint encodings (``greedy_select``, ``threshold_select``):
``weights``/``budget`` a knapsack, compared as ``used + w <= limit`` with
the one fp32 constant ``limit = float32(budget + KNAPSACK_TOL)``;
``group_ids``/``caps`` a partition matroid.  A row whose group id lies
outside ``[0, len(caps))`` belongs to no open group and is never feasible
(the JAX ``ref.greedy_select`` clamps such ids instead; its
``ref.threshold_select`` and both Pallas kernels refuse them, as here).
"""
from __future__ import annotations

import numpy as np
import torch

NEG_INF = -1e30

# the (M, n, m) distance tensor of the plain versions is built this many
# elements at a time (machine chunks), so a full tree round fits the card
_CHUNK_ELEMS = 1 << 28


def check_compute_dtype(compute_dtype) -> bool:
    """Whether x·e is contracted in bf16: ``compute_dtype`` is None (fp32)
    or ``torch.bfloat16``; anything else raises."""
    if compute_dtype is None:
        return False
    if compute_dtype is torch.bfloat16:
        return True
    raise ValueError(f"compute_dtype must be None or torch.bfloat16, got "
                     f"{compute_dtype!r}")


def dequantize_rows(X: torch.Tensor, x_scale=None, x_zp=None
                    ) -> torch.Tensor:
    """Narrow candidate rows → fp32: ``X.float() * scale + zp`` per row
    (``x_scale``/``x_zp`` follow X's leading axes), two roundings, as
    ``repro.kernels.ref.dequantize_rows`` and the hosts' NumPy compute it;
    the plain upcast for bf16 and fp32 rows."""
    if (x_scale is None) != (x_zp is None):
        raise ValueError("x_scale and x_zp pair up")
    Xf = X.float()
    if x_scale is not None:
        Xf = Xf * x_scale.float().unsqueeze(-1) + x_zp.float().unsqueeze(-1)
    return Xf


def knapsack_limit(budget) -> float:
    """``float32(budget + KNAPSACK_TOL)``: the two Python floats add in
    double and round once to fp32, as the JAX package compares them with
    the fp32 ``used + w`` (the static ``Knapsack``)."""
    from repro_torch.core.constraints import KNAPSACK_TOL
    return float(np.float32(float(budget) + KNAPSACK_TOL))


def dynamic_limit(budget: torch.Tensor) -> torch.Tensor:
    """``budget + KNAPSACK_TOL`` as one fp32 add where the budget lies (the
    ``DynamicKnapsack`` reading, the JAX class's arithmetic): no host read,
    so a captured solve takes any budget."""
    from repro_torch.core.constraints import KNAPSACK_TOL
    return budget.to(torch.float32) + KNAPSACK_TOL


def limit_operand(budget, device) -> torch.Tensor:
    """The knapsack limit as the ``(1,)`` fp32 tensor on ``device`` that
    the kernels read: :func:`dynamic_limit` of a tensor budget, else
    :func:`knapsack_limit` of a number (written by a fill, no copy)."""
    if isinstance(budget, torch.Tensor):
        return dynamic_limit(budget.to(device)).reshape(1)
    return torch.full((1,), knapsack_limit(budget), dtype=torch.float32,
                      device=device)


def exact_fp32(t: torch.Tensor) -> None:
    # the plain versions are the card's reference: a float32 product there
    # must not drop to TF32 (three decimal digits), so say so explicitly
    if t.is_cuda:
        torch.backends.cuda.matmul.allow_tf32 = False


def pairwise_sqdist(X: torch.Tensor, Y: torch.Tensor) -> torch.Tensor:
    """(..., n, d), (m, d) -> (..., n, m) squared euclidean distances."""
    exact_fp32(X)
    x2 = torch.sum(X * X, dim=-1, keepdim=True)            # (..., n, 1)
    y2 = torch.sum(Y * Y, dim=-1)                          # (m,)
    d2 = x2 + y2 - 2.0 * (X @ Y.T)
    return torch.clamp_min(d2, 0.0)


def _sq_norms(X: torch.Tensor) -> torch.Tensor:
    """(..., n, d) -> (..., n): Σ_c x_c·x_c in feature order, each product
    rounded before its add (see :func:`rbf_kernel`)."""
    s = torch.zeros(X.shape[:-1], dtype=torch.float32, device=X.device)
    for c in range(X.shape[-1]):
        s = s + X[..., c] * X[..., c]
    return s


def _rbf_block(X, x2, Y, y2, h: float) -> torch.Tensor:
    """One chunk of :func:`rbf_kernel`: ``X`` (C, n, d) with norms ``x2``
    (C, n), ``Y`` (C, m, d) with ``y2`` (C, m), C broadcasting."""
    dot = torch.zeros((max(X.shape[0], Y.shape[0]), X.shape[1], Y.shape[1]),
                      dtype=torch.float32, device=X.device)
    for c in range(X.shape[-1]):
        dot += X[..., c].unsqueeze(-1) * Y[..., c].unsqueeze(-2)
    d2 = x2.unsqueeze(-1) + y2.unsqueeze(-2) - 2.0 * dot
    return torch.exp(-torch.clamp_min(d2, 0.0) / (h * h))


def rbf_kernel(X: torch.Tensor, Y: torch.Tensor, h: float) -> torch.Tensor:
    """K[..., i, j] = exp(−max(‖x_i‖² + ‖y_j‖² − 2 x_i·y_j, 0) / (h·h)).

    The contraction form of :func:`pairwise_sqdist` with ``max(d², 0)``,
    as ``repro.kernels.ref.rbf_kernel`` computes it.  ``‖x‖²``, ``‖y‖²`` and
    ``x·y`` are each summed over the feature axis in order, every product
    rounded before its add: the CUDA kernel keeps that order and does not
    fuse, so both give a pair the same d² bits.  Near x = y the contraction
    form cancels, and at h = 0.5 a d² that differs by an ulp of ‖x‖² moves
    K by 4 ulps of ‖x‖², so a different order would part the two by more
    than the tolerance on rows of large norm.

    ``X`` is ``(n, d)`` or ``(Mx, n, d)``, ``Y`` ``(m, d)`` or ``(My, m, d)``:
    a machine axis on either operand or on both (``Mx, My ∈ {1, M}``).
    Returns ``(n, m)``, or ``(M, n, m)`` where either had the axis.  Scored
    a machine chunk at a time (row chunks of ``X`` where one machine's
    ``(n, m)`` is too large), so no chunk holds more than ``_CHUNK_ELEMS``
    elements beside the output.
    """
    batched = X.dim() == 3 or Y.dim() == 3
    X3 = (X if X.dim() == 3 else X.unsqueeze(0)).float()
    Y3 = (Y if Y.dim() == 3 else Y.unsqueeze(0)).float()
    Mx, My = X3.shape[0], Y3.shape[0]
    M, n, m = max(Mx, My), X3.shape[1], Y3.shape[1]
    if Mx not in (1, M) or My not in (1, M) or X3.shape[2] != Y3.shape[2]:
        raise ValueError(f"rbf_kernel: shapes {tuple(X.shape)} and "
                         f"{tuple(Y.shape)} do not pair up")
    out = torch.empty((M, n, m), dtype=torch.float32, device=X.device)
    x2, y2 = _sq_norms(X3), _sq_norms(Y3)
    mstep = max(1, _CHUNK_ELEMS // max(1, n * m))
    rstep = n if n * m <= _CHUNK_ELEMS else max(1, _CHUNK_ELEMS // max(1, m))
    for i in range(0, M, mstep):
        xs = slice(i, i + mstep) if Mx > 1 else slice(None)
        ys = slice(i, i + mstep) if My > 1 else slice(None)
        for r0 in range(0, n, rstep):
            rs = slice(r0, r0 + rstep)
            out[i:i + mstep, rs] = _rbf_block(X3[xs, rs], x2[xs, rs],
                                              Y3[ys], y2[ys], h)
    return out if batched else out[0]


def _sqdist(X: torch.Tensor, E: torch.Tensor,
            compute_dtype=None) -> torch.Tensor:
    """The contraction shared by every gain here: fp32, or with
    ``compute_dtype=torch.bfloat16`` x·e over bf16 operands with fp32 sums
    (the bf16 products are exact in fp32; ``X.bfloat16() @ …`` would
    round the product to bf16 once more) and ‖x‖², ‖e‖² in fp32."""
    if not check_compute_dtype(compute_dtype):
        return pairwise_sqdist(X, E)
    exact_fp32(X)
    x2 = torch.sum(X * X, dim=-1, keepdim=True)
    e2 = torch.sum(E * E, dim=-1)
    xy = X.bfloat16().float() @ E.bfloat16().float().T
    return torch.clamp_min(x2 + e2 - 2.0 * xy, 0.0)


def exemplar_gains(X: torch.Tensor, E: torch.Tensor, cur_min: torch.Tensor,
                   compute_dtype=None, x_scale=None, x_zp=None,
                   eval_weights=None) -> torch.Tensor:
    """gains[..., i] = (1/m) Σ_j w_j·max(0, cur_min[..., j] − ‖X[..., i] − E[j]‖²).

    ``cur_min`` is ``(m,)`` or carries the machine axis of ``X``;
    ``eval_weights`` ``(m,)`` are the w_j (1 where None).  A
    ``(M, n, d)`` stack whose ``(M, n, m)`` distances exceed the chunk
    size is scored a machine chunk at a time (a row's gain does not depend
    on the chunk).  ``X`` may be narrow (see :func:`dequantize_rows`);
    ``compute_dtype`` is the contraction's (see :func:`_sqdist`).
    """
    X = dequantize_rows(X, x_scale, x_zp)
    m = E.shape[0]
    if (X.dim() == 3 and X.shape[0] > 1
            and X.shape[0] * X.shape[1] * m > _CHUNK_ELEMS):
        step = max(1, _CHUNK_ELEMS // (X.shape[1] * m))
        cm = cur_min.reshape(-1, m).expand(X.shape[0], m)
        return torch.cat([exemplar_gains(X[i:i + step], E, cm[i:i + step],
                                         compute_dtype,
                                         eval_weights=eval_weights)
                          for i in range(0, X.shape[0], step)])
    d2 = _sqdist(X, E, compute_dtype)                      # (..., n, m)
    return _gain_sums(cur_min.unsqueeze(-2), d2, eval_weights) / m


def _gain_sums(cm: torch.Tensor, d2: torch.Tensor, ew) -> torch.Tensor:
    """Σ_j w_j·max(0, cm_j − d2_ij) over the last axis (w ≡ 1 where
    ``ew`` is None): the one gain reduction of every plain version."""
    contrib = torch.clamp_min(cm - d2, 0.0)
    if ew is not None:
        contrib = contrib * ew
    return torch.sum(contrib, dim=-1)


# -- constraint encodings ---------------------------------------------------


class Encoding:
    """The fused constraint operands of one call, batched over machines:
    ``w`` ``(M, n)`` fp32 with ``limit`` ``(1,)`` fp32, ``gid`` ``(M, n)``
    int32 with ``caps`` ``(G,)`` int32; either pair may be absent.  Built
    once per call (or once per ladder, passed on as ``enc=``), contiguous
    and on the device, so the kernels take these operands as they are.
    ``budget`` and ``caps`` may be numbers (``Knapsack``,
    ``PartitionMatroid``) or device tensors (the ``Dynamic*`` classes):
    the tensors are never read by the host (:func:`limit_operand`)."""

    def __init__(self, M, n, device, weights=None, budget=None,
                 group_ids=None, caps=None):
        if (weights is None) != (budget is None):
            raise ValueError("weights and budget pair up")
        if (group_ids is None) != (caps is None):
            raise ValueError("group_ids and caps pair up")
        self.w = self.limit = self.gid = self.caps = None
        if weights is not None:
            self.w = torch.as_tensor(weights, dtype=torch.float32,
                                     device=device).reshape(M, n).contiguous()
            self.limit = limit_operand(budget, device)
        if caps is not None:
            self.gid = torch.as_tensor(group_ids, device=device).reshape(
                M, n).to(torch.int32).contiguous()
            self.caps = (caps.to(device=device, dtype=torch.int32)
                         .reshape(-1).contiguous()
                         if isinstance(caps, torch.Tensor) else
                         torch.as_tensor(tuple(int(c) for c in caps),
                                         dtype=torch.int32, device=device))
        self.G = 1 if self.caps is None else int(self.caps.shape[0])

    def rows(self, sl) -> "Encoding":
        """The same encoding over machines/rows ``sl`` of ``(M, n)``."""
        out = Encoding.__new__(Encoding)
        out.limit, out.caps, out.G = self.limit, self.caps, self.G
        out.w = None if self.w is None else self.w[sl]
        out.gid = None if self.gid is None else self.gid[sl]
        return out

    def feasible(self, avail, used, counts):
        """Candidates that are available and singly feasible against the
        running ``used`` (...,) and ``counts`` (..., G)."""
        cand = avail
        if self.w is not None:
            cand = cand & (used.unsqueeze(-1) + self.w <= self.limit)
        if self.gid is not None:
            cand = cand & group_open(counts, self.gid, self.caps)
        return cand


def encoding(M, n, device, enc=None, weights=None, budget=None,
             group_ids=None, caps=None) -> Encoding:
    """``enc`` where the caller built it once for many calls, else the
    encoding of the raw operands (never both)."""
    if enc is None:
        return Encoding(M, n, device, weights, budget, group_ids, caps)
    if any(v is not None for v in (weights, budget, group_ids, caps)):
        raise ValueError("pass enc or the raw constraint operands, not both")
    return enc


def group_open(counts: torch.Tensor, gid: torch.Tensor, caps: torch.Tensor
               ) -> torch.Tensor:
    """Rows whose group is in ``[0, G)`` and below its cap: ``counts``
    ``(..., G)``, ``gid`` ``(..., n)`` → ``(..., n)`` bool."""
    inr = (gid >= 0) & (gid < caps.shape[0])
    safe = torch.where(inr, gid, torch.zeros_like(gid)).long()
    return inr & (torch.gather(counts, -1, safe) < caps[safe])


def commit_state(enc: Encoding, used, counts, best, ok):
    """Add the selected rows ``best`` (where ``ok``) to the state."""
    rows = torch.arange(best.shape[0], device=best.device)
    if enc.w is not None:
        used = torch.where(ok, used + enc.w[rows, best], used)
    if enc.gid is not None:
        hit = torch.arange(enc.G, device=best.device) == \
            enc.gid[rows, best].unsqueeze(-1)
        counts = counts + (hit & ok.unsqueeze(-1)).to(counts.dtype)
    return used, counts


# -- greedy -------------------------------------------------------------------


def _greedy_chunk(X, E, cm, avail, k, enc: Encoding, ew=None, cd=None):
    """Plain k-step greedy over a (C, n, d) machine chunk of fp32 rows,
    contracted as ``cd`` says; returns (sel (C, k), cur_min (C, m), top-2
    gain gap (C, k), best gain (C, k))."""
    C, n, _ = X.shape
    m = E.shape[0]
    d2 = _sqdist(X, E, cd)                                 # step-invariant
    rows = torch.arange(C, device=X.device)
    sel = torch.full((C, k), -1, dtype=torch.long, device=X.device)
    gaps = torch.full((C, k), float("inf"), dtype=torch.float32,
                      device=X.device)
    tops = torch.empty((C, k), dtype=torch.float32, device=X.device)
    avail = avail.clone()
    used = torch.zeros((C,), dtype=torch.float32, device=X.device)
    counts = torch.zeros((C, enc.G), dtype=torch.int32, device=X.device)
    for t in range(k):
        g = _gain_sums(cm.unsqueeze(1), d2, ew) / m
        g = torch.where(enc.feasible(avail, used, counts), g,
                        torch.full_like(g, NEG_INF))
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
        used, counts = commit_state(enc, used, counts, best, ok)
        avail[rows, best] = avail[rows, best] & ~ok
        sel[:, t] = torch.where(ok, best, torch.full_like(best, -1))
    return sel, cm, gaps, tops


def _greedy_rows(X, E, cm, avail, k, enc: Encoding, ew=None, cd=None):
    """:func:`_greedy_chunk` for one machine ``(1, n, d)`` whose ``(n, m)``
    distance tensor is too large to hold: each step recomputes the gains
    in row chunks and merges the chunks' winners (lowest index on ties)."""
    n = X.shape[1]
    m = E.shape[0]
    rows = max(1, _CHUNK_ELEMS // m)
    sel = torch.full((1, k), -1, dtype=torch.long, device=X.device)
    gaps = torch.full((1, k), float("inf"), dtype=torch.float32,
                      device=X.device)
    tops = torch.empty((1, k), dtype=torch.float32, device=X.device)
    avail = avail.clone()
    used = torch.zeros((1,), dtype=torch.float32, device=X.device)
    counts = torch.zeros((1, enc.G), dtype=torch.int32, device=X.device)
    for t in range(k):
        best_v, best_i, top = [], [], []
        for r0 in range(0, n, rows):
            sl = (slice(None), slice(r0, r0 + rows))
            g = _gain_sums(cm, _sqdist(X[sl], E, cd), ew)[0] / m
            cand = enc.rows(sl).feasible(avail[sl], used, counts)[0]
            g = torch.where(cand, g, torch.full_like(g, NEG_INF))
            i = torch.argmax(g)                            # lowest in chunk
            best_v.append(g[i])
            best_i.append(i + r0)
            top.append(torch.topk(g, min(2, g.shape[0])).values)
        best_v = torch.stack(best_v)
        c = torch.argmax(best_v)                           # lowest chunk
        best, gbest = torch.stack(best_i)[c], best_v[c]
        ok = gbest > NEG_INF / 2
        tops[0, t] = gbest
        top = torch.cat(top)
        if top.shape[0] >= 2:
            top2 = torch.topk(top, 2).values
            gaps[0, t] = torch.where(top2[1] > NEG_INF / 2,
                                     top2[0] - top2[1],
                                     torch.full_like(top2[0], float("inf")))
        d2b = torch.sum((E - X[0, best]) ** 2, dim=-1)
        cm = torch.where(ok, torch.minimum(cm, d2b), cm)
        used, counts = commit_state(enc, used, counts, best[None], ok[None])
        avail[0, best] = avail[0, best] & ~ok
        sel[0, t] = torch.where(ok, best, torch.full_like(best, -1))
    return sel, cm, gaps, tops


def _batched(X, mask, cur_min, m):
    """(X, mask, cm) with the machine axis, and whether it was there."""
    batched = X.dim() == 3
    if not batched:
        X, mask = X.unsqueeze(0), mask.unsqueeze(0)
    cm = cur_min.reshape(-1, m).expand(X.shape[0], m)
    return batched, X, mask.bool(), cm


def greedy_select_trace(X: torch.Tensor, E: torch.Tensor,
                        cur_min: torch.Tensor, mask: torch.Tensor, k: int,
                        *, weights=None, budget=None, group_ids=None,
                        caps=None, enc=None, eval_weights=None,
                        compute_dtype=None, x_scale=None, x_zp=None):
    """:func:`greedy_select` plus, per step, the top-2 gain gap among the
    step's candidates (inf where at most one remained) and the best gain —
    what the near-tie rule of :mod:`repro_torch.testing` needs.  Returns
    ``(sel, cur_min, gap, best)``."""
    m = E.shape[0]
    X = dequantize_rows(X, x_scale, x_zp)
    check_compute_dtype(compute_dtype)
    batched, X, mask, cm = _batched(X, mask, cur_min, m)
    M, n, _ = X.shape
    enc = encoding(M, n, X.device, enc, weights, budget, group_ids, caps)
    if n * m > _CHUNK_ELEMS:            # one machine's distances do not fit
        parts = [_greedy_rows(X[i:i + 1], E, cm[i:i + 1], mask[i:i + 1], k,
                              enc.rows(slice(i, i + 1)), eval_weights,
                              compute_dtype)
                 for i in range(M)]
    else:
        step = _CHUNK_ELEMS // max(1, n * m)
        parts = [_greedy_chunk(X[i:i + step], E, cm[i:i + step],
                               mask[i:i + step], k,
                               enc.rows(slice(i, i + step)), eval_weights,
                               compute_dtype)
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
                  x_scale=None, x_zp=None, eval_weights=None, enc=None):
    """Fused k-step exemplar greedy (plain version).

    Returns ``(sel_idx, cur_min_out)``: the block position chosen at each
    step (−1 from the first step with no feasible candidate on) and the
    running minimum after all selections.  Gains use the contraction form
    of :func:`exemplar_gains`; the ``cur_min`` refresh uses the objective's
    difference form ``Σ(E − x)²`` — the mix the step-wise scan runs.

    ``weights``/``budget`` add a knapsack (candidates with
    ``used + w <= limit`` under the sequentially accumulated fp32
    ``used``), ``group_ids``/``caps`` a partition matroid (candidates whose
    group count is below its cap); they compose, as the step-wise
    ``Intersection`` does.  ``weights`` and ``group_ids`` follow ``X``'s
    machine axis; ``budget`` and ``caps`` are shared.  ``enc`` is the
    same operands as an :class:`Encoding` already built; ``eval_weights``
    ``(m,)`` weigh the eval columns of every step's gains.  Narrow ``X``
    (``x_scale``/``x_zp``) is dequantized once up front, so the gains and
    the refresh see the same fp32 rows; ``compute_dtype`` applies to the
    gains' contraction only (the refresh is fp32).
    """
    sel, cm, _, _ = greedy_select_trace(X, E, cur_min, mask, k,
                                        weights=weights, budget=budget,
                                        group_ids=group_ids, caps=caps,
                                        enc=enc, eval_weights=eval_weights,
                                        compute_dtype=compute_dtype,
                                        x_scale=x_scale, x_zp=x_zp)
    return sel, cm


# -- threshold batch --------------------------------------------------------


def _threshold_chunk(X, E, cm, avail, tau, k, used, counts, count, bn,
                     enc: Encoding, active, ew=None, cd=None):
    """One τ-level over a (C, n, d) machine chunk of fp32 rows,
    block-sequential at ``bn``, contracted as ``cd`` says.  Returns
    (accept, cur_min, gains as scored, knapsack load ``used + cumw`` per
    row)."""
    C, n, _ = X.shape
    m = E.shape[0]
    d2 = _sqdist(X, E, cd) if n * m <= _CHUNK_ELEMS else None
    cm = cm.clone()
    used, counts, count = used.clone(), counts.clone(), count.clone().long()
    stopped = torch.zeros((C,), dtype=torch.bool, device=X.device)
    inf = torch.tensor(float("inf"), device=X.device)
    accepts, gains, loads = [], [], []
    for b0 in range(0, n, bn):
        b1 = min(b0 + bn, n)
        d2b = (d2[:, b0:b1] if d2 is not None
               else _sqdist(X[:, b0:b1], E, cd))
        g = _gain_sums(cm.unsqueeze(1), d2b, ew) / m
        q = avail[:, b0:b1] & (g >= tau.unsqueeze(1)) & active.unsqueeze(1)
        blk = enc.rows((slice(None), slice(b0, b1)))
        q = blk.feasible(q, used, counts)
        cumn = torch.cumsum(q.long(), dim=-1)
        violate = (count.unsqueeze(1) + cumn) > k
        if blk.w is not None:
            cumw = torch.cumsum(torch.where(q, blk.w, 0.0), dim=-1)
            load = used.unsqueeze(1) + cumw
            violate = violate | (load > blk.limit)
            loads.append(load)
        if blk.gid is not None:
            for grp in range(enc.G):
                cg = torch.cumsum((q & (blk.gid == grp)).long(), dim=-1)
                violate = violate | ((counts[:, grp:grp + 1] + cg)
                                     > enc.caps[grp])
        acc = q & (torch.cumsum(violate.long(), dim=-1) == 0) \
            & ~stopped.unsqueeze(1)
        stopped = stopped | torch.any(violate & q, dim=-1)
        count = count + torch.sum(acc.long(), dim=-1)
        if blk.w is not None:
            used = used + torch.sum(torch.where(acc, blk.w, 0.0), dim=-1)
        if blk.gid is not None:
            for grp in range(enc.G):
                counts[:, grp] += torch.sum((acc & (blk.gid == grp)).int(),
                                            dim=-1)
        cm = torch.minimum(cm, torch.amin(
            torch.where(acc.unsqueeze(-1), d2b, inf), dim=1))
        accepts.append(acc)
        gains.append(g)
    load = torch.cat(loads, dim=1) if loads else None
    return torch.cat(accepts, dim=1), cm, torch.cat(gains, dim=1), load


def threshold_select_trace(X: torch.Tensor, E: torch.Tensor,
                           cur_min: torch.Tensor, mask: torch.Tensor, tau,
                           k: int, *, used=None, counts=None, count=None,
                           bn: int = 256, weights=None, budget=None,
                           group_ids=None, caps=None, active=None,
                           enc=None, eval_weights=None, compute_dtype=None,
                           x_scale=None, x_zp=None):
    """:func:`threshold_select` plus what the near-threshold rule of
    :mod:`repro_torch.testing` needs: each row's gain as its block scored
    it, and its knapsack load ``used + cumw`` (``None`` without a
    knapsack).  Returns ``(accept, cur_min, gains, load)``."""
    m = E.shape[0]
    X = dequantize_rows(X, x_scale, x_zp)
    check_compute_dtype(compute_dtype)
    batched, X, mask, cm = _batched(X, mask, cur_min, m)
    M, n, _ = X.shape
    dev = X.device
    enc = encoding(M, n, dev, enc, weights, budget, group_ids, caps)
    tau = torch.as_tensor(tau, dtype=torch.float32, device=dev).reshape(
        -1).expand(M)
    used = (torch.zeros((M,), dtype=torch.float32, device=dev) if used is None
            else torch.as_tensor(used, dtype=torch.float32,
                                 device=dev).reshape(-1).expand(M))
    count = (torch.zeros((M,), dtype=torch.int32, device=dev) if count is None
             else torch.as_tensor(count, device=dev).reshape(-1).expand(M))
    counts = (torch.zeros((M, enc.G), dtype=torch.int32, device=dev)
              if counts is None else torch.as_tensor(
                  counts, dtype=torch.int32, device=dev).reshape(
                      -1, enc.G).expand(M, enc.G))
    active = (torch.ones((M,), dtype=torch.bool, device=dev) if active is None
              else torch.as_tensor(active, device=dev).bool().reshape(M))
    step = max(1, _CHUNK_ELEMS // max(1, n * m))
    parts = []
    for i in range(0, M, step):
        sl = slice(i, i + step)
        parts.append(_threshold_chunk(
            X[sl], E, cm[sl], mask[sl], tau[sl], k, used[sl], counts[sl],
            count[sl], bn, enc.rows(sl), active[sl], eval_weights,
            compute_dtype))
    acc, cm, g = (torch.cat([p[j] for p in parts]) for j in range(3))
    load = (None if parts[0][3] is None
            else torch.cat([p[3] for p in parts]))
    if batched:
        return acc, cm, g, load
    return acc[0], cm[0], g[0], None if load is None else load[0]


def threshold_select(X: torch.Tensor, E: torch.Tensor, cur_min: torch.Tensor,
                     mask: torch.Tensor, tau, k: int, *, used=None,
                     counts=None, count=None, bn: int = 256,
                     compute_dtype=None, weights=None, budget=None,
                     group_ids=None, caps=None, x_scale=None, x_zp=None,
                     eval_weights=None, active=None, enc=None):
    """One τ-level of threshold-batch selection (plain version).

    Returns ``(accept, cur_min_out)``: the rows committed at this level
    and the running minimum after folding them in.  Block-sequential at
    granularity ``bn``, as ``repro.kernels.ref.threshold_select``:

    * a block's gains see the ``cur_min`` every earlier block left;
    * a row qualifies when it is available, its gain is ≥ τ and it is
      singly feasible against the block-entry state;
    * the block accepts the qualifying rows before the first whose
      inclusive cumulative count / weight / group count exceeds ``k`` /
      the budget / its cap; that row stops the launch (later blocks
      accept nothing);
    * accepted rows fold into ``cur_min`` by a masked row-min of the
      contraction-form distances.

    ``tau``, ``used``, ``count`` are per machine (``(M,)`` or scalars),
    ``counts`` ``(M, G)``.  ``active`` ``(M,)`` marks the machines whose
    ladder still runs: the others accept nothing and keep ``cur_min``.
    ``enc`` is the constraint operands as an :class:`Encoding` already
    built; ``eval_weights`` ``(m,)`` weigh the eval columns of the gains.
    Narrow ``X`` (``x_scale``/``x_zp``) is dequantized once up front;
    ``compute_dtype`` applies to the gains and to the fold's contraction.
    """
    acc, cm, _, _ = threshold_select_trace(
        X, E, cur_min, mask, tau, k, used=used, counts=counts, count=count,
        bn=bn, weights=weights, budget=budget, group_ids=group_ids,
        caps=caps, active=active, enc=enc, eval_weights=eval_weights,
        compute_dtype=compute_dtype, x_scale=x_scale, x_zp=x_zp)
    return acc, cm


#: queries per block of the plain attention when ``S`` is a larger multiple
#: of it (``repro.kernels.ref.flash_attention``'s CHUNK)
ATTN_CHUNK = 1024


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, scale: float | None = None,
                    kv_valid_len=None) -> torch.Tensor:
    """Attention with GQA by head groups (plain version of
    ``repro.kernels.ref.flash_attention``).

    ``q`` ``(B, H, S, D)``, ``k``/``v`` ``(B, Hkv, T, D)``; query head ``h``
    reads KV head ``h // (H / Hkv)``, with no repeat of the KV heads.  The
    logits ``(q·k)·scale`` (``scale = 1/√D`` by default), the softmax and
    the products are fp32; a causal mask keeps ``kpos ≤ qpos + (T − S)``
    and ``kv_valid_len`` keeps ``kpos < kv_valid_len``, masked logits set
    to −1e30.  Queries run in blocks of :data:`ATTN_CHUNK` where
    ``S > ATTN_CHUNK`` and ``S % ATTN_CHUNK == 0``, as there.  Returns
    ``(B, H, S, D)`` in ``q.dtype``.
    """
    exact_fp32(q)
    B, H, S, D = q.shape
    Hkv, T = k.shape[1], k.shape[2]
    if scale is None:
        scale = 1.0 / (D ** 0.5)
    G = H // Hkv
    kf, vf = k.float(), v.float()
    kpos = torch.arange(T, device=q.device)[None, :]

    def on_chunk(qc: torch.Tensor, off: int) -> torch.Tensor:
        """qc ``(B, Hkv, G, Sc, D)`` fp32, grouped."""
        Sc = qc.shape[3]
        logits = torch.einsum("bkgsd,bktd->bkgst", qc, kf) * scale
        if causal:
            qpos = (off + (T - S)
                    + torch.arange(Sc, device=q.device)[:, None])
            logits = torch.where(kpos <= qpos, logits, NEG_INF)
        if kv_valid_len is not None:
            logits = torch.where(kpos < kv_valid_len, logits, NEG_INF)
        probs = torch.softmax(logits, dim=-1)
        return torch.einsum("bkgst,bktd->bkgsd", probs, vf)

    qg = q.float().reshape(B, Hkv, G, S, D)
    if S > ATTN_CHUNK and S % ATTN_CHUNK == 0:
        o = torch.cat([on_chunk(qg[:, :, :, s0:s0 + ATTN_CHUNK], s0)
                       for s0 in range(0, S, ATTN_CHUNK)], dim=3)
    else:
        o = on_chunk(qg, 0)
    return o.reshape(B, H, S, D).to(q.dtype)


def flash_attention_backward(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, do: torch.Tensor, *,
                             causal: bool = True, scale: float | None = None
                             ) -> tuple[torch.Tensor, ...]:
    """``(dq, dk, dv)`` of :func:`flash_attention` at ``(q, k, v)`` for the
    output's gradient ``do``, by autograd of the plain version (fp32 inside,
    each gradient in its operand's type): what the card's backward kernel
    is held against.  The model path never calls it."""
    with torch.enable_grad():
        qq, kk, vv = (t.detach().requires_grad_(True) for t in (q, k, v))
        o = flash_attention(qq, kk, vv, causal=causal, scale=scale)
        return torch.autograd.grad(o, (qq, kk, vv), do)


#: lanes of the ``wkv6`` kernel that share one state column (row ``k`` on
#: lane ``k % 8``), and the lanes of the warp that sums the bonus term
WKV_LANES = 8
WKV_WARP = 32


def _slab_sum(x: torch.Tensor, width: int, dim: int) -> torch.Tensor:
    """``x`` zero-padded along ``dim`` to a multiple of ``width``, its
    slabs of ``width`` added in order: lane ``i`` of the result holds
    ``x[i] + x[i + width] + …``, summed as one lane of the kernel sums its
    rows."""
    n = x.shape[dim]
    pad = (-n) % width
    if pad:
        shape = list(x.shape)
        shape[dim] = pad
        x = torch.cat([x, x.new_zeros(shape)], dim=dim)
    out = x.narrow(dim, 0, width)
    for i in range(1, x.shape[dim] // width):
        out = out + x.narrow(dim, i * width, width)
    return out


def _lane_tree(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Sum over ``dim`` (a power of two) by adjacent pairs, level by level:
    the order of a warp's xor-shuffle reduction (lane 0's value)."""
    while x.shape[dim] > 1:
        n = x.shape[dim]
        idx = torch.arange(0, n, 2, device=x.device)
        x = x.index_select(dim, idx) + x.index_select(dim, idx + 1)
    return x.squeeze(dim)


def wkv6(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
         u: torch.Tensor, state: torch.Tensor | None = None, *,
         out_dtype: torch.dtype | None = None
         ) -> tuple[torch.Tensor, torch.Tensor]:
    """RWKV-6 WKV recurrence (plain version of ``repro.kernels.ref.wkv6``):

        y_t = r_t·(S + diag(u)·k_tᵀv_t),   S ← diag(w_t)·S + k_tᵀv_t

    ``r``, ``k``, ``w`` ``(B, H, T, Dk)``, ``v`` ``(B, H, T, Dv)``, ``u``
    ``(H, Dk)``; ``state`` the ``(B, H, Dk, Dv)`` state before step 0
    (zeros when None).  Returns ``y`` ``(B, H, T, Dv)`` in ``out_dtype``
    (``r.dtype`` by default) and the final state, both computed in fp32.

    The arithmetic is the CUDA kernel's, operation for operation, so the
    two agree to the bit: ``y_t = Σ_k r_k·S_kj + v_j·a_t`` with the bonus
    ``a_t = Σ_k (r_k·u_k)·k_k``; the sum over k of ``r_k·S_kj`` runs as
    8 lanes each adding its rows ``k ≡ lane (mod 8)`` in order, then a
    pairwise tree over the lanes, and ``a_t`` as 32 lanes then a tree;
    every product is rounded before its add (no fused multiply-add), and
    ``S ← w·S + k·v`` the same way.  With ``state=None`` this is what
    ``repro.kernels.ref.wkv6`` computes, in another summation order.
    """
    B, H, T, Dk = r.shape
    Dv = v.shape[-1]
    r32, k32, v32, w32 = (x.float() for x in (r, k, v, w))
    ruk = r32 * u.float()[None, :, None, :] * k32
    bonus = _lane_tree(_slab_sum(ruk, WKV_WARP, -1), -1)      # (B, H, T)
    S = (torch.zeros((B, H, Dk, Dv), dtype=torch.float32, device=r.device)
         if state is None else state.float().clone())
    y = torch.empty((B, H, T, Dv), dtype=torch.float32, device=r.device)
    for t in range(T):
        rs = r32[:, :, t, :, None] * S                          # (B, H, Dk, Dv)
        part = _lane_tree(_slab_sum(rs, WKV_LANES, -2), -2)     # (B, H, Dv)
        vt = v32[:, :, t]
        y[:, :, t] = part + vt * bonus[:, :, t, None]
        S = w32[:, :, t, :, None] * S + k32[:, :, t, :, None] * vt[:, :, None]
    return y.to(out_dtype or r.dtype), S


def wkv6_bwd_tile(Dk: int, Dv: int) -> tuple[int, int, int]:
    """``(DKP, CPT, TC)`` of the ``wkv6`` backward kernel's instantiation
    (``csrc/wkv6_bwd.cu``) for a ``(Dk, Dv)`` state: rows padded to DKP
    (16 or 64) and columns to DVP = CPT·TC (16, 64 or 128); TC lanes share
    a row, CPT columns each, so a warp holds 32 / TC rows.  The wrapper
    passes it to the kernel, and :func:`wkv6_backward` sums in its order.
    A state past Dk = 64 or Dv = 128 raises ``ValueError``."""
    if not (0 < Dk <= 64 and 0 < Dv <= 128):
        raise ValueError(f"wkv6 backward: Dk={Dk}, Dv={Dv}: it takes "
                         "Dk <= 64 and Dv <= 128")
    cpt, tc = (4, 4) if Dv <= 16 else (16, 4) if Dv <= 64 else (16, 8)
    return (16 if Dk <= 16 else 64), cpt, tc


def wkv6_backward(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  w: torch.Tensor, u: torch.Tensor,
                  state: torch.Tensor | None, dy: torch.Tensor,
                  d_state_out: torch.Tensor | None = None, *,
                  chunk: int = 64) -> tuple[torch.Tensor, ...]:
    """The gradients ``(dr, dk, dv, dw, du, d_state)`` of :func:`wkv6` at
    ``(r, k, v, w, u, state)`` for ``dy`` ``(B, H, T, Dv)``, the output's
    gradient, and ``d_state_out``, the final state's (zeros when None).

    A reverse scan from t = T − 1 down to 0 carrying G = ∂L/∂S_t (fp32;
    ``d_state_out`` at the start), with ``c_t = v_t·dy_t`` and the forward's
    bonus ``a_t = r_t·(u ⊙ k_t)``::

        dr_t = S_{t−1}·dy_t + c_t (u ⊙ k_t)      dk_t = G v_t + c_t (u ⊙ r_t)
        dv_t = Gᵀ k_t + a_t dy_t                  dw_t = Σ_j G[:, j] S_{t−1}[:, j]
        du  += c_t (r_t ⊙ k_t)                    G ← diag(w_t) G + r_tᵀ dy_t

    and after step 0, ``d_state = G``.  ``S_{t−1}`` is recomputed forward
    from a state kept every ``chunk`` steps (the bits do not depend on
    ``chunk``).  Returns dr, dk, dv in r's type, dw in w's, du in u's and
    d_state fp32 (float64 inputs compute in float64 throughout: the
    error model of ``testing.WKV_GRAD_TOL``).

    The arithmetic is the CUDA kernel's, operation for operation, so the
    two agree to the bit: the state padded to DKP × DVP
    (:func:`wkv6_bwd_tile`); a sum over columns as TC lanes each adding its
    CPT columns in order, then a pairwise tree over the lanes; a sum over
    rows (Gᵀ k) as a tree over the 32 / TC rows of a warp, then the warps
    in order; ``a_t`` and ``c_t`` as 32 lanes then a tree; du over t from
    T − 1 down, then over b in order; every product rounded before its add
    (no fused multiply-add).  The model path never calls it: on the card
    ``ops.wkv6``'s backward launches the kernel."""
    B, H, T, Dk = r.shape
    Dv = v.shape[-1]
    DKP, CPT, TC = wkv6_bwd_tile(Dk, Dv)
    DVP, RPW = CPT * TC, WKV_WARP // TC
    NW = DKP // RPW
    acc = torch.float64 if r.dtype == torch.float64 else torch.float32
    dev = r.device

    def pad(x, n):
        x = x.to(acc)
        return torch.cat([x, x.new_zeros(x.shape[:-1] + (n - x.shape[-1],))],
                         dim=-1)

    def square(s):
        out = torch.zeros((B, H, DKP, DVP), dtype=acc, device=dev)
        if s is not None:
            out[:, :, :Dk, :Dv] = s.to(acc)
        return out

    def rows(x):
        """(..., DKP, DVP) summed over the columns in the kernel's order."""
        x = x.reshape(x.shape[:-1] + (TC, CPT))
        s = x[..., 0]
        for c in range(1, CPT):
            s = s + x[..., c]
        return _lane_tree(s, -1)

    def cols(x):
        """(..., DKP, DVP) summed over the rows in the kernel's order."""
        x = _lane_tree(x.reshape(x.shape[:-2] + (NW, RPW, DVP)), -2)
        s = x[..., 0, :]
        for i in range(1, NW):
            s = s + x[..., i, :]
        return s

    r32, k32, w32 = pad(r, DKP), pad(k, DKP), pad(w, DKP)
    v32, dy32 = pad(v, DVP), pad(dy, DVP)
    u32 = pad(u, DKP)[None, :, None, :]                     # (1, H, 1, DKP)
    a = _lane_tree(_slab_sum(r32 * u32 * k32, WKV_WARP, -1), -1)  # (B, H, T)
    c = _lane_tree(_slab_sum(v32 * dy32, WKV_WARP, -1), -1)

    def step(S, t):
        return (w32[:, :, t, :, None] * S
                + k32[:, :, t, :, None] * v32[:, :, t, None, :])

    S = square(state)
    kept = []
    for t in range(T):
        if t % chunk == 0:
            kept.append(S)
        S = step(S, t)
    G = square(d_state_out)
    dr, dk, dw = (torch.empty((B, H, T, DKP), dtype=acc, device=dev)
                  for _ in range(3))
    dv = torch.empty((B, H, T, DVP), dtype=acc, device=dev)
    for i in reversed(range(len(kept))):
        t0, t1 = i * chunk, min(T, (i + 1) * chunk)
        S, prev = kept[i], []
        for t in range(t0, t1):
            prev.append(S)
            S = step(S, t)
        Gs = [None] * (t1 - t0)
        for t in reversed(range(t0, t1)):
            Gs[t - t0] = G
            G = (w32[:, :, t, :, None] * G
                 + r32[:, :, t, :, None] * dy32[:, :, t, None, :])
        Sp, Gt = torch.stack(prev, 2), torch.stack(Gs, 2)  # (B, H, L, ...)
        sl = slice(t0, t1)
        ct = c[:, :, sl, None]
        dr[:, :, sl] = (rows(Sp * dy32[:, :, sl, None, :])
                        + ct * (u32 * k32[:, :, sl]))
        dk[:, :, sl] = (rows(Gt * v32[:, :, sl, None, :])
                        + ct * (u32 * r32[:, :, sl]))
        dw[:, :, sl] = rows(Gt * Sp)
        dv[:, :, sl] = (cols(Gt * k32[:, :, sl, :, None])
                        + a[:, :, sl, None] * dy32[:, :, sl])
        del prev, Gs, Sp, Gt
    p = c[..., None] * (r32 * k32)                          # (B, H, T, DKP)
    du_b = torch.zeros((B, H, DKP), dtype=acc, device=dev)
    for t in reversed(range(T)):
        du_b = du_b + p[:, :, t]
    du = du_b[0]
    for b in range(1, B):
        du = du + du_b[b]
    return (dr[..., :Dk].to(r.dtype), dk[..., :Dk].to(r.dtype),
            dv[..., :Dv].to(r.dtype), dw[..., :Dk].to(w.dtype),
            du[:, :Dk].to(u.dtype), G[:, :, :Dk, :Dv].contiguous())


def _bf16_pieces(x: torch.Tensor) -> list[torch.Tensor]:
    """fp32 ``x`` as three bf16 pieces h = bf16(x), m = bf16(x − h), l =
    bf16(x − h − m) (held as fp32 values), which hold its 24 bits."""
    out = []
    for _ in range(3):
        p = x.to(torch.bfloat16).float()
        out.append(p)
        x = x - p
    return out


def _mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` as the chunked backward kernel's tensor-core products run
    it: in fp32, each operand split in three bf16 pieces and the products
    of the piece pairs whose orders sum to at most 2 added, smallest first
    (a bf16 operand's lower pieces are zero); float64 operands plainly."""
    if a.dtype == torch.float64:
        return a @ b
    pa, pb = _bf16_pieces(a), _bf16_pieces(b)
    out = None
    for s in (2, 1, 0):
        for i in range(s + 1):
            t = pa[i] @ pb[s - i]
            out = t if out is None else out + t
    return out


#: steps a chunk and a sub-chunk of the chunked ``wkv6`` backward
#: (``csrc/wkv6_bwd_chunked.cu``)
WKV_BWD_CHUNK = 64
WKV_BWD_SUB = 16


def wkv6_backward_chunked(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          w: torch.Tensor, u: torch.Tensor,
                          state: torch.Tensor | None, dy: torch.Tensor,
                          d_state_out: torch.Tensor | None = None, *,
                          chunk: int = WKV_BWD_CHUNK,
                          sub: int = WKV_BWD_SUB
                          ) -> tuple[torch.Tensor, ...]:
    """:func:`wkv6_backward`'s function by the chunked kernel's formulas
    (``csrc/wkv6_bwd_chunked.cu``), written out in PyTorch: what the tests
    hold against autograd, the recurrent backward and ``jax.grad`` (float64
    inputs compute in float64, with plain products; fp32 and bf16 inputs in
    fp32, each product as the kernel's tensor cores run it, :func:`_mm`).
    The model path never calls it.

    Steps run in chunks of ``chunk`` (steps past T: w = 1, the rest zero),
    each cut in sub-chunks of ``sub``.  Every decay factor is a product of
    w's taken outward from one step, so it is ≤ 1, with no division and no
    clip.  Per sub-chunk, with ``A_s = Π_{p<s} w_p`` (from its start), ``B_s
    = Π_{s<p} w_p`` (to its end) and ``g`` the whole product:

    1. per chunk, its own state ``U = Σ_n`` (sub-chunks in order, ``U ←
       diag(g) U + (k∘B)ᵀ V``), its own gradient-state ``Y = (r∘P)ᵀ dY``
       (P the prefix product over the chunk) and its decay;
    2. the scans: each chunk's entry state ``E_c`` from S_0 (``E ← diag(g)
       E + U``), each chunk's exit gradient-state ``X_c`` from dS_T in
       reverse (``X ← diag(g) X + Y``), d_state the last;
    3. per chunk, the sub-chunks' entry states forward from ``E_c`` and
       their exit gradient-states in reverse from ``X_c``; in a sub-chunk
       with entry E and exit X, ``F_m = S_{s−1}·dy_m`` walked from ``E
       dyᵀ`` (``F ← w_s F + k_s (v_s·dy_m)``) and ``F_X = S_{s−1}·X`` from
       ``E∘X`` summed over the columns, ``rd_m = r_m Π_{s<p<m} w_p``::

           dr_s = F_s + c_s (u∘k_s)
           dk_s = B_s (X v_s) + Σ_{m>s} (v_s·dy_m) rd_m + c_s (u∘r_s)
           dw_s = B_s F_X + Σ_{m>s} rd_m F_m          (Σ_j G_s[:, j] S_{s−1}[:, j])
           dv   = (k∘B) X + Pᵀ dY,  P_ms = Σ_i k_s rd_m (m > s), P_ss = a_s

       with ``c_s = v_s·dy_s`` and ``a_s = r_s·(u∘k_s)``; then ``X ←
       diag(g) X + (r∘A)ᵀ dY``;
    4. du: each chunk's ``Σ_s c_s (r_s∘k_s)``, summed over the chunks, then
       over b, in order."""
    B, H, T, Dk = r.shape
    Dv = v.shape[-1]
    acc = torch.float64 if r.dtype == torch.float64 else torch.float32
    dev = r.device
    nc = -(-T // chunk)
    ns = chunk // sub
    pad = nc * chunk - T

    def steps(x, fill=0.0):
        x = x.to(acc)
        if pad:
            x = torch.cat([x, x.new_full(x.shape[:2] + (pad, x.shape[-1]),
                                         fill)], dim=2)
        return x.reshape(B, H, nc, ns, sub, x.shape[-1])

    r6, k6, v6, dy6 = steps(r), steps(k), steps(v), steps(dy)
    w6 = steps(w, 1.0)
    uu = u.to(acc)[None, :, None, None, :]            # (1, H, 1, 1, Dk)
    u4 = uu[:, :, :, 0]                               # (1, H, 1, Dk)

    def prefix(x):
        """Π_{p<s} x_p along the steps (dim −2), from 1."""
        out = [torch.ones_like(x[..., 0, :])]
        for s in range(x.shape[-2] - 1):
            out.append(out[-1] * x[..., s, :])
        return torch.stack(out, -2)

    def suffix(x):
        """Π_{s<p} x_p along the steps (dim −2), to 1."""
        n = x.shape[-2]
        out = [torch.ones_like(x[..., 0, :])]
        for s in range(n - 1, 0, -1):
            out.append(out[-1] * x[..., s, :])
        return torch.stack(out[::-1], -2)

    def T_(x):
        return x.transpose(-1, -2)

    # 1. each chunk's own state, gradient-state and decay
    U = torch.zeros((B, H, nc, Dk, Dv), dtype=acc, device=dev)
    Y = torch.zeros_like(U)
    pc = torch.ones((B, H, nc, Dk), dtype=acc, device=dev)
    for n in range(ns):
        wn = w6[:, :, :, n]
        A, Bs = prefix(wn), suffix(wn)
        g = A[..., -1, :] * wn[..., -1, :]
        U = g[..., None] * U + _mm(T_(k6[:, :, :, n] * Bs), v6[:, :, :, n])
        Y = Y + _mm(T_(r6[:, :, :, n] * (pc[..., None, :] * A)),
                    dy6[:, :, :, n])
        pc = pc * g
    gc = pc
    # 2. the scans over the chunks
    E = torch.zeros((B, H, Dk, Dv), dtype=acc, device=dev)
    if state is not None:
        E = state.to(acc).clone()
    Es = []
    for c in range(nc):
        Es.append(E)
        E = gc[:, :, c, :, None] * E + U[:, :, c]
    X = torch.zeros((B, H, Dk, Dv), dtype=acc, device=dev)
    if d_state_out is not None:
        X = d_state_out.to(acc).clone()
    Xs = [None] * nc
    for c in reversed(range(nc)):
        Xs[c] = X
        X = gc[:, :, c, :, None] * X + Y[:, :, c]
    d_state = X
    E, X = torch.stack(Es, 2), torch.stack(Xs, 2)       # (B, H, nc, Dk, Dv)
    # 3. the chunks' gradients
    En = [E]
    for n in range(ns - 1):
        wn = w6[:, :, :, n]
        g = prefix(wn)[..., -1, :] * wn[..., -1, :]
        En.append(g[..., None] * En[-1]
                  + _mm(T_(k6[:, :, :, n] * suffix(wn)), v6[:, :, :, n]))
    shape = (B, H, nc, ns, sub)
    dr, dk, dw = (torch.empty(shape + (Dk,), dtype=acc, device=dev)
                  for _ in range(3))
    dv = torch.empty(shape + (Dv,), dtype=acc, device=dev)
    du_c = torch.zeros((B, H, nc, Dk), dtype=acc, device=dev)
    upper = torch.ones((sub, sub), dtype=torch.bool, device=dev).triu(1)
    for n in reversed(range(ns)):
        rn, kn, wn = r6[:, :, :, n], k6[:, :, :, n], w6[:, :, :, n]
        vn, dyn = v6[:, :, :, n], dy6[:, :, :, n]
        A, Bs = prefix(wn), suffix(wn)
        g = A[..., -1, :] * wn[..., -1, :]
        ED = _mm(En[n], T_(dyn))                      # (.., Dk, sub): E dy_m
        XV = _mm(X, T_(vn))                           # (.., Dk, sub): X v_s
        EX = (En[n] * X).sum(-1)                      # (.., Dk)
        Q = _mm(dyn, T_(vn))                          # Q[m, j] = v_j·dy_m
        c = torch.diagonal(Q, dim1=-2, dim2=-1)       # (.., sub)
        a = (rn * uu * kn).sum(-1)
        # Dm[s, m] = Π_{s<p<m} w_p (m > s), built outward from s
        Dm = torch.zeros(shape[:3] + (sub, sub, Dk), dtype=acc, device=dev)
        for s in range(sub - 1):
            x = torch.ones_like(wn[..., 0, :])
            for m in range(s + 1, sub):
                Dm[..., s, m, :] = x
                x = x * wn[..., m, :]
        rd = rn[..., None, :, :] * Dm                 # rd[s, m] = r_m D_sm
        F, FX = T_(ED), EX                            # F[.., m, i] at s = 0
        for s in range(sub):
            cs = c[..., s, None]
            q = Q[..., :, s, None]                    # (v_s·dy_m) by m
            dr[:, :, :, n, s] = F[..., s, :] + cs * u4 * kn[..., s, :]
            dk[:, :, :, n, s] = (Bs[..., s, :] * XV[..., s]
                                 + (q * rd[..., s, :, :]).sum(-2)
                                 + cs * u4 * rn[..., s, :])
            dw[:, :, :, n, s] = (Bs[..., s, :] * FX
                                 + (rd[..., s, :, :] * F).sum(-2))
            du_c = du_c + cs * rn[..., s, :] * kn[..., s, :]
            F = wn[..., s, None, :] * F + kn[..., s, None, :] * q
            FX = wn[..., s, :] * FX + kn[..., s, :] * XV[..., s]
        P = torch.einsum("...si,...smi->...ms", kn, rd)
        P = P * upper.T.to(acc) + torch.diag_embed(a)
        dv[:, :, :, n] = _mm(kn * Bs, X) + _mm(T_(P), dyn)
        X = g[..., None] * X + _mm(T_(rn * A), dyn)

    def out(x):
        return x.reshape(B, H, nc * chunk, x.shape[-1])[:, :, :T]

    du = du_c[0, :, 0]
    for b in range(B):
        for c in range(int(b == 0), nc):
            du = du + du_c[b, :, c]
    return (out(dr).to(r.dtype), out(dk).to(r.dtype), out(dv).to(r.dtype),
            out(dw).to(w.dtype), du.to(u.dtype), d_state)
