"""The port's tolerances (one for fp32 values, one more bf16 ulp for
attention outputs in bf16, and those of LM logits and caches), the
near-tie rule for selections and for greedy tokens, the exact-tie rule for
objectives whose gains tie exactly (and its trace of a stochastic greedy's
samples), the near-threshold rules for threshold-batch accept sets and
threshold-greedy sweeps, and the error model of the chunked ``wkv6``
against the recurrence.

Used by the tests (plain versions against the JAX package on the CPU) and
by ``chip_smoke.py`` (kernels against their plain versions on the card).
Never loosen them to make a comparison pass.
"""
from __future__ import annotations

import math

import numpy as np
import torch

#: float outputs (gains, cur_min, values) agree within |a − b| ≤ ATOL + RTOL·|b|
RTOL = 1e-5
ATOL = 1e-5


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    x = np.asarray(x)
    return x.astype(np.float32) if x.dtype.name == "bfloat16" else x


def max_abs_err(a, b) -> float:
    a, b = _np(a).astype(np.float64), _np(b).astype(np.float64)
    return float(np.max(np.abs(a - b))) if a.size else 0.0


def assert_close(actual, expected, what: str = "value") -> None:
    np.testing.assert_allclose(_np(actual), _np(expected), rtol=RTOL,
                               atol=ATOL, err_msg=what)


#: attention outputs in bf16 (the model's type): the fp32 results agree
#: within RTOL/ATOL, and rounding them to bf16 can then part them by one
#: bf16 ulp, at most 2⁻⁷·|value|
BF16_RTOL = 2.0 ** -7 + RTOL

#: LM logits and KV caches of the port against the JAX package on the CPU
#: (four layers at ``reduced()`` size).  In bf16 the two frameworks' matmuls
#: round at different places: measured ≤ 0.0625 on the four dense
#: configurations (two bf16 ulps of a logit in [4, 8)); the bound is four
#: such ulps.  In fp32 (``COMPUTE_DTYPE`` fp32 in both packages, fp32
#: caches) only the order of the sums differs: measured ≤ 4.2e-6.
LM_ATOL = {torch.bfloat16: 0.125, torch.float32: 1e-4}

#: RWKV-6 (``reduced()``, four layers) against the JAX package on the CPU:
#: (logit bound, WKV-state bound as a share of the state's largest value).
#: In bf16 this model amplifies the frameworks' different matmul rounding
#: more than the dense family: measured ≤ 0.2421875 on logits in [4, 8)
#: (the JAX package's own bf16 logits against fp32 compute on the same
#: weights differ by 0.2208) and ≤ 1.63% on the fp32 state (its inputs
#: k, v are bf16 projections); the bounds are about twice and three times
#: that.  In fp32 (``COMPUTE_DTYPE`` fp32 in both packages) only the order
#: of the sums differs, the port's recurrence against the JAX package's
#: chunked form included: measured ≤ 9.9e-6 and ≤ 8.2e-7.
RWKV_ATOL = {torch.bfloat16: (0.5, 0.05), torch.float32: (1e-4, 1e-5)}


#: The chunked ``wkv6`` (``kernels/csrc/wkv6_chunked.cu``) against the
#: recurrence (``kernels/ref.py::wkv6``).  Both sum the same terms, in
#: another order: the chunked form decays each term by products of up to 64
#: w's (one fp32 rounding a factor), takes its products on the tensor cores
#: with every fp32 operand split in three bf16 pieces (the dropped pieces ≤
#: 3·2⁻²⁴ of a term) and sums in the tensor cores' order; the recurrence
#: rounds each state update once a step.  So their difference is bounded
#: by the magnitude of the terms summed along the path, not by |y| or |S|:
#: where the terms nearly cancel (y or a state entry near 0 after a long,
#: slow decay) any two summation orders part by more than RTOL/ATOL, the
#: exact sum included (``tests/test_torch_wkv6_chunked.py``).  Error model,
#: elementwise: ``|Δ| ≤ WKV_TERMS_RTOL·m`` (plus one ulp of a bf16 output),
#: ``m`` from :func:`wkv6_terms`.  2⁻¹⁹ is 32 units of 2⁻²⁴: room for the
#: recurrence's own rounding (a few units of m: each term passes ~L
#: roundings of relative size 2⁻²⁴ with random signs, and m grows like L
#: where the sum grows like √L) and the chunked form's.
WKV_TERMS_RTOL = 2.0 ** -19


def wkv6_terms(r, k, v, w, u, state=None):
    """(m_y, m_S): the magnitude of the terms each output of ``wkv6`` sums
    — the recurrence run on |r|, |k|, |v|, w, |u| and |S₀|, so ``m_y`` is
    Σ_k |r_k|·m_S,kj + |r·u·k|·|v_j| and ``m_S`` the decayed Σ|k·v| plus
    the decayed |S₀|, both in fp32."""
    from repro_torch.kernels import ref
    return ref.wkv6(r.abs(), k.abs(), v.abs(), w, u.abs(),
                    None if state is None else state.abs(),
                    out_dtype=torch.float32)


def terms_ratio(actual, expected, terms, bf16: bool = False) -> float:
    """The largest ``(|Δ| − one bf16 ulp of expected, if bf16) / m`` over
    the elements: the error model holds where it is ≤ WKV_TERMS_RTOL (an
    element with m = 0 must agree exactly)."""
    dev = actual.device if isinstance(actual, torch.Tensor) else "cpu"
    a, b, m = (x.detach().to(dev, torch.float64)
               if isinstance(x, torch.Tensor)
               else torch.from_numpy(np.array(_np(x), np.float64)).to(dev)
               for x in (actual, expected, terms))
    over = (a - b).abs()
    if bf16:
        over = (over - 2.0 ** -7 * b.abs()).clamp_min(0.0)
    if not over.numel():
        return 0.0
    if bool(torch.any((m == 0) & (over > 0))):
        return math.inf
    return float(torch.where(m > 0, over / m.clamp_min(1e-300),
                             torch.zeros_like(m)).max())


def assert_within_terms(actual, expected, terms, bf16: bool = False,
                        what: str = "wkv6") -> float:
    """The error model (``WKV_TERMS_RTOL``); returns the ratio read."""
    ratio = terms_ratio(actual, expected, terms, bf16)
    if not ratio <= WKV_TERMS_RTOL:
        raise AssertionError(
            f"{what}: max |Δ|/m = {ratio!r} > WKV_TERMS_RTOL = "
            f"{WKV_TERMS_RTOL!r}")
    return ratio


def assert_attention_close(actual, expected, bf16: bool,
                           what: str = "attention") -> None:
    """fp32 outputs within RTOL/ATOL; bf16 outputs within BF16_RTOL/ATOL."""
    np.testing.assert_allclose(_np(actual), _np(expected),
                               rtol=BF16_RTOL if bf16 else RTOL, atol=ATOL,
                               err_msg=what)


def tokens_agree(tok, tok_ref, logits_ref, tol: float) -> tuple[bool, int]:
    """Greedy tokens ``(B, n)`` against the reference's under the near-tie
    rule.  ``logits_ref`` ``(B, n, V)`` are the reference's logits at each
    of its steps.  Each row must match up to its first divergence; a
    divergence at step t is excused only where the reference's own logit
    for the token picked is within ``tol`` of its best logit there (so the
    reference's top-2 gap is within ``tol``), and the row is not compared
    after it.  Returns (they agree, rows excused)."""
    tok, tok_ref = _np(tok), _np(tok_ref)
    lg = _np(logits_ref).astype(np.float64)
    agree, excused = True, 0
    for b in range(tok.shape[0]):
        part = np.flatnonzero(tok[b] != tok_ref[b])
        if not part.size:
            continue
        t = part[0]
        if lg[b, t].max() - lg[b, t, tok[b, t]] <= tol:
            excused += 1
        else:
            agree = False
    return agree, excused


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


NEG_INF = -1e30


def gain_trace(obj, T: torch.Tensor, mask: torch.Tensor,
               sel: torch.Tensor) -> torch.Tensor:
    """The gains ``obj`` gives at each step of the selections ``sel``
    ``(…, k)`` (block positions, −1 for none), replayed through its own
    oracle from ``init_state``: ``(…, k, cap)``, ``NEG_INF`` where a row is
    no longer a candidate.  Unconstrained; what :func:`picks_agree` needs
    of the reference."""
    from repro_torch.core.algorithms import _where_state
    state = obj.init_state(T, mask)
    avail = mask.bool().clone()
    out = []
    for t in range(sel.shape[-1]):
        out.append(obj.gains(state, T, avail))
        ok = sel[..., t] >= 0
        safe = torch.clamp_min(sel[..., t], 0)
        state = _where_state(ok, obj.update(state, T, safe), state)
        hit = torch.nn.functional.one_hot(safe, T.shape[-2]).bool()
        avail = avail & ~(ok[..., None] & hit)
    return torch.stack(out, dim=-2)


def picks_agree(sel, sel_ref, gains_ref) -> tuple[bool, int, int]:
    """Compare two ``(…, k)`` selections under the exact-tie rule.

    For objectives whose gains tie exactly (``ActiveSetSelection``: every
    gain is ½·log 2 at step 0, and a row far from every pick keeps r = 2.0
    exactly), where :func:`selections_agree` would excuse every step.
    ``gains_ref`` ``(…, k, cap)`` are the reference's gains at each of its
    steps (:func:`gain_trace`).  Each machine's picks must agree step by
    step, ties to the lowest index included.  The first step where they
    part is excused only if the reference's own gain for the row ``sel``
    picked is within ``ATOL + RTOL·|best|`` of the reference's best gain
    there; from then on that machine's picks are not compared (only values
    are).  Returns (they agree, exact-tie steps among the compared ones,
    excused steps).
    """
    k = _np(sel).shape[-1]
    sel, sel_ref = _np(sel).reshape(-1, k), _np(sel_ref).reshape(-1, k)
    g = _np(gains_ref)
    g = g.reshape(sel.shape[0], k, g.shape[-1])
    agree, ties, excused = True, 0, 0
    for i in range(sel.shape[0]):
        part = np.flatnonzero(sel[i] != sel_ref[i])
        upto = part[0] if part.size else k - 1
        for t in range(upto + 1):
            if g.shape[-1] >= 2:
                top = np.partition(g[i, t], -2)[-2:]
                ties += int(top[0] == top[1] and top[0] > NEG_INF / 2)
        if not part.size:
            continue
        t, p, b = part[0], sel[i, part[0]], sel_ref[i, part[0]]
        if p < 0 or b < 0:
            agree = False
            continue
        best = float(g[i, t, b])
        if abs(float(g[i, t, p]) - best) <= ATOL + RTOL * abs(best):
            excused += 1
        else:
            agree = False
    return agree, ties, excused


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


def sample_gain_trace(obj, T: torch.Tensor, mask: torch.Tensor,
                      sel: torch.Tensor, key, eps: float) -> torch.Tensor:
    """:func:`gain_trace` of ``stochastic_greedy``: at each step of the
    selections ``sel`` ``(…, k)``, ``obj``'s gains of the step's sample
    drawn from ``key`` (the same draws), ``NEG_INF`` off the sample.  What
    :func:`picks_agree` holds a stochastic run's picks against.
    Unconstrained."""
    from repro_torch.core.algorithms import (sample_size, stochastic_sample,
                                             _where_state)
    sel = torch.as_tensor(_np(sel).astype(np.int64), device=T.device)
    k, cap = sel.shape[-1], T.shape[-2]
    s = sample_size(cap, k, eps)
    state = obj.init_state(T, mask)
    avail = mask.bool().clone()
    out = []
    for t in range(k):
        scores = key(t).to(device=T.device, dtype=torch.float32).reshape(
            avail.shape)
        sub = stochastic_sample(scores, avail, s)
        in_sample = torch.zeros_like(avail).scatter_(-1, sub, True)
        out.append(obj.gains(state, T, avail & in_sample))
        ok = sel[..., t] >= 0
        safe = torch.clamp_min(sel[..., t], 0)
        state = _where_state(ok, obj.update(state, T, safe), state)
        hit = torch.nn.functional.one_hot(safe, cap).bool()
        avail = avail & ~(ok[..., None] & hit)
    return torch.stack(out, dim=-2)


def sweep_agree(sel, sel_ref, gains_ref, taus) -> tuple[bool, int]:
    """Compare two ``(…, k)`` threshold-sweep selections under the
    near-threshold rule.

    ``gains_ref`` ``(…, k, cap)`` are the reference's gains at each of its
    takes (:func:`gain_trace`) and ``taus`` ``(…, n_levels)`` its levels.
    A sweep takes a row where its gain meets τ, so two sweeps part only
    where a gain differs by rounding across a level: each machine's picks
    must agree up to their first parting, which is excused only if the
    reference's gain of either row there is within ``ATOL + RTOL·|τ|`` of
    one of the levels (the top level is the best gain itself).  Returns
    (they agree, excused machines).
    """
    k = _np(sel).shape[-1]
    sel, sel_ref = _np(sel).reshape(-1, k), _np(sel_ref).reshape(-1, k)
    g = _np(gains_ref).astype(np.float64)
    g = g.reshape(sel.shape[0], k, g.shape[-1])
    t = _np(taus).astype(np.float64).reshape(sel.shape[0], -1)
    agree, excused = True, 0
    for i in range(sel.shape[0]):
        part = np.flatnonzero(sel[i] != sel_ref[i])
        if not part.size:
            continue
        step = part[0]
        rows = [r for r in (sel[i, step], sel_ref[i, step]) if r >= 0]
        near = any(np.any(np.abs(g[i, step, r] - t[i])
                          <= ATOL + RTOL * np.abs(t[i])) for r in rows)
        if near:
            excused += 1
        else:
            agree = False
    return agree, excused
