"""The port's tolerances (one for fp32 values, one more bf16 ulp for
attention outputs in bf16, and those of LM logits and caches), the
near-tie rule for selections and for greedy tokens, the exact-tie rule for
objectives whose gains tie exactly (and its trace of a stochastic greedy's
samples), the near-threshold rules for threshold-batch accept sets and
threshold-greedy sweeps, the error model of the chunked ``wkv6``
against the recurrence, and the near-tie rule of MoE routes.

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
    """max |a − b| in float64 (on the card for two CUDA tensors of one
    shape, in slices)."""
    if (isinstance(a, torch.Tensor) and isinstance(b, torch.Tensor)
            and a.is_cuda and b.is_cuda and a.shape == b.shape):
        x, y = a.detach().reshape(-1), b.detach().reshape(-1)
        step = 1 << 27
        return max((float(torch.max(torch.abs(x[i:i + step].double()
                                              - y[i:i + step].double())))
                    for i in range(0, x.numel(), step)), default=0.0)
    a, b = _np(a).astype(np.float64), _np(b).astype(np.float64)
    return float(np.max(np.abs(a - b))) if a.size else 0.0


def assert_close(actual, expected, what: str = "value") -> None:
    """``|actual − expected| ≤ ATOL + RTOL·|expected|`` elementwise (NaN
    and equal infinities agreeing), as ``np.testing.assert_allclose``.
    Two CUDA tensors of one shape are compared on the card, in slices of
    2²⁷ elements (a 4 GB output took a minute through the host); NumPy
    reports any failure, and compares every other pair."""
    if (isinstance(actual, torch.Tensor) and isinstance(expected, torch.Tensor)
            and actual.is_cuda and expected.is_cuda
            and actual.shape == expected.shape
            and _close_on_card(actual, expected, RTOL, ATOL)):
        return
    np.testing.assert_allclose(_np(actual), _np(expected), rtol=RTOL,
                               atol=ATOL, err_msg=what)


def _close_on_card(actual: torch.Tensor, expected: torch.Tensor,
                   rtol: float, atol: float) -> bool:
    a = actual.detach().reshape(-1)
    b = expected.detach().reshape(-1)
    step = 1 << 27
    for i in range(0, a.numel(), step):
        x, y = a[i:i + step].float(), b[i:i + step].float()
        ok = ((x - y).abs() <= atol + rtol * y.abs()) | (x == y) \
            | (x.isnan() & y.isnan())
        if not bool(torch.all(ok)):
            return False
    return True


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


#: attention gradients (dq, dk, dv) of the card's backward
#: (``csrc/flash_attention_bwd.cu``) against autograd of the plain version,
#: as a share of the tensor's largest |value|.  fp32: both sum the same
#: terms in other orders (a float64 model of the kernel's formulas sits
#: within 5.3e-8 of the exact gradients at S, T ≤ 512); bf16: each side
#: rounds its outputs to bf16 (half an ulp, up to 2⁻⁹ of the largest value
#: each) and the kernel's Δ = rowsum(dO ∘ O) reads the forward's bf16 O (the
#: float64 model: ≤ 3.5e-3 of the largest value from the exact gradients,
#: D ∈ {16, 64, 128}, causal and not, groups 1 to 4); the bound is 2⁻⁶,
#: two bf16 ulps of the largest value.
ATTN_GRAD_TOL = {torch.float32: 2e-5, torch.bfloat16: 2.0 ** -6}


#: ``wkv6`` gradients (dr, dk, dv, dw, du, d_state) whose sums run in
#: another order than the other side's (the card's backward
#: ``csrc/wkv6_bwd.cu`` or ``ref.wkv6_backward`` against autograd of
#: ``ref.wkv6``, or against ``jax.grad`` of the JAX ``ref.wkv6``), as a
#: share of the tensor's largest |value|, by the gradient's type.  fp32:
#: the same terms in other orders; a float64 model of the backward's
#: formulas (``ref.wkv6_backward`` on float64 inputs) puts both fp32 sides
#: within 9.54e-7 of the exact gradients
#: (``tests/test_torch_wkv6_bwd.py::test_float64_model_sets_the_bound``,
#: which prints each reading: T ≤ 1,000, decays "model", "fast", 0.5,
#: 0.05 and 1e-6, (Dk, Dv) ∈ {(16, 16), (64, 64), (16, 128)}, from zeros
#: and from a state with dS_T); bf16: each side rounds dr, dk, dv and du
#: to bf16 (half an ulp, up to 2⁻⁸ of the largest value), the model
#: reading ≤ 3.70e-3; the bounds are ``ATTN_GRAD_TOL``'s, 2e-5 and 2⁻⁶
#: (two bf16 ulps of the largest value), each more than twice the
#: reading.  dw and d_state are fp32 whatever the operands' type.
WKV_GRAD_TOL = {torch.float32: 2e-5, torch.bfloat16: 2.0 ** -6}


#: a train step of the port against the JAX package's on the same state
#: and batch, at ``reduced()`` size (and on the card against the CPU's plain
#: path): the relative |Δ| of the loss, grad_norm and lr, and ‖Δ‖ /
#: ‖reference‖ over all leaves of the gradients (``grads``; ``grad_leaf``
#: the worst single leaf), of the step's parameter update and of the new
#: moments mu and nu.  fp32 (COMPUTE_DTYPE
#: fp32 in both packages): only the order of sums differs, and a moment
#: whose fp32 value differs in its last bits may round to the neighbouring
#: bf16 value (2⁻⁸ of it); measured over the six families, one and two
#: microbatches, two steps: loss ≤ 1.5e-7, grad_norm ≤ 5.6e-6, update ≤
#: 1.3e-4, mu ≤ 1.8e-4, nu ≤ 1.2e-4; the gradients of the dense, MoE,
#: VLM and encoder-decoder families ≤ 1.4e-6, a leaf ≤ 1.6e-6.  bf16 (the model's compute dtype;
#: the dense family, where no router's bf16 near-ties send a token to other
#: experts in the two frameworks): the frameworks' bf16 matmuls round at
#: other places, and the bound is twice the JAX package's own distance
#: between its bf16 step and its fp32 step on the same state (qwen3-8b
#: reduced, two steps: loss 5.1e-4, grad_norm 2.0e-3, update 0.152, mu
#: 0.020, nu 0.024, the gradients 0.0197, a leaf 0.028; the port against
#: JAX in bf16 measured loss 4.2e-4, grad_norm 1.2e-3, update 0.133, mu
#: 0.014, nu 0.022).
TRAIN_STEP_TOL = {
    torch.float32: {"loss": 1e-5, "grad_norm": 5e-5, "lr": 1e-6,
                    "grads": 1e-5, "grad_leaf": 2e-5, "update": 1e-3,
                    "mu": 1e-3, "nu": 1e-3},
    torch.bfloat16: {"loss": 1e-3, "grad_norm": 4e-3, "lr": 1e-6,
                     "grads": 0.04, "grad_leaf": 0.06, "update": 0.3,
                     "mu": 0.04, "nu": 0.05},
}


def rel_norm(actual: list, expected: list) -> float:
    """‖actual − expected‖ / ‖expected‖ over the leaves of two lists."""
    a = np.concatenate([_np(x).astype(np.float64).ravel() for x in actual])
    b = np.concatenate([_np(x).astype(np.float64).ravel() for x in expected])
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def grad_share(actual, expected) -> float:
    """max |actual − expected| as a share of max |expected| (two CUDA
    tensors compared on the card, as :func:`max_abs_err`)."""
    if isinstance(expected, torch.Tensor) and expected.is_cuda:
        top = float(expected.detach().abs().max().double())
    else:
        top = float(np.max(np.abs(_np(expected).astype(np.float64))))
    return max_abs_err(actual, expected) / max(top, 1e-30)


def assert_grad_close(actual, expected, dtype, what: str = "gradient",
                      bounds: dict = ATTN_GRAD_TOL) -> float:
    """``actual`` within ``bounds[dtype]`` (``ATTN_GRAD_TOL``, or
    ``WKV_GRAD_TOL`` for wkv6's gradients) of ``expected`` as a share of
    its largest |value|; returns the share."""
    share = grad_share(actual, expected)
    if not share <= bounds[dtype]:
        raise AssertionError(f"{what}: max |Δ| is {share:.3g} of the largest "
                             f"|value| (bound {bounds[dtype]:.3g})")
    return share


def assert_attention_close(actual, expected, bf16: bool,
                           what: str = "attention") -> None:
    """fp32 outputs within RTOL/ATOL; bf16 outputs within BF16_RTOL/ATOL
    (two CUDA tensors compared on the card, as :func:`assert_close`)."""
    rtol = BF16_RTOL if bf16 else RTOL
    if (isinstance(actual, torch.Tensor) and isinstance(expected, torch.Tensor)
            and actual.is_cuda and expected.is_cuda
            and actual.shape == expected.shape
            and _close_on_card(actual, expected, rtol, ATOL)):
        return
    np.testing.assert_allclose(_np(actual), _np(expected), rtol=rtol,
                               atol=ATOL, err_msg=what)


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


def bf16_ulp(x) -> np.ndarray:
    """One bf16 ulp at each |x| (2⁻⁷ of its binade): fp32's spacing × 2¹⁶."""
    return np.spacing(np.abs(np.asarray(x, np.float32))) * np.float32(65536)


def route_flips(top_e, top_e_ref, logits_ref) -> dict:
    """MoE routes ``top_e`` ``(..., K)`` against the reference's, token by
    token, under the near-tie rule.  ``logits_ref`` ``(..., E)`` are the
    router logits the reference took its top K of (bf16 products read as
    fp32).  A token whose set of K experts differs is a *flip*; its
    *margin* is how much the reference prefers the experts it keeps over
    the ones it leaves out: the largest reference logit among the experts
    only the reference took minus the smallest among those only the other
    side took (the reference's K-th minus (K+1)-th logit where one pair
    swapped, and no less where more did).  A flip is a near tie where that
    margin is at most one bf16 ulp at the pair's larger |logit|: the two
    logits are equal or adjacent bf16 values.

    Returns ``flipped`` and ``near`` (bool, the leading shape; ``near`` is
    true where nothing flipped), ``margin`` (the flip margin at flips, the
    reference's K-th minus (K+1)-th logit elsewhere), ``margin_ulps`` (in
    bf16 ulps at the pair), ``min_margin`` (over all tokens) and
    ``max_flip_ulps`` (0 without a flip)."""
    e, e_ref = _np(top_e).astype(np.int64), _np(top_e_ref).astype(np.int64)
    ref = _np(logits_ref).astype(np.float32)
    K, E = e.shape[-1], ref.shape[-1]
    member = np.zeros(e.shape[:-1] + (E,), bool)
    member_ref = np.zeros_like(member)
    np.put_along_axis(member, e, True, -1)
    np.put_along_axis(member_ref, e_ref, True, -1)
    flipped = np.any(member != member_ref, -1)
    pair = -np.sort(-ref, -1)[..., K - 1:K + 1]
    hi = np.where(flipped, np.where(member_ref & ~member, ref,
                                    -np.inf).max(-1), pair[..., 0])
    lo = np.where(flipped, np.where(member & ~member_ref, ref,
                                    np.inf).min(-1), pair[..., 1])
    margin = hi - lo
    ulps = margin / bf16_ulp(np.maximum(np.abs(hi), np.abs(lo)))
    near = ~flipped | (ulps <= 1.0)
    return {"flipped": flipped, "near": near, "margin": margin,
            "margin_ulps": ulps,
            "min_margin": float(margin.min()) if margin.size else math.inf,
            "max_flip_ulps": float(ulps[flipped].max()) if flipped.any()
            else 0.0}


def record_routes(records: list):
    """A :func:`repro_torch.models.layers.route_hook` that appends each MoE
    call's router input and experts, ``(hc, top_e)``, to ``records`` and
    dispatches the call's own routes."""

    def hook(p, hc, cfg, routed):
        records.append((hc, routed[2]))
        return routed[1], routed[2]

    return hook


def follow_routes(targets, flips: list, own: list | None = None):
    """A :func:`repro_torch.models.layers.route_hook` that dispatches the
    i-th MoE call with the experts of ``targets[i]`` = ``(hc, top_e)``,
    another run's router input and experts over the call's first T
    positions (its own router weights at them, renormalised), so the two
    runs' logits stay comparable however their hidden states drift.  Its
    router is first held on that other run's input: its own top K of the
    same ``hc`` against ``top_e`` under :func:`route_flips`, with this
    router's logits as the reference, where every flip must be a near tie
    (``AssertionError`` otherwise; the record goes to ``flips``).  Where
    ``own`` is a list, it gets the :func:`route_flips` of this run's own
    routes, on its own input, against the targets: how far the drift of
    the hidden states moves the routes, read and not held."""
    from repro_torch.models.layers import route

    def hook(p, hc, cfg, routed):
        logits, top_w, top_e = routed
        i = len(flips)
        t_hc, t_e = targets[i]
        T = t_e.shape[1]
        t_e = t_e.to(top_e.device)
        lg_same, _, e_same = route(p, t_hc.to(hc.device), cfg)
        rf = route_flips(t_e, e_same, lg_same)
        far = rf["flipped"] & ~rf["near"]
        assert not far.any(), (
            f"MoE call {i}: on the same router input the experts differ "
            f"where this router's margin is "
            f"{rf['margin_ulps'][far].tolist()} bf16 ulps (not a near tie)")
        flips.append(rf)
        if own is not None:
            own.append(route_flips(t_e, top_e[:, :T], logits[:, :T]))
        w = torch.gather(torch.softmax(logits[:, :T], dim=-1), -1, t_e)
        w = w / torch.clamp_min(w.sum(-1, keepdim=True), 1e-9)
        top_e, top_w = top_e.clone(), top_w.clone()
        top_e[:, :T], top_w[:, :T] = t_e, w
        return top_w, top_e

    return hook


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
