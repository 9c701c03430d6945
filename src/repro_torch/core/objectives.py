"""Submodular objectives (counterpart of ``repro.core.objectives``).

Incremental-oracle interface used by :mod:`repro_torch.core.algorithms`:

    state = obj.init_state(T, mask)        # per-machine state
    gains = obj.gains(state, T, mask)      # (..., cap) marginal gains
    state = obj.update(state, T, idx)      # commit item T[..., idx, :]
    value = obj.value(state)               # f(selected set)

``T`` is a ``(cap, d)`` block or a ``(M, cap, d)`` stack of machine blocks
(the JAX package's ``vmap`` over machines, written out as a leading axis);
``mask`` and the state follow it.

The port has every objective of the JAX package:

* :class:`ExemplarClustering` and :class:`WeightedExemplarClustering`, with
  the fused hooks of GREEDY (``fused_select``, unconstrained and under the
  knapsack / partition-matroid encodings) and of THRESHOLD-BATCH
  (``fused_threshold_select``); the weighted one reweights every mean over
  the eval set through the ``_ew`` / ``_mean_score`` hooks.  The fused
  hooks take narrow blocks (bf16, or int8 with per-row ``x_scale``/
  ``x_zp``: the kernels dequantize), and ``score_dtype="bfloat16"``
  contracts x·e in bf16 on the fused and the step-wise paths alike (the
  CPU reading of the JAX package's ``score_dtype``);
* :class:`ActiveSetSelection` (the paper's information gain, §4.2): a
  running Cholesky state against every candidate, one ``rbf_kernel`` row
  per step; not row-wise, so GREEDY takes the step-wise scan and
  THRESHOLD-BATCH refuses it;
* :class:`FacilityLocation`: gains from the RBF similarity of the eval set
  to every candidate, scored in candidate chunks;
* :class:`WeightedCoverage`: plain tensor code, as in the JAX package.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.device import resolve_device
from repro_torch.kernels import ops as kops
from repro_torch.kernels.ref import Encoding, commit_state, exact_fp32

NEG_INF = -1e30

#: FacilityLocation scores candidates in chunks whose (…, n_eval, chunk)
#: fp32 similarity tile stays under this many bytes (at a Webscope round 0
#: the whole tile would be 2,000 × 512 × 22,500 × 4 B = 92 GB)
SIM_BYTES = 4 << 30


def _masked(gains: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    return torch.where(mask, gains, torch.full_like(gains, NEG_INF))


@dataclasses.dataclass(frozen=True, eq=False)
class ExemplarClustering:
    """Exemplar-based clustering objective (paper §4.2).

    ``f(S) = L({e0}) − L(S ∪ {e0})`` with ``L(S) = mean_j min_{v∈S} ‖e_j − v‖²``
    and ``e0 = 0``.  ``eval_set`` is a fixed random subsample of the ground
    set, shared by every machine.  State: ``cur_min``, the running minimum
    distance of each eval row (e0 included), and ``base = L({e0})``.
    """

    eval_set: torch.Tensor  # (n_eval, d) fp32
    score_dtype: str | None = None  # "bfloat16": x·e contracted in bf16

    rowwise_gains = True    # gains depend only on candidate rows
    fused_knapsack = True   # fused hooks take a weights/budget encoding
    fused_partition = True  # fused hooks take a group_ids/caps encoding

    @property
    def device(self) -> torch.device:
        return self.eval_set.device

    def __post_init__(self):
        if self.score_dtype not in (None, "bfloat16"):
            raise ValueError(f"score_dtype must be None or 'bfloat16', got "
                             f"{self.score_dtype!r}")

    def _cd(self):
        """The gain kernels' ``compute_dtype``."""
        return torch.bfloat16 if self.score_dtype == "bfloat16" else None

    # -- reweighting hooks (WeightedExemplarClustering overrides) ---------
    def _ew(self) -> torch.Tensor | None:
        """Eval-column weights for the gain kernels (None = unweighted)."""
        return None

    def _mean_score(self, cm: torch.Tensor) -> torch.Tensor:
        """The loss L of a running minimum ``cm`` ``(..., m)``: its mean
        over the eval set (weighted in the subclass)."""
        return torch.mean(cm, dim=-1)

    # -- oracle interface ------------------------------------------------
    def init_state(self, T: torch.Tensor, mask: torch.Tensor) -> dict:
        E = self.eval_set
        cur_min = torch.sum(E * E, dim=-1)                  # d(e, e0)
        cur_min = cur_min.expand(*T.shape[:-2], E.shape[0])
        return {"cur_min": cur_min, "base": self._mean_score(cur_min)}

    def gains(self, state, T: torch.Tensor, mask: torch.Tensor
              ) -> torch.Tensor:
        g = kops.exemplar_gains(T, self.eval_set, state["cur_min"],
                                compute_dtype=self._cd(),
                                eval_weights=self._ew())
        return _masked(g, mask)

    def update(self, state, T: torch.Tensor, idx: torch.Tensor) -> dict:
        # difference form Σ(E − x)², not the gains' contraction form: the
        # fused kernels refresh cur_min the same way
        x = torch.take_along_dim(T, idx[..., None, None], dim=-2)  # (..., 1, d)
        d2 = torch.sum((self.eval_set - x) ** 2, dim=-1)    # (..., m)
        return {"cur_min": torch.minimum(state["cur_min"], d2),
                "base": state["base"]}

    def value(self, state) -> torch.Tensor:
        return state["base"] - self._mean_score(state["cur_min"])

    # -- fused selection hook (algorithms.greedy fast path) ---------------
    def fused_select(self, T: torch.Tensor, mask: torch.Tensor, k: int, *,
                     weights=None, budget=None, group_ids=None, caps=None,
                     x_scale=None, x_zp=None):
        """Whole k-step greedy through ``ops.greedy_select``.

        ``T`` may be narrow: bf16, or int8 with per-row ``x_scale``/``x_zp``
        (dequantized in the kernel).

        Returns ``(sel_idx, sel_mask, value, oracle_calls)``.  Unconstrained,
        step t evaluates one gain per still-available candidate and succeeds
        iff one remains, so the oracle-call count is closed-form.  Under the
        knapsack (``weights``/``budget``) or partition (``group_ids``/
        ``caps``) encodings the count is replayed from the selections with
        the same sequential state accumulation, on every machine at once.
        """
        state = self.init_state(T, mask)
        seed = state["cur_min"].reshape(-1, self.eval_set.shape[0])[0]
        batch, n = mask.shape[:-1], mask.shape[-1]
        M = math.prod(batch)
        enc = Encoding(M, n, mask.device, weights, budget, group_ids, caps)
        sel_idx, cur_min = kops.greedy_select(T, self.eval_set, seed, mask,
                                              k, enc=enc,
                                              eval_weights=self._ew(),
                                              compute_dtype=self._cd(),
                                              x_scale=x_scale, x_zp=x_zp)
        value = state["base"] - self._mean_score(cur_min)
        if enc.w is None and enc.gid is None:
            n_avail = torch.sum(mask.long(), dim=-1, keepdim=True)
            t = torch.arange(k, device=mask.device)
            sel_mask = t < n_avail
            calls = torch.sum(torch.clamp_min(n_avail - t, 0), dim=-1)
            return sel_idx, sel_mask, value, calls
        sel = sel_idx.reshape(M, k)
        avail = mask.reshape(M, n).bool().clone()
        used = torch.zeros((M,), dtype=torch.float32, device=mask.device)
        counts = torch.zeros((M, enc.G), dtype=torch.int32,
                             device=mask.device)
        rows = torch.arange(M, device=mask.device)
        calls = torch.zeros((M,), dtype=torch.long, device=mask.device)
        for t in range(k):                       # the count_step replay
            calls += torch.sum(enc.feasible(avail, used, counts).long(), -1)
            ok = sel[:, t] >= 0
            safe = torch.clamp_min(sel[:, t], 0)
            used, counts = commit_state(enc, used, counts, safe, ok)
            avail[rows, safe] = avail[rows, safe] & ~ok
        return sel_idx, sel_idx >= 0, value, calls.reshape(batch)

    # -- low-adaptivity hook (algorithms.threshold_batch) ------------------
    def fused_threshold_select(self, T: torch.Tensor, mask: torch.Tensor,
                               k: int, *, eps: float = 0.5, weights=None,
                               budget=None, group_ids=None, caps=None,
                               x_scale=None, x_zp=None, bn: int = 256):
        """τ-ladder threshold-batch selection on every machine at once.

        One ``exemplar_gains`` pass sets each machine's ``d_max``; then the
        ladder lowers τ_l = d_max·(1−ε)^l (fp32, ``torch.pow``, the JAX
        package's operation order) and each level is ONE
        ``ops.threshold_select`` launch over all machines.  A machine's
        ladder ends once k items are selected, no available item is singly
        feasible, or l reaches ⌈log(2k/ε)/ε⌉: it keeps its state and pays
        no more launches or calls (the JAX package's ``vmap``-ped
        ``while_loop``), and the loop stops when no machine is active — one
        host read per level.  ``used``, ``counts``, ``count``, ``sel_idx``
        and availability are recomputed from each accept mask.

        Returns ``(sel_idx, sel_mask, value, oracle_calls, launches)``;
        every launch (and the init pass) counts one oracle call per
        available singly-feasible candidate.  ``T`` may be narrow (bf16,
        or int8 with per-row ``x_scale``/``x_zp``).
        """
        batched = T.dim() == 3
        Tb = T if batched else T.unsqueeze(0)
        mb = (mask if batched else mask.unsqueeze(0)).bool()
        M, n, _ = Tb.shape
        qkw = {} if x_scale is None else {
            "x_scale": x_scale.reshape(M, n), "x_zp": x_zp.reshape(M, n)}
        cd = self._cd()
        dev = Tb.device
        E = self.eval_set
        state = self.init_state(Tb, mb)
        cm, base = state["cur_min"], state["base"]
        enc = Encoding(M, n, dev, weights, budget, group_ids, caps)  # once
        used = torch.zeros((M,), dtype=torch.float32, device=dev)
        counts = torch.zeros((M, enc.G), dtype=torch.int32, device=dev)
        count = torch.zeros((M,), dtype=torch.int32, device=dev)
        cand = enc.feasible(mb, used, counts)
        ew = self._ew()
        g0 = kops.exemplar_gains(Tb, E, cm, eval_weights=ew,
                                 compute_dtype=cd, **qkw)
        d_max = torch.clamp_min(torch.amax(torch.where(cand, g0, 0.0),
                                           dim=-1), 1e-12)
        calls = torch.sum(cand.long(), dim=-1)
        n_levels = max(1, math.ceil(math.log(2.0 * k / eps) / eps))
        ratio = torch.tensor(1.0 - eps, dtype=torch.float32, device=dev)
        level = torch.zeros((M,), dtype=torch.int32, device=dev)
        launches = torch.zeros((M,), dtype=torch.long, device=dev)
        avail = mb.clone()
        sel = torch.full((M, k + 1), -1, dtype=torch.long, device=dev)
        idx = torch.arange(n, device=dev).expand(M, n)
        while True:
            cand = enc.feasible(avail, used, counts)
            active = (level < n_levels) & (count < k) & torch.any(cand, -1)
            if not bool(torch.any(active)):
                break
            tau = d_max * torch.pow(ratio, level.float())
            calls += torch.where(active, torch.sum(cand.long(), dim=-1), 0)
            acc, cm = kops.threshold_select(
                Tb, E, cm, avail, tau, k, used=used, counts=counts,
                count=count, bn=bn, active=active, enc=enc,
                eval_weights=ew, compute_dtype=cd, **qkw)
            # accepted block positions land in sel in index order; prefix
            # feasibility keeps them below k (column k drops the rest)
            order = count.unsqueeze(1) + torch.cumsum(acc.int(), dim=1) - 1
            sel.scatter_(1, torch.where(acc, order, k).long(), idx)
            sel[:, k] = -1
            count = count + torch.sum(acc.int(), dim=-1, dtype=torch.int32)
            if enc.w is not None:
                used = used + torch.sum(torch.where(acc, enc.w, 0.0), dim=-1)
            if enc.gid is not None:
                safe = torch.where(acc, enc.gid, 0).long()
                counts = counts + torch.zeros_like(counts).scatter_add_(
                    1, safe, acc.int())
            avail = avail & ~acc
            launches += active.long()
            level += active.int()
        value = base - self._mean_score(cm)
        sel_idx = sel[:, :k]
        sel_mask = torch.arange(k, device=dev) < count.unsqueeze(1)
        out = (sel_idx, sel_mask, value, calls, launches)
        return out if batched else tuple(o[0] for o in out)

    # -- set-function oracle (cross-machine comparison / tests) ------------
    def evaluate(self, S: torch.Tensor, s_mask: torch.Tensor) -> torch.Tensor:
        """f(S) for a (k, d) block of selected rows with validity mask."""
        d2 = kops.pairwise_sqdist(self.eval_set, S)         # (n_eval, k)
        d2 = torch.where(s_mask[None, :], d2, torch.full_like(d2, torch.inf))
        e0 = torch.sum(self.eval_set * self.eval_set, dim=-1)
        cur = torch.minimum(e0, torch.min(d2, dim=-1).values)
        return self._mean_score(e0) - self._mean_score(cur)


@dataclasses.dataclass(frozen=True, eq=False)
class WeightedExemplarClustering(ExemplarClustering):
    """Query-reweighted exemplar clustering (the serve layer's objective).

    :class:`ExemplarClustering` with every mean over the eval set weighted:
    ``L_w(S) = (1/m) Σ_j w_j · min_{v∈S∪{e0}} ‖e_j − v‖²`` and
    ``f_w(S) = L_w({e0}) − L_w(S ∪ {e0})``.  The gain kernels take the
    weights as an operand (their weighted instantiation on the card).

    With ``w_j = 1.0`` exactly, every gain, value and selection has the
    unweighted objective's bits, on the CPU and on the card: the kernels
    add ``fma(contrib, 1.0, sum)``, which is ``sum + contrib``, and the
    plain versions multiply by 1.0 before the same reduction.
    """

    eval_weights: torch.Tensor | None = None  # (n_eval,) fp32, mean ≈ 1

    def _ew(self) -> torch.Tensor | None:
        return self.eval_weights

    def _mean_score(self, cm: torch.Tensor) -> torch.Tensor:
        return torch.mean(self.eval_weights * cm, dim=-1)


def _set_rows(C: torch.Tensor, step: torch.Tensor, row: torch.Tensor,
              ok: torch.Tensor | None = None) -> None:
    """``C[..., step, :] = row`` in place, per machine, where ``ok``.  A
    ``step`` past the last row drops the write, as the JAX package's
    ``.at[step].set`` does (``greedy`` refuses ``k > k_max`` up front)."""
    k_max, cap = C.shape[-2], C.shape[-1]
    Cf = C.view(-1, k_max, cap)
    s = step.reshape(-1)
    keep = s < k_max
    if ok is not None:
        keep = keep & ok.reshape(-1)
    rows = torch.arange(Cf.shape[0], device=C.device)
    s = torch.clamp_max(s, k_max - 1)
    Cf[rows, s] = torch.where(keep[:, None], row.reshape(-1, cap),
                              Cf[rows, s])


@dataclasses.dataclass(frozen=True, eq=False)
class ActiveSetSelection:
    """Active set selection / Informative Vector Machine (paper §4.2).

    ``f(S) = ½ logdet(I + σ⁻² K_SS)`` with ``K(x, y) = exp(−‖x − y‖²/h²)``
    (the paper's h = 0.5, σ = 1).  The state is a running Cholesky
    factorisation of ``I + σ⁻² K_SS`` against every candidate, batched over
    machines: ``C`` ``(…, k_max, cap)`` rows of ``L⁻¹ A_{S,T}``, ``r``
    ``(…, cap)`` the Schur complements, ``logdet`` and ``step`` per machine.
    A candidate's gain is ``½ log r``.

    ``update`` computes one kernel row ``rbf(T[idx], T) / σ²`` per machine
    through ``ops.rbf_kernel`` and ``cross = Cᵀ C[:, idx]`` as a plain
    batched product (the JAX package computes it outside any kernel too),
    in the JAX operation order.  ``device`` is where the state lives (the
    card unless ``"cpu"``).
    """

    k_max: int
    h: float = 0.5
    sigma: float = 1.0
    device: torch.device | str | None = None

    rowwise_gains = False  # gains read per-block-index Cholesky state

    def __post_init__(self):
        object.__setattr__(self, "device", resolve_device(self.device))

    def _A(self, X: torch.Tensor, Y: torch.Tensor) -> torch.Tensor:
        return kops.rbf_kernel(X, Y, self.h) / (self.sigma ** 2)

    def init_state(self, T: torch.Tensor, mask: torch.Tensor) -> dict:
        batch, cap = T.shape[:-2], T.shape[-2]
        dev = T.device
        diag = torch.ones(batch + (cap,), dtype=torch.float32,
                          device=dev) / (self.sigma ** 2)  # K(x, x) = 1
        return {
            "C": torch.zeros(batch + (self.k_max, cap), dtype=torch.float32,
                             device=dev),
            "r": 1.0 + diag,
            "logdet": torch.zeros(batch, dtype=torch.float32, device=dev),
            "step": torch.zeros(batch, dtype=torch.long, device=dev),
        }

    def gains(self, state, T: torch.Tensor, mask: torch.Tensor
              ) -> torch.Tensor:
        g = 0.5 * torch.log(torch.clamp_min(state["r"], 1e-12))
        return _masked(g, mask)

    def _step(self, state, T: torch.Tensor, idx: torch.Tensor):
        """One incremental-Cholesky step: (new row, r, logdet)."""
        C = state["C"]
        exact_fp32(C)
        x = torch.take_along_dim(T, idx[..., None, None], dim=-2)  # (…, 1, d)
        a_row = self._A(x, T)[..., 0, :]                           # (…, cap)
        c_s = torch.take_along_dim(C, idx[..., None, None], dim=-1)
        cross = (C.transpose(-1, -2) @ c_s)[..., 0]        # Σ_j C_js C_ji
        r_s = torch.clamp_min(
            torch.take_along_dim(state["r"], idx[..., None], dim=-1)[..., 0],
            1e-12)
        new_row = (a_row - cross) / torch.sqrt(r_s)[..., None]
        r = torch.clamp_min(state["r"] - new_row ** 2, 1e-12)
        return new_row, r, state["logdet"] + torch.log(r_s)

    def update(self, state, T: torch.Tensor, idx: torch.Tensor) -> dict:
        new_row, r, logdet = self._step(state, T, idx)
        C = state["C"].clone()
        _set_rows(C, state["step"], new_row)
        # the selected item becomes unavailable numerically; greedy masks it
        return {"C": C, "r": r, "logdet": logdet, "step": state["step"] + 1}

    def masked_update(self, state, T: torch.Tensor, idx: torch.Tensor,
                      ok: torch.Tensor) -> dict:
        """``update`` where ``ok`` per machine, the old state elsewhere:
        the bits of ``_where_state(ok, update(state, …), state)``, with the
        new row written into ``state["C"]`` in place (``C`` is k_max rows
        against every candidate — 9 GB at a Webscope round 0 — so no
        per-step copy of it).  ``state`` is consumed."""
        new_row, r, logdet = self._step(state, T, idx)
        _set_rows(state["C"], state["step"], new_row, ok)
        return {"C": state["C"],
                "r": torch.where(ok[..., None], r, state["r"]),
                "logdet": torch.where(ok, logdet, state["logdet"]),
                "step": torch.where(ok, state["step"] + 1, state["step"])}

    def value(self, state) -> torch.Tensor:
        return 0.5 * state["logdet"]

    def evaluate(self, S: torch.Tensor, s_mask: torch.Tensor) -> torch.Tensor:
        """f(S) for a (k, d) block of selected rows with validity mask:
        ``rbf(S, S)`` through ``ops.rbf_kernel``, then ``slogdet``."""
        m = S.shape[0]
        A = self._A(S, S)
        eye = torch.eye(m, dtype=torch.float32, device=S.device)
        # invalid rows/cols -> identity block (contributes logdet 0)
        valid = s_mask[:, None] & s_mask[None, :]
        Mx = eye + torch.where(valid, A, torch.zeros_like(A))
        Mx = torch.where(s_mask[:, None] | s_mask[None, :], Mx, eye)
        return 0.5 * torch.linalg.slogdet(Mx).logabsdet


@dataclasses.dataclass(frozen=True, eq=False)
class FacilityLocation:
    """``f(S) = mean_j max_{v∈S} sim(e_j, v)``, ``sim`` the RBF kernel with
    bandwidth ``h``.  State: ``cur_max`` ``(…, n_eval)``."""

    eval_set: torch.Tensor  # (n_eval, d) fp32
    h: float = 1.0

    rowwise_gains = True

    @property
    def device(self) -> torch.device:
        return self.eval_set.device

    def _sim(self, X: torch.Tensor, Y: torch.Tensor) -> torch.Tensor:
        return kops.rbf_kernel(X, Y, self.h)

    def init_state(self, T: torch.Tensor, mask: torch.Tensor) -> dict:
        return {"cur_max": torch.zeros(
            T.shape[:-2] + (self.eval_set.shape[0],), dtype=torch.float32,
            device=T.device)}

    def gains(self, state, T: torch.Tensor, mask: torch.Tensor
              ) -> torch.Tensor:
        """``mean_j max(sim_ji − cur_max_j, 0)`` per candidate i.  The
        candidate axis is scored in chunks whose similarity tile stays
        under :data:`SIM_BYTES`; a candidate's gain depends only on its own
        column, so the chunking changes no value."""
        n, m = T.shape[-2], self.eval_set.shape[0]
        step = max(1, SIM_BYTES // (4 * m * math.prod(T.shape[:-2])))
        cur = state["cur_max"].unsqueeze(-1)                # (…, m, 1)
        parts = []
        for c0 in range(0, n, step):
            sim = self._sim(self.eval_set, T[..., c0:c0 + step, :])
            parts.append(torch.mean(sim.sub_(cur).clamp_min_(0.0), dim=-2))
        g = torch.cat(parts, dim=-1) if parts else torch.zeros(
            mask.shape, dtype=torch.float32, device=T.device)
        return _masked(g, mask)

    def update(self, state, T: torch.Tensor, idx: torch.Tensor) -> dict:
        x = torch.take_along_dim(T, idx[..., None, None], dim=-2)  # (…, 1, d)
        sim = self._sim(self.eval_set, x)[..., 0]                  # (…, m)
        return {"cur_max": torch.maximum(state["cur_max"], sim)}

    def value(self, state) -> torch.Tensor:
        return torch.mean(state["cur_max"], dim=-1)

    def evaluate(self, S: torch.Tensor, s_mask: torch.Tensor) -> torch.Tensor:
        sim = self._sim(self.eval_set, S)
        sim = torch.where(s_mask[None, :], sim,
                          torch.full_like(sim, -torch.inf))
        best = torch.amax(sim, dim=-1)
        return torch.mean(torch.clamp_min(best, 0.0))


@dataclasses.dataclass(frozen=True, eq=False)
class WeightedCoverage:
    """Items are rows of a binary incidence matrix over a small universe:
    ``f(S) = Σ_u w_u · 1[u covered by S]``.  Plain tensor code (the JAX
    package has no kernel here either)."""

    weights: torch.Tensor  # (U,) fp32

    rowwise_gains = True

    @property
    def device(self) -> torch.device:
        return self.weights.device

    def init_state(self, T: torch.Tensor, mask: torch.Tensor) -> dict:
        return {"covered": torch.zeros(
            T.shape[:-2] + (self.weights.shape[0],), dtype=torch.float32,
            device=T.device)}

    def gains(self, state, T: torch.Tensor, mask: torch.Tensor
              ) -> torch.Tensor:
        exact_fp32(T)
        uncovered = (1.0 - state["covered"]) * self.weights       # (…, U)
        g = ((T > 0.5).float() @ uncovered.unsqueeze(-1))[..., 0]  # (…, cap)
        return _masked(g, mask)

    def update(self, state, T: torch.Tensor, idx: torch.Tensor) -> dict:
        x = torch.take_along_dim(T, idx[..., None, None], dim=-2)[..., 0, :]
        return {"covered": torch.maximum(state["covered"],
                                         (x > 0.5).float())}

    def value(self, state) -> torch.Tensor:
        return torch.sum(state["covered"] * self.weights, dim=-1)

    def evaluate(self, S: torch.Tensor, s_mask: torch.Tensor) -> torch.Tensor:
        inc = (S > 0.5).float() * s_mask[:, None].float()
        covered = torch.amax(inc, dim=0)
        return torch.sum(covered * self.weights)
