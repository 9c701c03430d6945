"""Submodular objectives (counterpart of ``repro.core.objectives``).

Incremental-oracle interface used by :mod:`repro_torch.core.algorithms`:

    state = obj.init_state(T, mask)        # per-machine state
    gains = obj.gains(state, T, mask)      # (..., cap) marginal gains
    state = obj.update(state, T, idx)      # commit item T[..., idx, :]
    value = obj.value(state)               # f(selected set)

``T`` is a ``(cap, d)`` block or a ``(M, cap, d)`` stack of machine blocks
(the JAX package's ``vmap`` over machines, written out as a leading axis);
``mask`` and the state follow it.

The port has :class:`ExemplarClustering` in fp32, with the fused hooks of
GREEDY (``fused_select``, unconstrained and under the knapsack /
partition-matroid encodings) and of THRESHOLD-BATCH
(``fused_threshold_select``); the weighted variant and the other
objectives come with ROADMAP queue 1 item 9, bf16 scoring
(``score_dtype``) with item 10.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.kernels import ops as kops
from repro_torch.kernels.ref import Encoding, commit_state

NEG_INF = -1e30


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

    rowwise_gains = True    # gains depend only on candidate rows
    fused_knapsack = True   # fused hooks take a weights/budget encoding
    fused_partition = True  # fused hooks take a group_ids/caps encoding

    @property
    def device(self) -> torch.device:
        return self.eval_set.device

    # -- oracle interface ------------------------------------------------
    def init_state(self, T: torch.Tensor, mask: torch.Tensor) -> dict:
        E = self.eval_set
        cur_min = torch.sum(E * E, dim=-1)                  # d(e, e0)
        cur_min = cur_min.expand(*T.shape[:-2], E.shape[0])
        return {"cur_min": cur_min, "base": torch.mean(cur_min, dim=-1)}

    def gains(self, state, T: torch.Tensor, mask: torch.Tensor
              ) -> torch.Tensor:
        g = kops.exemplar_gains(T, self.eval_set, state["cur_min"])
        return _masked(g, mask)

    def update(self, state, T: torch.Tensor, idx: torch.Tensor) -> dict:
        # difference form Σ(E − x)², not the gains' contraction form: the
        # fused kernels refresh cur_min the same way
        x = torch.take_along_dim(T, idx[..., None, None], dim=-2)  # (..., 1, d)
        d2 = torch.sum((self.eval_set - x) ** 2, dim=-1)    # (..., m)
        return {"cur_min": torch.minimum(state["cur_min"], d2),
                "base": state["base"]}

    def value(self, state) -> torch.Tensor:
        return state["base"] - torch.mean(state["cur_min"], dim=-1)

    # -- fused selection hook (algorithms.greedy fast path) ---------------
    def fused_select(self, T: torch.Tensor, mask: torch.Tensor, k: int, *,
                     weights=None, budget=None, group_ids=None, caps=None):
        """Whole k-step greedy through ``ops.greedy_select``.

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
                                              k, enc=enc)
        value = state["base"] - torch.mean(cur_min, dim=-1)
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
                               bn: int = 256):
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
        available singly-feasible candidate.
        """
        batched = T.dim() == 3
        Tb = T if batched else T.unsqueeze(0)
        mb = (mask if batched else mask.unsqueeze(0)).bool()
        M, n, _ = Tb.shape
        dev = Tb.device
        E = self.eval_set
        state = self.init_state(Tb, mb)
        cm, base = state["cur_min"], state["base"]
        enc = Encoding(M, n, dev, weights, budget, group_ids, caps)  # once
        used = torch.zeros((M,), dtype=torch.float32, device=dev)
        counts = torch.zeros((M, enc.G), dtype=torch.int32, device=dev)
        count = torch.zeros((M,), dtype=torch.int32, device=dev)
        cand = enc.feasible(mb, used, counts)
        g0 = kops.exemplar_gains(Tb, E, cm)
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
                count=count, bn=bn, active=active, enc=enc)
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
        value = base - torch.mean(cm, dim=-1)
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
        return torch.mean(e0) - torch.mean(cur)
