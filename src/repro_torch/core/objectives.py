"""Submodular objectives (counterpart of ``repro.core.objectives``).

Incremental-oracle interface used by :mod:`repro_torch.core.algorithms`:

    state = obj.init_state(T, mask)        # per-machine state
    gains = obj.gains(state, T, mask)      # (..., cap) marginal gains
    state = obj.update(state, T, idx)      # commit item T[..., idx, :]
    value = obj.value(state)               # f(selected set)

``T`` is a ``(cap, d)`` block or a ``(M, cap, d)`` stack of machine blocks
(the JAX package's ``vmap`` over machines, written out as a leading axis);
``mask`` and the state follow it.

This slice ports :class:`ExemplarClustering` in fp32; the weighted variant
and the other objectives come with ROADMAP queue 1 item 9, bf16 scoring
(``score_dtype``) with item 10.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.kernels import ops as kops

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

    rowwise_gains = True  # gains depend only on candidate rows

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
    def fused_select(self, T: torch.Tensor, mask: torch.Tensor, k: int):
        """Whole k-step greedy through ``ops.greedy_select``.

        Returns ``(sel_idx, sel_mask, value, oracle_calls)``.  Step t
        evaluates one gain per still-available candidate and succeeds iff
        one remains, so the oracle-call count is closed-form in the number
        of available candidates.
        """
        state = self.init_state(T, mask)
        seed = state["cur_min"].reshape(-1, self.eval_set.shape[0])[0]
        sel_idx, cur_min = kops.greedy_select(T, self.eval_set, seed, mask, k)
        value = state["base"] - torch.mean(cur_min, dim=-1)
        n_avail = torch.sum(mask.long(), dim=-1, keepdim=True)
        t = torch.arange(k, device=mask.device)
        sel_mask = t < n_avail
        calls = torch.sum(torch.clamp_min(n_avail - t, 0), dim=-1)
        return sel_idx, sel_mask, value, calls

    # -- set-function oracle (cross-machine comparison / tests) ------------
    def evaluate(self, S: torch.Tensor, s_mask: torch.Tensor) -> torch.Tensor:
        """f(S) for a (k, d) block of selected rows with validity mask."""
        d2 = kops.pairwise_sqdist(self.eval_set, S)         # (n_eval, k)
        d2 = torch.where(s_mask[None, :], d2, torch.full_like(d2, torch.inf))
        e0 = torch.sum(self.eval_set * self.eval_set, dim=-1)
        cur = torch.minimum(e0, torch.min(d2, dim=-1).values)
        return torch.mean(e0) - torch.mean(cur)
