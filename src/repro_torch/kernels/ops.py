"""Public kernel entry points: pad → dispatch → slice (counterpart of
``repro.kernels.ops``).

Dispatch follows the tensors: a CPU tensor takes the plain version
(:mod:`repro_torch.kernels.ref`), a CUDA tensor launches the hand-written
kernel or the call raises — there is no fallback to the plain version on
the card, and no capacity rule choosing one (a shape the kernel does not
take raises).

The wrappers own the padding contract: the eval set and ``cur_min`` are
zero-padded to the kernels' eval tile, so padded columns contribute
``max(0 − d², 0) = 0`` exactly; the ragged candidate edge is masked inside
the kernels, so ``X`` is never copied.  Raw gain sums are divided by the
*unpadded* eval-set size, as in ``repro.kernels.ops``.

Every argument of the JAX signatures that this slice does not port raises
:class:`NotImplementedError` naming its ROADMAP item.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import exemplar_gains as _eg
from repro_torch.kernels import greedy_select as _gs
from repro_torch.kernels import ref
from repro_torch.kernels._build import launch_counts  # noqa: F401

__all__ = ["exemplar_gains", "greedy_select", "launch_counts",
           "pairwise_sqdist", "reset_launch_counts"]


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


def _on_card(t: torch.Tensor) -> bool:
    if t.device.type == "cpu":
        return False
    if t.device.type == "cuda":
        return True
    raise RuntimeError(f"no kernel for tensors on {t.device}: pass CPU "
                       "tensors for the plain version or CUDA tensors")


def _pad_eval(E: torch.Tensor, cur_min: torch.Tensor):
    """Zero-pad the eval rows and the cur_min columns to the eval tile.
    The padded cur_min is always a fresh tensor: greedy_select's kernel
    updates it in place."""
    m = E.shape[0]
    mp = m + (-m) % _eg.BM
    Ep = F.pad(E, (0, 0, 0, mp - m)).contiguous()
    cmp_ = torch.zeros((cur_min.shape[0], mp), dtype=torch.float32,
                       device=cur_min.device)
    cmp_[:, :m] = cur_min
    return Ep, cmp_


def pairwise_sqdist(X: torch.Tensor, Y: torch.Tensor) -> torch.Tensor:
    """(..., n, d), (m, d) -> (..., n, m).  Always the plain version."""
    return ref.pairwise_sqdist(X, Y)


def exemplar_gains(X: torch.Tensor, E: torch.Tensor, cur_min: torch.Tensor,
                   *, compute_dtype=None, x_scale=None, x_zp=None,
                   eval_weights=None) -> torch.Tensor:
    """Marginal gains of exemplar clustering for every row of ``X``.

    ``X`` is ``(n, d)`` or ``(M, n, d)``; ``cur_min`` is ``(m,)`` (shared)
    or ``(M, m)``.  Returns ``(n,)`` or ``(M, n)``.
    """
    ref.reject_unported(compute_dtype=compute_dtype, x_scale=x_scale,
                        x_zp=x_zp, eval_weights=eval_weights)
    if not _on_card(X):
        return ref.exemplar_gains(X, E, cur_min)
    batched = X.dim() == 3
    Xb = (X if batched else X.unsqueeze(0)).float().contiguous()
    M, m = Xb.shape[0], E.shape[0]
    cm = cur_min.reshape(-1, m).expand(M, m)
    Ep, cmp_ = _pad_eval(E.float(), cm)
    g = _eg.launch(Xb, Ep, cmp_) / m
    return g if batched else g[0]


def greedy_select(X: torch.Tensor, E: torch.Tensor, cur_min: torch.Tensor,
                  mask: torch.Tensor, k: int, *, compute_dtype=None,
                  weights=None, budget=None, group_ids=None, caps=None,
                  x_scale=None, x_zp=None, eval_weights=None):
    """Fused k-step exemplar greedy; returns ``(sel_idx, cur_min_out)``.

    ``X`` is ``(n, d)`` or ``(M, n, d)`` with ``mask`` ``(n,)`` or
    ``(M, n)``; ``cur_min`` ``(m,)`` seeds every machine.  ``sel_idx`` is
    int64, −1 from the first step with no available candidate on.  Ties
    go to the lowest index.  On the CPU the result is bit-identical to the
    step-wise greedy with ``ExemplarClustering``; on the card both score a
    row with the same kernel tile, and only the difference-form
    ``cur_min`` refresh may round apart (fma in the kernel).
    """
    ref.reject_unported(compute_dtype=compute_dtype, weights=weights,
                        budget=budget, group_ids=group_ids, caps=caps,
                        x_scale=x_scale, x_zp=x_zp, eval_weights=eval_weights)
    if not _on_card(X):
        return ref.greedy_select(X, E, cur_min, mask, k)
    batched = X.dim() == 3
    Xb = (X if batched else X.unsqueeze(0)).float().contiguous()
    M, m = Xb.shape[0], E.shape[0]
    avail = mask.reshape(M, -1).to(torch.uint8, copy=True)  # kernel state
    cm = cur_min.reshape(-1, m).expand(M, m)
    Ep, cmp_ = _pad_eval(E.float(), cm)
    sel, cm_out = _gs.launch(Xb, Ep, cmp_, avail, k, m)
    sel, cm_out = sel.long(), cm_out[:, :m]
    return (sel, cm_out) if batched else (sel[0], cm_out[0])
