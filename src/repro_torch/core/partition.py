"""Balanced random partitioning via the paper's virtual-location scheme (§3)
(counterpart of ``repro.core.partition``).

Placing items one by one into uniformly random free slots of L parts with
⌈N/L⌉ slots each is a uniformly random injection of items into slots:
draw a uniform permutation of all slots and map item j to slot perm⁻¹(j).
The permutation comes from a round plan (:mod:`repro_torch.core.plan`).
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch


class Partition(NamedTuple):
    idx: torch.Tensor   # (L, cap) int64 — item index per slot, -1 for empty
    mask: torch.Tensor  # (L, cap) bool


def n_parts(n_items: int, capacity: int) -> int:
    """m_t = ⌈|A_t| / μ⌉ (Algorithm 1, line 7)."""
    return max(1, math.ceil(n_items / capacity))


def balanced_partition(plan, t: int, n_items: int, L: int,
                       cap: int | None = None,
                       device: torch.device | str = "cpu") -> Partition:
    """Partition items {0..n_items-1} into L parts of ≤ ⌈N/L⌉ ≤ cap slots,
    with round ``t``'s slot permutation from ``plan``."""
    per = math.ceil(n_items / L)
    if cap is not None:
        assert per <= cap, f"capacity violated: ⌈{n_items}/{L}⌉={per} > μ={cap}"
        per = cap  # fixed-width blocks; extra slots stay empty (masked)
    perm = plan.slot_permutation(t, L * per).to(device)
    idx = torch.where(perm < n_items, perm, -1).reshape(L, per)
    return Partition(idx, idx >= 0)


def repartition_rows(rows: torch.Tensor, mask: torch.Tensor, plan, t: int,
                     L: int, cap: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Between-round repartition: the valid rows, compacted to the front in
    index order by a stable sort, land on slot ``perm[j]`` of an
    ``(L, cap, d)`` buffer; every other slot is zero and masked.  Requires
    L·cap ≥ Σmask (the driver's choice of L guarantees it)."""
    N, d = rows.shape
    n_slots = L * cap
    order = torch.argsort((~mask).to(torch.uint8), stable=True)
    rows_c, mask_c = rows[order], mask[order]
    if n_slots >= N:
        rows_c = torch.nn.functional.pad(rows_c, (0, 0, 0, n_slots - N))
        mask_c = torch.nn.functional.pad(mask_c, (0, n_slots - N))
    else:
        rows_c, mask_c = rows_c[:n_slots], mask_c[:n_slots]
    perm = plan.slot_permutation(t, n_slots).to(rows.device)
    buf = torch.zeros((n_slots, d), dtype=rows.dtype, device=rows.device)
    buf[perm] = torch.where(mask_c[:, None], rows_c, 0.0)
    bmask = torch.zeros((n_slots,), dtype=torch.bool, device=rows.device)
    bmask[perm] = mask_c
    return buf.reshape(L, cap, d), bmask.reshape(L, cap)


def gather_partition(data: torch.Tensor, part: Partition
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Materialise (L, cap, d) item blocks from a (n, d) dataset."""
    blocks = data[torch.clamp_min(part.idx, 0)]
    blocks = torch.where(part.mask[..., None], blocks, 0.0)
    return blocks, part.mask
