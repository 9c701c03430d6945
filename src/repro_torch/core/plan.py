"""Round plans: where each round's random slot permutation comes from.

The JAX package draws every partition from threefry keys
(``partition.py``, ``tree.py``); a torch generator cannot reproduce those
bits.  So the port's partitioning takes its permutations from a *plan*:

    perm = plan.slot_permutation(t, n_slots)   # LongTensor on the CPU

* :class:`TorchPlan` draws them from an explicit ``torch.Generator`` seeded
  per round from ``(seed, t)`` — the default of native runs.
* :class:`ArrayPlan` replays given arrays — the parity tests build one from
  the JAX package's keys, so both packages partition identically.

GREEDY takes no per-machine key, so on the greedy path the slot
permutations are the whole plan.
"""
from __future__ import annotations

from typing import Protocol, Sequence

import numpy as np
import torch


class Plan(Protocol):
    def slot_permutation(self, t: int, n_slots: int) -> torch.Tensor: ...


class TorchPlan:
    """Uniform slot permutations from a CPU ``torch.Generator`` seeded with
    ``seed`` and the round index (the same bits on any device)."""

    def __init__(self, seed: int = 0):
        self.seed = int(seed)

    def slot_permutation(self, t: int, n_slots: int) -> torch.Tensor:
        g = torch.Generator().manual_seed(
            (self.seed * 1_000_003 + int(t)) % (2 ** 63))
        return torch.randperm(n_slots, generator=g)


class ArrayPlan:
    """Replays one given permutation per round (``perms[t]``)."""

    def __init__(self, perms: Sequence[np.ndarray]):
        self.perms = [np.asarray(p, dtype=np.int64) for p in perms]

    def slot_permutation(self, t: int, n_slots: int) -> torch.Tensor:
        if t >= len(self.perms):
            raise IndexError(f"plan holds {len(self.perms)} rounds, "
                             f"round {t} asked for")
        perm = self.perms[t]
        if perm.shape != (n_slots,):
            raise ValueError(f"round {t}: plan permutes {perm.shape[0]} "
                             f"slots, the partition has {n_slots}")
        return torch.from_numpy(perm.copy())
