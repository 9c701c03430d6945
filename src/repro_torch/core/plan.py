"""Round plans: where each round's random slot permutation comes from.

The JAX package draws every partition from threefry keys
(``partition.py``, ``tree.py``); a torch generator cannot reproduce those
bits.  So the port's partitioning takes its permutations from a *plan*:

    perm = plan.slot_permutation(t, n_slots)   # LongTensor on the CPU
    keys = plan.feistel_keys(t)                # Feistel round keys
    idx = plan.eval_indices(n, m)              # select_coreset's eval rows

* :class:`TorchPlan` draws them from an explicit ``torch.Generator`` seeded
  per round from ``(seed, t)`` — the default of native runs.
* :class:`ArrayPlan` replays given arrays — the parity tests build one from
  the JAX package's keys, so both packages partition identically.

GREEDY takes no per-machine key, so on the greedy path the slot
permutations (or round 0's Feistel keys) are the whole plan.
"""
from __future__ import annotations

from typing import Protocol, Sequence

import numpy as np
import torch


class Plan(Protocol):
    def slot_permutation(self, t: int, n_slots: int) -> torch.Tensor: ...

    def feistel_keys(self, t: int, rounds: int = 4) -> tuple[int, ...]: ...

#: the Feistel round keys are drawn in [0, 2³¹ − 1), as the JAX package
#: draws them (``randint(key, (rounds,), 0, int32 max)``)
KEY_HIGH = 2 ** 31 - 1


class TorchPlan:
    """Uniform slot permutations from a CPU ``torch.Generator`` seeded with
    ``seed`` and the round index (the same bits on any device)."""

    def __init__(self, seed: int = 0):
        self.seed = int(seed)

    def _gen(self, t: int, stream: int = 0) -> torch.Generator:
        return torch.Generator().manual_seed(
            (self.seed * 1_000_003 + int(t) + stream * 7_919) % (2 ** 63))

    def slot_permutation(self, t: int, n_slots: int) -> torch.Tensor:
        return torch.randperm(n_slots, generator=self._gen(t))

    def feistel_keys(self, t: int, rounds: int = 4) -> tuple[int, ...]:
        return tuple(int(v) for v in torch.randint(
            0, KEY_HIGH, (rounds,), generator=self._gen(t, stream=1)))

    def eval_indices(self, n: int, m: int) -> np.ndarray:
        """``min(m, n)`` distinct indices of [0, n), uniform."""
        g = torch.Generator().manual_seed((self.seed * 1_000_003 + 104_729)
                                          % (2 ** 63))
        return torch.randperm(n, generator=g)[:min(m, n)].numpy()


class ArrayPlan:
    """Replays one given permutation per round (``perms[t]``), and where
    given the Feistel round keys per round (``feistel[t]``) and the eval
    indices (``eval_idx``)."""

    def __init__(self, perms: Sequence[np.ndarray],
                 feistel: Sequence[Sequence[int]] | None = None,
                 eval_idx: np.ndarray | None = None):
        self.perms = [np.asarray(p, dtype=np.int64) for p in perms]
        self.feistel = None if feistel is None else [
            tuple(int(v) for v in keys) for keys in feistel]
        self.eval_idx = (None if eval_idx is None
                         else np.asarray(eval_idx, np.int64))

    def feistel_keys(self, t: int, rounds: int = 4) -> tuple[int, ...]:
        if self.feistel is None or t >= len(self.feistel):
            raise IndexError(f"plan holds no Feistel keys of round {t}")
        keys = self.feistel[t]
        if len(keys) != rounds:
            raise ValueError(f"round {t}: {len(keys)} keys, {rounds} asked")
        return keys

    def eval_indices(self, n: int, m: int) -> np.ndarray:
        if self.eval_idx is None or len(self.eval_idx) != min(m, n):
            raise ValueError(f"plan holds no {min(m, n)} eval indices")
        return self.eval_idx

    def slot_permutation(self, t: int, n_slots: int) -> torch.Tensor:
        if t >= len(self.perms):
            raise IndexError(f"plan holds {len(self.perms)} rounds, "
                             f"round {t} asked for")
        perm = self.perms[t]
        if perm.shape != (n_slots,):
            raise ValueError(f"round {t}: plan permutes {perm.shape[0]} "
                             f"slots, the partition has {n_slots}")
        return torch.from_numpy(perm.copy())
