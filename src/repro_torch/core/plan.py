"""Round plans: where each round's random slot permutation comes from.

The JAX package draws every partition from threefry keys
(``partition.py``, ``tree.py``); a torch generator cannot reproduce those
bits.  So the port's partitioning takes its permutations from a *plan*:

    perm = plan.slot_permutation(t, n_slots)   # LongTensor on the CPU
    keys = plan.feistel_keys(t)                # Feistel round keys
    idx = plan.eval_indices(n, m)              # select_coreset's eval rows
    u = plan.stochastic_scores(t, m0, m1, j, cap, device)  # (m1 − m0, cap)
    u = plan.stochastic_rows(t, machines, j, cap, device)  # (len, cap)

* :class:`TorchPlan` draws them from an explicit ``torch.Generator`` seeded
  per round from ``(seed, t)`` — the default of native runs — and the
  stochastic-greedy scores from a counter-based hash.
* :class:`ArrayPlan` replays given arrays — the parity tests build one from
  the JAX package's keys, so both packages partition identically.

GREEDY and the threshold algorithms take no per-machine key, so on their
paths the slot permutations (or round 0's Feistel keys) are the whole
plan.  ``stochastic_greedy`` draws, at step j of round t, one uniform score
per slot of each machine (the JAX package's ``uniform(key_j, (cap,))``
from keys split per machine); ``stochastic_scores`` gives them for
machines [m0, m1), so a wave of machines asks for its own rows only;
``stochastic_rows`` for any machine indices (a partial re-solve of the
serve layer takes scattered machines, each with its own draws).
"""
from __future__ import annotations

from typing import Callable, Protocol, Sequence

import numpy as np
import torch


class Plan(Protocol):
    def slot_permutation(self, t: int, n_slots: int) -> torch.Tensor: ...

    def feistel_keys(self, t: int, rounds: int = 4) -> tuple[int, ...]: ...

    def stochastic_scores(self, t: int, m0: int, m1: int, j: int, cap: int,
                          device) -> torch.Tensor: ...

    def stochastic_rows(self, t: int, machines: torch.Tensor, j: int,
                        cap: int, device) -> torch.Tensor: ...


def round_draws(plan, t: int, m0: int, m1: int, cap: int, device
                ) -> Callable[[int], torch.Tensor]:
    """``stochastic_greedy``'s ``key`` for machines [m0, m1) of round t:
    step j → the ``(m1 − m0, cap)`` fp32 scores on ``device``."""
    return lambda j: plan.stochastic_scores(t, m0, m1, j, cap, device)


def machine_draws(plan, t: int, machines: torch.Tensor, cap: int, device
                  ) -> Callable[[int], torch.Tensor]:
    """:func:`round_draws` for the machines of round t whose indices
    ``machines`` gives, in its order: each machine's own draws."""
    return lambda j: plan.stochastic_rows(t, machines, j, cap, device)


_M32 = 0xFFFFFFFF


def _mul32(x, c: int):
    """``x · c mod 2³²`` for uint32 values held in int64 (a Python int or a
    tensor): the product is split at bit 16, so no partial product passes
    2⁴⁸ and nothing overflows."""
    return ((x & 0xFFFF) * c + ((((x >> 16) * c) & 0xFFFF) << 16)) & _M32


def _fmix32(x):
    """MurmurHash3's 32-bit finalizer, a bijection of uint32 (a Python int
    or an int64 tensor)."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    return x ^ (x >> 16)

#: the Feistel round keys are drawn in [0, 2³¹ − 1), as the JAX package
#: draws them (``randint(key, (rounds,), 0, int32 max)``)
KEY_HIGH = 2 ** 31 - 1


class TorchPlan:
    """Uniform slot permutations from a CPU ``torch.Generator`` seeded with
    ``seed`` and the round index, and stochastic-greedy scores from an
    integer hash evaluated where they are used: the same bits on any
    device."""

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

    def stochastic_scores(self, t: int, m0: int, m1: int, j: int, cap: int,
                          device) -> torch.Tensor:
        """Step j's uniform scores in [0, 1) of machines [m0, m1) of round
        t: a counter-based hash of (seed, t, machine, j, slot), evaluated
        with int64 tensor ops on ``device``, its top 23 bits scaled by
        2⁻²³ (exact in fp32, the JAX draw's resolution).  The same bits on
        any device, and a machine's row does not depend on which machines
        share the call (a wave's width cannot change a result)."""
        return self.stochastic_rows(
            t, torch.arange(m0, m1, dtype=torch.int64, device=device), j,
            cap, device)

    def stochastic_rows(self, t: int, machines: torch.Tensor, j: int,
                        cap: int, device) -> torch.Tensor:
        """:meth:`stochastic_scores` of the machines ``machines`` (an int64
        tensor; no host read, so a captured solve may take them)."""
        seed = self.seed & ((1 << 64) - 1)
        key = _fmix32(_fmix32(_fmix32((seed & _M32) ^ 0x5BD1E995)
                              ^ (seed >> 32)) ^ (int(t) & _M32))
        key = _fmix32(key ^ _mul32(int(j) + 1, 0x9E3779B1))
        mach = machines.to(device=device, dtype=torch.int64)[:, None]
        slot = torch.arange(cap, dtype=torch.int64, device=device)[None, :]
        h = _fmix32(key ^ _mul32(mach & _M32, 0x27D4EB2F))
        h = _fmix32(h ^ _mul32(slot, 0x165667B1))
        return (h >> 9).to(torch.float32) * (2.0 ** -23)

    def eval_indices(self, n: int, m: int) -> np.ndarray:
        """``min(m, n)`` distinct indices of [0, n), uniform."""
        g = torch.Generator().manual_seed((self.seed * 1_000_003 + 104_729)
                                          % (2 ** 63))
        return torch.randperm(n, generator=g)[:min(m, n)].numpy()


class ArrayPlan:
    """Replays one given permutation per round (``perms[t]``), and where
    given the Feistel round keys per round (``feistel[t]``), the eval
    indices (``eval_idx``) and the stochastic-greedy scores per round
    (``stochastic[t]``, ``(machines, k, cap)`` fp32: what the JAX package
    draws, M·k·μ floats a round, so a replay is for parity shapes only)."""

    def __init__(self, perms: Sequence[np.ndarray],
                 feistel: Sequence[Sequence[int]] | None = None,
                 eval_idx: np.ndarray | None = None,
                 stochastic: Sequence[np.ndarray] | None = None):
        self.perms = [np.asarray(p, dtype=np.int64) for p in perms]
        self.feistel = None if feistel is None else [
            tuple(int(v) for v in keys) for keys in feistel]
        self.eval_idx = (None if eval_idx is None
                         else np.asarray(eval_idx, np.int64))
        self.stochastic = None if stochastic is None else [
            np.asarray(u, np.float32) for u in stochastic]

    def stochastic_scores(self, t: int, m0: int, m1: int, j: int, cap: int,
                          device) -> torch.Tensor:
        if self.stochastic is None or t >= len(self.stochastic):
            raise IndexError(f"plan holds no stochastic scores of round {t}")
        u = self.stochastic[t]
        if u.ndim != 3 or m1 > u.shape[0] or j >= u.shape[1] \
                or u.shape[2] != cap:
            raise ValueError(f"round {t}: scores {u.shape}, asked machines "
                             f"[{m0}, {m1}), step {j}, cap {cap}")
        return torch.from_numpy(u[m0:m1, j].copy()).to(device)

    def stochastic_rows(self, t: int, machines: torch.Tensor, j: int,
                        cap: int, device) -> torch.Tensor:
        idx = machines.cpu().numpy()
        hi = int(idx.max()) + 1 if idx.size else 0
        self.stochastic_scores(t, 0, hi, j, cap, device)   # the checks
        return torch.from_numpy(self.stochastic[t][idx, j].copy()).to(device)

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
