"""Counter-based Feistel slot permutation — O(1) state for unbounded n
(counterpart of ``repro.core.permute``).

A streaming round 0 gives every item a (machine, slot) virtual location
through a random permutation of the ``L·μ`` slots.  The dense scheme
materializes that permutation, O(n) host memory.  This module evaluates a
keyed bijection over ``[0, n_slots)`` on any slice instead, from a few
32-bit round keys: a balanced Feistel network over two b-bit halves (the
smallest b with ``4^b ≥ n_slots``) with a xorshift-style round function,
and cycle-walking back into the domain (``4^b < 4·n_slots``, so fewer than
four encryptions are expected).

The round keys come from the round plan (``plan.feistel_keys(t)``), not
from a JAX key: :class:`repro_torch.core.plan.ArrayPlan` replays the JAX
package's keys, so both packages permute identically.
"""
from __future__ import annotations

import dataclasses

import numpy as np

_MASK32 = np.uint32(0xFFFFFFFF)


def _round_fn(r: np.ndarray, key: np.uint32, half_bits: int) -> np.ndarray:
    """Keyed integer mix of the right half (vectorized, uint32)."""
    x = (r * np.uint32(0x9E3779B1) + key) & _MASK32
    x ^= x >> np.uint32(15)
    x = (x * np.uint32(0x85EBCA77)) & _MASK32
    x ^= x >> np.uint32(13)
    return x & np.uint32((1 << half_bits) - 1)


@dataclasses.dataclass(frozen=True)
class FeistelPermutation:
    """Keyed bijection over ``[0, n)`` with O(rounds) state; ``perm(idx)``
    evaluates it at host int indices of any shape."""

    n: int
    round_keys: tuple[int, ...]      # uint32 per Feistel round
    half_bits: int                   # b: each half is b bits, domain 4^b

    @classmethod
    def from_keys(cls, keys, n: int) -> "FeistelPermutation":
        """The permutation of ``[0, n)`` under round keys ``keys``."""
        if not 1 <= n <= (1 << 32):
            raise ValueError(f"n={n}: uint32 halves cover domains to 2^32")
        half_bits = 1
        while (1 << (2 * half_bits)) < n:
            half_bits += 1
        return cls(n=int(n), round_keys=tuple(int(k) for k in keys),
                   half_bits=half_bits)

    def _encrypt(self, x: np.ndarray) -> np.ndarray:
        hb = self.half_bits
        mask = np.uint32((1 << hb) - 1)
        left = (x >> np.uint32(hb)) & mask
        right = x & mask
        for rk in self.round_keys:
            left, right = right, left ^ _round_fn(right, np.uint32(rk), hb)
        return (left << np.uint32(hb)) | right

    def __call__(self, idx) -> np.ndarray:
        """Permutation values at ``idx`` ⊂ [0, n) (vectorized)."""
        idx = np.asarray(idx)
        flat = idx.reshape(-1)
        if flat.size and (flat.min() < 0 or flat.max() >= self.n):
            raise ValueError("indices outside the permutation domain")
        y = self._encrypt(flat.astype(np.uint32))
        for _ in range(128):        # cycle-walk: a geometric tail
            out = y >= self.n
            if not out.any():
                break
            y[out] = self._encrypt(y[out])
        else:  # pragma: no cover - probability ~ (3/4)^128
            raise RuntimeError("Feistel cycle-walk failed to terminate")
        return y.astype(np.int64).reshape(idx.shape)

    def materialize(self) -> np.ndarray:
        """The full (n,) permutation — the resident path and tests."""
        return self(np.arange(self.n, dtype=np.int64))


def feistel_slot_items(perm: FeistelPermutation, n_items: int,
                       slots: np.ndarray) -> np.ndarray:
    """Item index per slot for a slice of slots, −1 on empty slots (the
    dense partition's ``where(perm < n_items, perm, −1)``)."""
    vals = perm(slots)
    return np.where(vals < n_items, vals, -1).astype(np.int64)
