"""Carry state across from the JAX package's arrays into the port.

The port imports nothing of ``repro``; the parity tests build the
reference's arrays there (eval set, per-round slot permutations replayed
from its threefry keys) and hand them over as NumPy through these, so both
packages compute the same thing.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core import constraints as cons
from repro_torch.core.objectives import ExemplarClustering
from repro_torch.core.plan import ArrayPlan
from repro_torch.device import as_tensor, resolve_device

__all__ = ["ArrayPlan", "constraint_from_jax", "objective_from_numpy"]


def objective_from_numpy(eval_set: np.ndarray, device="cuda"
                         ) -> ExemplarClustering:
    """The port's ``ExemplarClustering`` over a NumPy eval set."""
    return ExemplarClustering(as_tensor(eval_set, resolve_device(device)))


def constraint_from_jax(c):
    """The port's counterpart of a ``repro.core.constraints`` object (or
    ``None``), read by class name and fields, so nothing of ``repro`` is
    imported here."""
    if c is None:
        return None
    name = type(c).__name__
    if name == "Unconstrained":
        return cons.Unconstrained()
    if name == "Knapsack":
        return cons.Knapsack(budget=float(c.budget), col=int(c.col))
    if name == "PartitionMatroid":
        return cons.PartitionMatroid(caps=tuple(int(v) for v in c.caps),
                                     col=int(c.col))
    if name == "Intersection":
        return cons.Intersection(tuple(constraint_from_jax(p)
                                       for p in c.parts))
    raise ValueError(f"no port of constraint class {name!r} yet "
                     "(Dynamic* classes: ROADMAP queue 1 item 12)")
