"""Carry state across from the JAX package's arrays into the port.

The port imports nothing of ``repro``; the parity tests build the
reference's arrays there (eval set, per-round slot permutations replayed
from its threefry keys) and hand them over as NumPy through these, so both
packages compute the same thing.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.objectives import ExemplarClustering
from repro_torch.core.plan import ArrayPlan
from repro_torch.device import as_tensor, resolve_device

__all__ = ["ArrayPlan", "objective_from_numpy"]


def objective_from_numpy(eval_set: np.ndarray, device="cuda"
                         ) -> ExemplarClustering:
    """The port's ``ExemplarClustering`` over a NumPy eval set."""
    return ExemplarClustering(as_tensor(eval_set, resolve_device(device)))
