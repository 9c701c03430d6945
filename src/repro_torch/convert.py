"""Carry state across from the JAX package's arrays into the port.

The port imports nothing of ``repro``; the parity tests build the
reference's arrays there (eval set, per-round slot permutations replayed
from its threefry keys) and hand them over as NumPy through these, so both
packages compute the same thing.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core import constraints as cons
from repro_torch.core import objectives as objs
from repro_torch.core.plan import ArrayPlan
from repro_torch.device import as_tensor, resolve_device

__all__ = ["ArrayPlan", "constraint_from_jax", "objective_from_jax",
           "objective_from_numpy", "params_from_jax"]


def objective_from_numpy(eval_set: np.ndarray, device="cuda",
                         score_dtype: str | None = None
                         ) -> objs.ExemplarClustering:
    """The port's ``ExemplarClustering`` over a NumPy eval set."""
    return objs.ExemplarClustering(as_tensor(eval_set,
                                             resolve_device(device)),
                                   score_dtype=score_dtype)


def objective_from_jax(obj, device="cuda"):
    """The port's counterpart of a ``repro.core.objectives`` object on
    ``device``, read by class name and fields (arrays through NumPy), so
    nothing of ``repro`` is imported here."""
    dev = resolve_device(device)
    name = type(obj).__name__

    def arr(x):
        return as_tensor(np.array(x), dev)

    if name in ("ExemplarClustering", "WeightedExemplarClustering"):
        sd = getattr(obj, "score_dtype", None)
        if name == "ExemplarClustering":
            return objs.ExemplarClustering(arr(obj.eval_set), score_dtype=sd)
        return objs.WeightedExemplarClustering(
            arr(obj.eval_set), score_dtype=sd,
            eval_weights=arr(obj.eval_weights))
    if name == "ActiveSetSelection":
        return objs.ActiveSetSelection(k_max=int(obj.k_max), h=float(obj.h),
                                       sigma=float(obj.sigma), device=dev)
    if name == "FacilityLocation":
        return objs.FacilityLocation(arr(obj.eval_set), h=float(obj.h))
    if name == "WeightedCoverage":
        return objs.WeightedCoverage(arr(obj.weights))
    raise ValueError(f"no port of objective class {name!r}")


def constraint_from_jax(c, device="cuda"):
    """The port's counterpart of a ``repro.core.constraints`` object (or
    ``None``), read by class name and fields, so nothing of ``repro`` is
    imported here.  The ``Dynamic*`` classes' parameters become tensors on
    ``device`` (a ``()`` fp32 budget, ``(G,)`` int32 caps)."""
    if c is None:
        return None
    name = type(c).__name__
    if name == "DynamicKnapsack":
        import torch
        return cons.DynamicKnapsack(
            budget=torch.tensor(np.asarray(c.budget, np.float32),
                                device=resolve_device(device)),
            col=int(c.col))
    if name == "DynamicPartitionMatroid":
        import torch
        return cons.DynamicPartitionMatroid(
            caps=torch.tensor(np.asarray(c.caps).astype(np.int32),
                              device=resolve_device(device)),
            col=int(c.col))
    if name == "Unconstrained":
        return cons.Unconstrained()
    if name == "Knapsack":
        return cons.Knapsack(budget=float(c.budget), col=int(c.col))
    if name == "PartitionMatroid":
        return cons.PartitionMatroid(caps=tuple(int(v) for v in c.caps),
                                     col=int(c.col))
    if name == "Intersection":
        return cons.Intersection(tuple(constraint_from_jax(p, device)
                                       for p in c.parts))
    raise ValueError(f"no port of constraint class {name!r}")


def params_from_jax(params, cfg, device="cuda") -> dict:
    """The port's serving parameters of any family from the JAX
    ``init_params`` tree of its model (leaves read through ``np.asarray``):
    the stacks of every sub-tree (``attn``, ``mlp``, ``moe`` with its
    ``router``, ``experts``, ``ln`` and ``shared``; RWKV-6's ``blocks``;
    the hybrid's ``periods``, whose ``(P, n, ...)`` leaves are all
    stacks; the encoder-decoder's ``encoder`` and ``decoder`` with
    ``cross``) cast by ``layers.cast_stacks``, ``emb`` and ``head`` by
    ``layers.cast``, the other top-level leaves (norm scales, RWKV's
    ``w0``, ``enc_pos``) fp32 — what the JAX package casts at every call,
    cast once.  One leaf at a time, cast on the host before it moves."""
    import torch

    from repro_torch.models import layers
    dev = resolve_device(device)

    def leaf(x):
        return torch.from_numpy(np.array(np.asarray(x)))   # a writable copy

    out = {}
    for name, val in params.items():
        if isinstance(val, dict):
            out[name] = layers.tree_map(
                lambda x: layers.cast_stacks(leaf(x)).to(dev), val)
        elif name in ("emb", "head"):
            out[name] = layers.cast(leaf(val)).to(dev)
        else:
            out[name] = leaf(val).to(dev)
    return out
