"""Quickstart: horizontally scalable submodular maximization in 30 lines
(counterpart of ``examples/quickstart.py``).

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]

Selects k=20 exemplars from a 10k-point clustered dataset under a machine
capacity of only 2k items — the regime where classic two-round distributed
algorithms (GreeDi/RandGreedI, which need capacity ≥ √(nk) ≈ 450) break
down — and compares against centralized greedy and a random subset.
"""
import torch

from repro_torch.core import (ExemplarClustering, TreeConfig,
                              centralized_greedy, random_subset,
                              tree_maximize)
from repro_torch.data import datasets
from repro_torch.device import as_tensor, resolve_device
from repro_torch.examples import device_arg


def main(device="cuda", *, plan=None) -> dict:
    """``plan``: the TREE's round plan (default ``TorchPlan(0)``, as
    ``tree_maximize`` draws it; the tests give the JAX example's draws)."""
    dev = resolve_device(device)
    data = datasets.csn(n=10_000, d=17)
    k = 20

    # exemplar objective over a Chernoff-bounded eval subsample (paper §4.2)
    obj = ExemplarClustering(as_tensor(data[:512], dev))
    dj = as_tensor(data, dev)

    tree = tree_maximize(obj, dj, TreeConfig(k=k, capacity=2 * k, seed=0),
                         device=dev, plan=plan)
    cent = centralized_greedy(obj, dj, k, device=dev)
    rand = random_subset(obj, dj, k, torch.Generator().manual_seed(0))

    print(f"centralized greedy : {float(cent.value):.5f}")
    print(f"TREE (capacity 2k) : {tree.value:.5f}  "
          f"({tree.value / float(cent.value):.2%} of centralized, "
          f"{tree.rounds} rounds, machines/round={tree.machines_per_round})")
    print(f"random subset      : {float(rand.value):.5f}  "
          f"({float(rand.value) / float(cent.value):.2%})")
    return {"tree": tree, "centralized": float(cent.value),
            "random": float(rand.value)}


if __name__ == "__main__":
    main(device_arg())
