"""Active set selection for sparse GP inference (paper §4.2, Fig 2a/c;
counterpart of ``examples/active_set_selection.py``).

    PYTHONPATH=src python -m repro_torch.examples.active_set_selection

Maximizes the information gain f(S) = 1/2 logdet(I + σ⁻²K_SS) with an RBF
kernel (h=0.5, σ=1) under hereditary constraints: plain cardinality AND a
knapsack budget (Thm 3.5 — the framework keeps its α/r guarantee).
"""
import numpy as np
import torch

from repro_torch.core import (ActiveSetSelection, Knapsack, TreeConfig,
                              centralized_greedy, greedy, tree_maximize)
from repro_torch.data import datasets
from repro_torch.device import as_tensor, resolve_device
from repro_torch.examples import device_arg


def main(device="cuda", *, plan=None) -> dict:
    """``plan``: the TREE's round plan (default ``TorchPlan(0)``, as
    ``tree_maximize`` draws it; the tests give the JAX example's draws)."""
    dev = resolve_device(device)
    data = (datasets.parkinsons(n=3_000) * 0.5).astype(np.float32)
    k = 25
    obj = ActiveSetSelection(k_max=k, device=dev)
    dj = as_tensor(data, dev)

    # --- distributed TREE under tight capacity ----------------------------
    tree = tree_maximize(obj, dj, TreeConfig(k=k, capacity=100, seed=0),
                         device=dev, plan=plan)
    cent = centralized_greedy(obj, dj, k, device=dev)
    print(f"info gain: TREE={tree.value:.4f} vs centralized="
          f"{float(cent.value):.4f} ({tree.value / float(cent.value):.2%})")

    # --- hereditary constraint: knapsack on acquisition cost --------------
    costs_np = np.random.default_rng(0).uniform(
        0.5, 2.0, len(data)).astype(np.float32)[:, None]
    costs = as_tensor(costs_np, dev)
    res = greedy(obj, dj, torch.ones((len(data),), dtype=torch.bool,
                                     device=dev), k,
                 constraint=Knapsack(budget=10.0), attrs=costs)
    sel_idx = res.sel_idx.cpu().numpy()
    sel = sel_idx[res.sel_mask.cpu().numpy()]
    cost = float(costs_np[sel].sum())
    print(f"knapsack-greedy: f={float(res.value):.4f}, "
          f"|S|={len(sel)}, cost={cost:.2f} ≤ 10.0")
    return {"tree": tree, "centralized": float(cent.value),
            "knapsack_value": float(res.value), "knapsack_cost": cost,
            "knapsack_size": len(sel)}


if __name__ == "__main__":
    main(device_arg())
