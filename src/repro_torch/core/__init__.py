"""repro_torch.core — tree-based compression with GREEDY on each machine,
on a resident ground set (the port's first slice)."""
from repro_torch.core.algorithms import SelectResult, greedy, run_algorithm
from repro_torch.core.baselines import (BaselineResult, centralized_greedy,
                                        random_subset)
from repro_torch.core.constraints import Unconstrained
from repro_torch.core.distributed import RoundResult, run_round
from repro_torch.core.objectives import ExemplarClustering
from repro_torch.core.partition import (balanced_partition, gather_partition,
                                        n_parts, repartition_rows)
from repro_torch.core.plan import ArrayPlan, TorchPlan
from repro_torch.core.tree import TreeConfig, TreeResult, tree_maximize

__all__ = [
    "SelectResult", "greedy", "run_algorithm",
    "BaselineResult", "centralized_greedy", "random_subset",
    "Unconstrained", "RoundResult", "run_round", "ExemplarClustering",
    "balanced_partition", "gather_partition", "n_parts", "repartition_rows",
    "ArrayPlan", "TorchPlan", "TreeConfig", "TreeResult", "tree_maximize",
]
