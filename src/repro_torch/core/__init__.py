"""repro_torch.core — tree-based compression over a resident ground set or
a streamed one (waves under a byte budget, fp32, bf16 or int8 rows), with
GREEDY, STOCHASTIC-GREEDY, THRESHOLD-GREEDY or THRESHOLD-BATCH on each
machine, under hereditary constraints, for every objective of the paper
(§4.2) and the package's extra ones; the baselines, RandGreedI among
them; and the NumPy reference oracles."""
from repro_torch.core.algorithms import (SelectResult, greedy, run_algorithm,
                                         stochastic_greedy, threshold_batch,
                                         threshold_greedy)
from repro_torch.core.baselines import (BaselineResult, centralized_greedy,
                                        fp32_recheck_value, random_subset,
                                        randgreedi,
                                        streaming_centralized_greedy)
from repro_torch.core.constraints import (DynamicKnapsack,
                                          DynamicPartitionMatroid,
                                          Intersection, Knapsack,
                                          PartitionMatroid, Unconstrained,
                                          attr_dim, check_feasible,
                                          constraint_from_spec, from_spec)
from repro_torch.core.distributed import RoundResult, run_round
from repro_torch.core.objectives import (ActiveSetSelection,
                                         ExemplarClustering, FacilityLocation,
                                         WeightedCoverage,
                                         WeightedExemplarClustering)
from repro_torch.core.partition import (balanced_partition, gather_partition,
                                        n_parts, repartition_rows)
from repro_torch.core.permute import FeistelPermutation, feistel_slot_items
from repro_torch.core.plan import ArrayPlan, TorchPlan, round_draws
from repro_torch.core.sources import (STORAGE_DTYPES, ArraySource,
                                      ChunkedSource, GroundSetSource,
                                      HostLostError,
                                      QuantizedSource, SlicedSource,
                                      as_source, dtype_itemsize,
                                      prefetch_chunks)
from repro_torch.core.tree import (IngestStats, TreeConfig, TreeResult,
                                   tree_maximize)

__all__ = [
    "SelectResult", "greedy", "run_algorithm", "stochastic_greedy",
    "threshold_batch", "threshold_greedy",
    "BaselineResult", "centralized_greedy", "fp32_recheck_value",
    "random_subset", "randgreedi", "streaming_centralized_greedy",
    "DynamicKnapsack", "DynamicPartitionMatroid",
    "Intersection", "Knapsack", "PartitionMatroid", "Unconstrained",
    "attr_dim", "check_feasible", "constraint_from_spec", "from_spec",
    "RoundResult", "run_round", "ActiveSetSelection", "ExemplarClustering",
    "FacilityLocation", "WeightedCoverage", "WeightedExemplarClustering",
    "balanced_partition", "gather_partition", "n_parts", "repartition_rows",
    "FeistelPermutation", "feistel_slot_items", "ArrayPlan", "TorchPlan",
    "round_draws",
    "STORAGE_DTYPES", "ArraySource", "ChunkedSource", "GroundSetSource",
    "HostLostError",
    "QuantizedSource", "SlicedSource", "as_source", "dtype_itemsize",
    "prefetch_chunks", "IngestStats", "TreeConfig", "TreeResult",
    "tree_maximize",
]
