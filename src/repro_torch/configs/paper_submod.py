"""The paper's own workload: one distributed TREE round for exemplar
clustering (the port's own copy of ``repro.configs.paper_submod``).

The production-scale cell beside the LM cells of the dry run and the
roofline: machines of capacity 65,536 items × d = 1,024 features, an eval
subsample of 8,192 rows, k = 256.  One card holds one machine's slab of
the round (``repro_torch.launch.dryrun.dryrun_submod``).
"""
import dataclasses


@dataclasses.dataclass(frozen=True)
class SubmodConfig:
    k: int = 256
    capacity: int = 65_536
    n_eval: int = 8_192
    d: int = 1_024
    algorithm: str = "greedy"


CONFIG = SubmodConfig()
