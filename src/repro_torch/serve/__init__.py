"""repro_torch.serve — two serving stacks that share only the package
(counterpart of ``repro.serve``).

Selection serving: a resident-tree query server over the paper's
submodular maximization — ingest once through the round-0 wave engine,
answer many ``(k, constraint, query)`` requests from device copies of the
resident machine blocks, per-request parameters as device operands,
CUDA-graph entries replayed per fuse key, incremental ground-set deltas.
Lives in :mod:`session` (resident state), :mod:`service` (request
solving) and :mod:`dispatcher` (threaded micro-batching).

LM decode serving: batched prefill/decode over the model registry
(:mod:`serve_step`).
"""
from repro_torch.serve.dispatcher import Dispatcher, serve_batch
from repro_torch.serve.serve_step import greedy_generate, make_serve_fns
from repro_torch.serve.service import (CompileCache, SelectionRequest,
                                       SelectionResult, SelectionService,
                                       build_constraint, constraint_params,
                                       constraint_signature, offline_solve,
                                       query_relevance_weights, round_ladder)
from repro_torch.serve.session import DeltaReport, SessionState, ingest

__all__ = [
    # selection serving
    "SessionState", "DeltaReport", "ingest",
    "SelectionService", "SelectionRequest", "SelectionResult",
    "CompileCache", "offline_solve", "query_relevance_weights",
    "round_ladder", "constraint_signature", "constraint_params",
    "build_constraint", "Dispatcher", "serve_batch",
    # LM decode serving
    "make_serve_fns", "greedy_generate",
]
