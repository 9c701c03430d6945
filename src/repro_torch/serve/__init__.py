"""repro_torch.serve — LM decode serving (:mod:`serve_step`).  Selection
serving (the resident-tree query server of ``repro.serve``) is ROADMAP
queue 1 item 12."""
from repro_torch.serve.serve_step import greedy_generate, make_serve_fns

__all__ = ["make_serve_fns", "greedy_generate"]
