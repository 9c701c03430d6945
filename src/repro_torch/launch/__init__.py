"""repro_torch.launch — the port's entry points (counterpart of
``repro.launch``): the ``submod`` CLI (``python -m
repro_torch.launch.submod``), the trace inspector (``python -m
repro_torch.launch.tracetool``), the LM training launcher (``python -m
repro_torch.launch.train``) and the one-card dry run and roofline
(``python -m repro_torch.launch.dryrun``, ``python -m
repro_torch.launch.roofline``; ``specs`` and ``op_analyzer`` behind
them)."""
