"""repro_torch.launch — the port's entry points (counterpart of
``repro.launch``): the ``submod`` CLI (``python -m
repro_torch.launch.submod``), the trace inspector (``python -m
repro_torch.launch.tracetool``) and the LM training launcher (``python -m
repro_torch.launch.train``)."""
