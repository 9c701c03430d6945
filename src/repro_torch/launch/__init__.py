"""repro_torch.launch — the port's entry points (counterpart of
``repro.launch``): the ``submod`` CLI (``python -m
repro_torch.launch.submod``) and the trace inspector (``python -m
repro_torch.launch.tracetool``)."""
