"""repro_torch.examples — the JAX package's examples on the port, each a
module with ``main(device="cuda")``:

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
    PYTHONPATH=src python -m repro_torch.examples.distributed_tree
    PYTHONPATH=src python -m repro_torch.examples.active_set_selection
    PYTHONPATH=src python -m repro_torch.examples.train_lm_with_selection

The same data, k and μ as ``examples/*.py``, the same printed lines; a
run uses one device (the card unless ``--device cpu``).
"""
import argparse


def device_arg(argv=None) -> str:
    """The ``--device cuda|cpu`` flag of an example's command line."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    return ap.parse_args(argv).device
