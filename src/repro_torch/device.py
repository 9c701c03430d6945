"""Where an entry point runs: the card unless the caller asks for the CPU."""
from __future__ import annotations

import contextlib
import threading

import torch

_dry = threading.local()


@contextlib.contextmanager
def dry_card():
    """Inside, the card is the dry run's ``meta`` device: tensors of shape,
    type and strides without data, on which every kernel wrapper takes its
    dry branch (``repro_torch.launch.op_analyzer``).  No card is needed."""
    before = getattr(_dry, "on", False)
    _dry.on = True
    try:
        yield
    finally:
        _dry.on = before


def resolve_device(device: torch.device | str | None = "cuda") -> torch.device:
    """``None`` and ``"cuda"`` mean the card; with no card that raises
    instead of running on the CPU.  Pass ``device="cpu"`` for the plain
    versions.  Inside :func:`dry_card` the card is ``meta``."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and getattr(_dry, "on", False) or dev.type == "meta":
        return torch.device("meta")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run the plain PyTorch versions on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise RuntimeError(f"unsupported device {dev}")
    if dev.type == "cuda" and dev.index is None:
        # the index tensors report, so device checks compare like with like
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def as_tensor(x, device: torch.device) -> torch.Tensor:
    """fp32 tensor on ``device`` (numpy arrays and tensors alike)."""
    return torch.as_tensor(x, dtype=torch.float32, device=device)
