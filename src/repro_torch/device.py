"""Where an entry point runs: the card unless the caller asks for the CPU."""
from __future__ import annotations

import torch


def resolve_device(device: torch.device | str | None = "cuda") -> torch.device:
    """``None`` and ``"cuda"`` mean the card; with no card that raises
    instead of running on the CPU.  Pass ``device="cpu"`` for the plain
    versions."""
    dev = torch.device("cuda" if device is None else device)
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
