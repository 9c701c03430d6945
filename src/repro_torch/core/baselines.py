"""Baselines the paper compares against (§4.3), resident arrays only
(counterpart of ``repro.core.baselines``): centralized GREEDY and
RANDOM-k.  The streaming centralized pass waits for ROADMAP queue 1 item
10; RandGreedI stays open under item 6.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import algorithms
from repro_torch.device import as_tensor, resolve_device


class BaselineResult(NamedTuple):
    sel_rows: torch.Tensor
    sel_mask: torch.Tensor
    value: torch.Tensor


def centralized_greedy(obj, data, k: int, *, device="cuda") -> BaselineResult:
    """GREEDY on the full ground set (μ ≥ n regime; 1 − 1/e): one machine
    whose block is all n rows.  Runs on the card unless ``device="cpu"``."""
    dev = resolve_device(device)
    if obj.device != dev:
        raise ValueError(f"objective lives on {obj.device}, run asks {dev}")
    data = as_tensor(data, dev)
    n = data.shape[0]
    res = algorithms.greedy(obj, data,
                            torch.ones((n,), dtype=torch.bool, device=dev), k)
    safe = torch.clamp_min(res.sel_idx, 0)
    rows = torch.where(res.sel_mask[:, None], data[safe], 0.0)
    return BaselineResult(rows, res.sel_mask, res.value)


def random_subset(obj, data, k: int, generator: torch.Generator
                  ) -> BaselineResult:
    """k distinct rows drawn uniformly with ``generator`` (a CPU generator),
    scored where ``obj`` lives."""
    data = as_tensor(data, obj.device)
    idx = torch.randperm(data.shape[0], generator=generator)[:k]
    rows = data[idx.to(obj.device)]
    mask = torch.ones((k,), dtype=torch.bool, device=obj.device)
    return BaselineResult(rows, mask, obj.evaluate(rows, mask))
