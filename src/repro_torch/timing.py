"""Device time on the card, shared by ``chip_smoke.py`` and the A/B scripts
(``ab_round0.py``, ``ab_attention.py``, ``ab_kernels.py``).

:func:`device_times` times calls with CUDA events, each call queued behind
a device sleep so that the host's launch overhead falls outside the event
window: the time is the device's.  :func:`kernel_trace` reads
``torch.profiler``'s device time per kernel name.  :func:`card` is the
card's name and power limit as ``nvidia-smi`` gives them.

The A/B scripts import this file as a top-level module, from their own
directory, before they put the package under ``--src`` first on the path:
a parent checkout is timed by the same code as the change.
"""
from __future__ import annotations

import statistics
import subprocess


def device_times(fn, runs: int, warmup: int = 1) -> list[float]:
    """Milliseconds of each of ``runs`` calls of ``fn`` after ``warmup``
    untimed ones."""
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        torch.cuda._sleep(2_000_000)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return times


def device_ms(fn, runs: int, warmup: int = 1) -> float:
    """The median of :func:`device_times`."""
    return statistics.median(device_times(fn, runs, warmup))


def kernel_trace(fn, runs: int) -> dict:
    """Launches and device microseconds per launch of each kernel name over
    ``runs`` calls of ``fn`` (the device's events only: the host ops that
    launched them carry the same device time and are left out)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
    kernels = {}
    for e in prof.key_averages():
        dev = getattr(e, "self_device_time_total",
                      getattr(e, "self_cuda_time_total", 0))
        if dev > 0 and e.count and e.device_type != DeviceType.CPU:
            kernels[e.key] = {"count": e.count,
                              "us_per_launch": dev / e.count}
    return kernels


def card() -> str:
    """``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
