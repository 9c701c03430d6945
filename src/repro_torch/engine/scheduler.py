"""The synchronous wave scheduler of a streaming round 0 (counterpart of
the ``sync`` mode of ``repro.engine.scheduler``).

Round-0 ingestion is a sequence of waves; each wave is a host *gather*
(source reads and the NumPy assembly of its machine blocks), an *H2D*
staging of those buffers on the card, and a device *solve* (dispatch and
the best-solution fold).  This engine serializes the three per wave, in
wave order, and records each wave's seconds and bytes:

    g0 → h0 → s0 → g1 → h1 → s1 → ...        wall = Σ(g + h + s)

That is the bit-identity reference: ``solve`` sees exactly the buffers
``gather`` produced, in wave order, so the fold order and failure
injection are those of the resident round.  The stage and the solve end
in a device synchronize, so their host-clock seconds are the card's work
(the copy of a wave, its solve) and not the time to enqueue it.  The
pipelined mode (gather of wave t+1 beside the solve of wave t), ingestion
hosts, the autotuner, fault supervision, checkpoints and telemetry wait
for ROADMAP queue 1 item 11.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, NamedTuple

import torch


class HostWave(NamedTuple):
    """One gathered wave: host payload and accounting, made by ``gather``."""
    payload: Any                # opaque to the engine; ``stage`` takes it
    machines: int
    rows: int
    bytes_moved: int            # host → device bytes of the wave's buffers


@dataclasses.dataclass
class WaveTrace:
    """Accounting of one dispatched wave (host clock)."""
    wave: int                   # wave index (fold order)
    machines: int               # machine blocks in the wave (≤ W)
    rows: int                   # candidate rows materialized (machines · μ)
    bytes_moved: int            # host → device bytes of the wave
    gather_s: float             # host: source reads + block assembly
    h2d_s: float                # pinned staging + copy to the card (synced)
    solve_s: float              # dispatch + fold on the card (synced)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_waves(gather: Callable[[int], HostWave | None],
              stage: Callable[[Any], Any],
              solve: Callable[[int, Any], None],
              device: torch.device) -> list[WaveTrace]:
    """Drive gather → stage → solve per wave until ``gather(i)`` returns
    ``None``; returns the waves' traces in wave order."""
    traces: list[WaveTrace] = []
    i = 0
    while True:
        t0 = time.perf_counter()
        hw = gather(i)
        if hw is None:
            return traces
        t1 = time.perf_counter()
        staged = stage(hw.payload)
        _sync(device)
        t2 = time.perf_counter()
        solve(i, staged)
        _sync(device)
        t3 = time.perf_counter()
        traces.append(WaveTrace(
            wave=i, machines=hw.machines, rows=hw.rows,
            bytes_moved=hw.bytes_moved, gather_s=t1 - t0, h2d_s=t2 - t1,
            solve_s=t3 - t2))
        i += 1
