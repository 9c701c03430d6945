"""Step checkpoints with keep-k rotation and per-step straggler detection
for the training loop (counterpart of ``repro.train.fault_tolerance``).

The data pipeline is a pure function of (seed, step), so a restart from
``restore_latest`` replays the exact batch sequence; a step is a function
of its state and batch to the bit (``train_step``), so the resumed run
equals the uninterrupted one.  :class:`StragglerMonitor` flags steps
slower than ``factor`` × the window's median, for a supervisor to act on;
its clock is injectable.
"""
from __future__ import annotations

import dataclasses
import os
import re
import shutil
import time
from typing import Any, Callable

from repro_torch.train import checkpoint as ckpt_lib


@dataclasses.dataclass
class CheckpointManager:
    directory: str
    every_steps: int = 100
    keep: int = 3

    def maybe_save(self, step: int, state: Any) -> str | None:
        if step % self.every_steps:
            return None
        path = ckpt_lib.save(self.directory, step, state)
        self._rotate()
        return path

    def _rotate(self):
        steps = sorted(
            int(m.group(1)) for d in os.listdir(self.directory)
            if (m := re.fullmatch(r"step_(\d+)", d)))
        for s in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:08d}"),
                          ignore_errors=True)

    def restore_latest(self, like: Any):
        step = ckpt_lib.latest_step(self.directory)
        if step is None:
            return None, 0
        return ckpt_lib.restore(self.directory, step, like), step


class StragglerMonitor:
    """Tracks per-step wall time; flags steps slower than ``factor`` ×
    median once the window holds 5 steps.  ``clock`` (seconds, default
    ``time.perf_counter``) is where a test gives its own times."""

    def __init__(self, factor: float = 3.0, window: int = 50,
                 clock: Callable[[], float] = time.perf_counter):
        self.factor = factor
        self.window = window
        self.clock = clock
        self.times: list[float] = []
        self._t0 = None

    def start(self):
        self._t0 = self.clock()

    def stop(self) -> bool:
        dt = self.clock() - self._t0
        self.times.append(dt)
        self.times = self.times[-self.window:]
        med = sorted(self.times)[len(self.times) // 2]
        return dt > self.factor * med and len(self.times) >= 5
