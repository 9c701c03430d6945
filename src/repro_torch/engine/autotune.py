"""Wave-width planners of a streaming round 0 (counterpart of the seam of
``repro.engine.autotune``): the round asks a planner for each wave's
width, in wave order, from the gather side, and feeds every completed
wave's trace back from the solve side.  Only the fixed width is ported;
the rate-tuned autoscaler waits for ROADMAP queue 1 item 11 part 4."""
from __future__ import annotations

from repro_torch.engine.stats import WaveTrace


class WavePlanner:
    """Width decision and trace feedback of one round-0 run.

    ``next_width(remaining)`` is called once a wave, in wave order, from
    the gather side (the pipelined engine's producer thread);
    ``observe(trace)`` once a completed wave, from the caller thread.
    """

    def next_width(self, remaining: int) -> int:
        raise NotImplementedError

    def observe(self, trace: WaveTrace) -> None:
        """Take a completed wave's trace (a fixed width ignores it)."""

    def gather_rate(self) -> float | None:
        """Measured gather seconds per machine, where the planner measures
        one (the fault supervisor's hedge threshold prefers it); None."""
        return None


class FixedWidthPlanner(WavePlanner):
    """W machines a wave, and the ragged rest in the last."""

    def __init__(self, width: int):
        if width < 1:
            raise ValueError(f"width={width} < 1")
        self.width = width

    def next_width(self, remaining: int) -> int:
        return min(self.width, remaining)
