"""Wave-width planners of a streaming round 0 (counterpart of
``repro.engine.autotune``): the round asks a planner for each wave's
width, in wave order, from the gather side, and feeds every completed
wave's trace back from the solve side.

## Controller model

A wave's cost on each track is ``fixed + per_machine · W``: the gather
pays a per-wave term for every pass over the source and the route of its
indices, the consumer (the H2D stage and the solve) one dispatch, fold
and synchronize per wave.  The pipelined engine's wall is near
``g₀ + max(Σgather, Σ(stage + solve))``, reached when the binding track's
per-wave overhead is amortized.  :class:`AutotunePlanner` descends on the
measured **binding-track cost per machine**, an EWMA per ladder rung of
``max(gather_s, device_s) / machines``, one rung a wave, holding inside a
deadband.  Its decisions are a function of the trace stream alone: the
same :class:`WaveTrace` sequence gives the same widths in this package
and in the JAX one (a JAX trace has no ``h2d_s``, which reads as 0 here).

## Bucket ladder

Widths are ``ndev · 2^j`` rungs capped by the byte budget, an explicit W
or the machine count, and ragged tails snap *down* to a rung, so a run
dispatches at most ``⌊log2(W_max/ndev)⌋ + 2`` distinct wave widths (the
tree asserts it).  On the card the first wave at a new width pays
a page-locked block of a new size in the caching host allocator and the
first launches at a new grid; the controller scores steady-state rates,
so it discards that first sample at every rung (the JAX package's rule,
where the first wave pays an XLA compile, kept as it is).

## Execution-policy invariant

A planner only changes *when* machine blocks are batched into a wave.
Block contents, the stochastic draws, failure injection and the strict
wave-order fold are functions of the machine index alone, so every width
trajectory gives the fixed-width sync result bit for bit.
"""
from __future__ import annotations

import json
import math
import os
import threading

from repro_torch.engine.stats import WaveTrace

_EPS = 1e-9


class AutotuneCache:
    """The converged rung of past runs, one JSON file.

    Maps ``"{source fingerprint}|mu={μ}|ndev={ndev}"`` to the rung a run
    ended on, so a rerun of the same source, shape, dtype, budget and
    device count seeds :class:`AutotunePlanner` at its knee.  The file is
    re-read on every lookup and written atomically (tmp, then rename), so
    concurrent runs at worst lose an update; an unreadable file counts as
    empty (a cold start is always safe).  The file layout is the JAX
    package's, so either package reads the other's cache.
    """

    def __init__(self, path: str):
        self.path = str(path)

    def _load(self) -> dict:
        try:
            with open(self.path) as f:
                data = json.load(f)
            return data if isinstance(data, dict) else {}
        except (OSError, ValueError):
            return {}

    def get(self, key: str) -> int | None:
        v = self._load().get(key)
        return int(v) if isinstance(v, (int, float)) else None

    def put(self, key: str, width: int) -> None:
        data = self._load()
        data[key] = int(width)
        os.makedirs(os.path.dirname(os.path.abspath(self.path)),
                    exist_ok=True)
        tmp = self.path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(data, f, indent=1, sort_keys=True)
        os.replace(tmp, self.path)


def bucket_ladder(ndev: int, w_max: int) -> list[int]:
    """Width rungs ``ndev·2^j ≤ w_max``, and ``w_max`` itself where the cap
    is not a rung (a budget-derived cap rarely is).  ``w_max`` must be a
    multiple of ``ndev``."""
    if not (ndev >= 1 and w_max >= ndev):
        raise ValueError(f"ndev={ndev}, w_max={w_max}")
    if w_max % ndev:
        raise ValueError(f"w_max={w_max} not a multiple of ndev={ndev}")
    ladder = []
    w = ndev
    while w <= w_max:
        ladder.append(w)
        w *= 2
    if ladder[-1] != w_max:
        ladder.append(w_max)
    return ladder


def shape_bound(ndev: int, w_max: int) -> int:
    """The most distinct wave widths any planner trajectory may dispatch."""
    return int(math.floor(math.log2(max(1, w_max // ndev)))) + 2


def snap_down(ladder: list[int], width: int) -> int:
    """The largest rung ≤ ``width`` (``width ≥ ladder[0]``)."""
    if width < ladder[0]:
        raise ValueError(f"width={width} below the ladder's {ladder[0]}")
    best = ladder[0]
    for w in ladder:
        if w <= width:
            best = w
    return best


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


class ScheduledWidthPlanner(WavePlanner):
    """Replays an explicit width schedule (adversarial trajectories, forced
    oscillation, resume under another trajectory).  Widths are clamped to
    what remains, and an exhausted schedule repeats its last entry."""

    def __init__(self, widths: list[int]):
        if not widths or any(w < 1 for w in widths):
            raise ValueError(f"schedule {widths}: widths must be ≥ 1")
        self._widths = list(widths)
        self._i = 0
        self._lock = threading.Lock()

    def next_width(self, remaining: int) -> int:
        with self._lock:
            w = self._widths[min(self._i, len(self._widths) - 1)]
            self._i += 1
        return min(w, remaining)


class AutotunePlanner(WavePlanner):
    """EWMA rate controller on the bucket ladder.

    State per rung: the EWMA of the binding-track cost per machine,
    ``max(gather_s, h2d_s + solve_s) / machines``.  Decision per wave:

      * warmup — hold the start rung until ``warmup`` traces landed;
      * explore — one rung in the current direction (up at first);
      * compare — once the new rung is measured, go on while it improved
        by more than ``deadband``, turn back on a regression, hold inside
        the deadband; hold too where the next rung this way is already
        measured worse (an interior optimum is then a fixed point);
      * at a ladder end the first move flips direction, so a start at an
        end still probes the one way open.

    The first wave at each rung is not scored (see the module docstring).
    Gather and device EWMAs per machine are kept for the trajectory record,
    the fault supervisor's hedge threshold and
    :func:`suggest_prefetch_depth`.
    """

    def __init__(self, ladder: list[int], start: int, *, alpha: float = 0.5,
                 deadband: float = 0.10, warmup: int = 1):
        if ladder != sorted(ladder) or len(set(ladder)) != len(ladder):
            raise ValueError(f"ladder {ladder} must be strictly increasing")
        if start not in ladder:
            raise ValueError(f"start {start} not a rung of {ladder}")
        if not (0.0 < alpha <= 1.0 and deadband >= 0.0 and warmup >= 1):
            raise ValueError(f"alpha={alpha}, deadband={deadband}, "
                             f"warmup={warmup}")
        self._ladder = list(ladder)
        self._j = ladder.index(start)
        self._prev_j: int | None = None
        self._dir = +1
        self._alpha = alpha
        self._deadband = deadband
        self._warmup = warmup
        self._cost: dict[int, float] = {}   # rung index → EWMA s/machine
        self._visits: dict[int, int] = {}   # rung index → waves observed
        self._n_traces = 0
        self.ewma_gather_per_machine: float | None = None
        self.ewma_solve_per_machine: float | None = None
        self._lock = threading.Lock()
        self.tracer = None      # set by the tree: rung moves become
        #                         "autotune" instants

    def _ewma(self, old: float | None, new: float) -> float:
        return new if old is None else (1 - self._alpha) * old + self._alpha * new

    def observe(self, trace: WaveTrace) -> None:
        m = max(1, trace.machines)
        device_s = trace.h2d_s + trace.solve_s
        with self._lock:
            self._n_traces += 1
            self.ewma_gather_per_machine = self._ewma(
                self.ewma_gather_per_machine, trace.gather_s / m)
            self.ewma_solve_per_machine = self._ewma(
                self.ewma_solve_per_machine, device_s / m)
            # the sample belongs to the rung dispatched (ragged tails snap
            # to rungs, so it always is one)
            if trace.machines in self._ladder:
                j = self._ladder.index(trace.machines)
                self._visits[j] = self._visits.get(j, 0) + 1
                if self._visits[j] > 1:     # the first wave is not scored
                    self._cost[j] = self._ewma(
                        self._cost.get(j),
                        max(trace.gather_s, device_s) / m)

    def _decide(self) -> int:
        if self._n_traces < self._warmup:
            return self._j
        cur = self._cost.get(self._j)
        if cur is None:                     # the rung's first wave is out
            return self._j
        if self._prev_j is None or self._prev_j not in self._cost:
            return self._step(self._dir, flip_on_bounce=True)
        prev = self._cost[self._prev_j]
        if cur > prev * (1.0 + self._deadband):
            self._dir = -self._dir          # regressed: go back
            return self._step(self._dir)
        if cur < prev * (1.0 - self._deadband):
            # improving: go on, unless the next rung this way is already
            # measured worse than here (without this guard an interior
            # optimum is a three-rung cycle)
            nxt = self._cost.get(self._j + self._dir)
            if nxt is not None and nxt > cur * (1.0 + self._deadband):
                return self._j
            return self._step(self._dir)
        return self._j                      # inside the deadband

    def _step(self, d: int, flip_on_bounce: bool = False) -> int:
        j_new = self._j + d
        if not 0 <= j_new < len(self._ladder):
            if not flip_on_bounce:
                return self._j              # hold at the end, keep dir
            self._dir = -d
            j_new = self._j + self._dir
            if not 0 <= j_new < len(self._ladder):
                return self._j              # a one-rung ladder
        self._prev_j, self._j = self._j, j_new
        return self._j

    def next_width(self, remaining: int) -> int:
        with self._lock:
            j_before = self._j
            j = self._decide()
            width = snap_down(self._ladder, min(self._ladder[j], remaining))
            cost = self._cost.get(j)
        # the tracer has its own lock; emit outside this one
        if self.tracer is not None and j != j_before:
            self.tracer.instant(
                "rung", "autotune", width=self._ladder[j],
                prev_width=self._ladder[j_before],
                direction=("up" if j > j_before else "down"),
                **({} if cost is None else {"cost_per_machine": cost}))
        return width

    def gather_rate(self) -> float | None:
        with self._lock:
            return self.ewma_gather_per_machine

    def seed(self, width: int) -> None:
        """Start at a cached rung (before the first wave): the warmup then
        holds at the knee.  Only the start changes; the controller retunes
        freely afterwards."""
        if width not in self._ladder:
            raise ValueError(f"width {width} not a rung of {self._ladder}")
        with self._lock:
            if self._n_traces:
                raise RuntimeError("seed() after waves ran")
            self._j = self._ladder.index(width)
            self._prev_j = None

    def converged_width(self) -> int:
        """The rung the controller sits on: what a finished run stores as
        its configuration's knee."""
        with self._lock:
            return self._ladder[self._j]


def suggest_prefetch_depth(gather_s: float, solve_s: float, *,
                           lo: int = 2, hi: int = 8) -> int:
    """A chunk-prefetch depth from measured gather and solve seconds:
    ``1 + ⌈Σgather / Σsolve⌉`` clamped to ``[lo, hi]`` (a deeper buffer
    rides out gather bursts where gathers are slower than the compute that
    drains them), ``lo`` without a measurement."""
    if not 1 <= lo <= hi:
        raise ValueError(f"lo={lo}, hi={hi}")
    if gather_s <= 0.0 or solve_s <= 0.0:
        return lo
    return max(lo, min(hi, 1 + math.ceil(gather_s / max(solve_s, _EPS))))
