"""Engine stats — per-wave timings, bytes moved, overlap, fault and
checkpoint records (counterpart of ``repro.engine.stats``).

Every round-0 engine (sync and pipelined) emits one :class:`WaveTrace` per
wave and one :class:`EngineStats` per run:

  * ``gather_s`` is host work: source reads and the assembly of the
    wave's machine blocks into page-locked buffers (what the pipelined
    engine hides under the device's work);
  * ``h2d_s`` is the copy of those buffers to the card and ``solve_s`` the
    wave's dispatch and best-solution fold, each ended by a device
    synchronize, so both engines measure them alike;
  * ``overlap_ratio`` is the share of the gather time hidden under the
    device's: ``(Σgather + Σ(h2d + solve) − wall) / Σgather`` clamped to
    [0, 1], with ``wall`` the waves' span on the host clock.  The sync
    engine serializes the two, so its ratio is 0.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class WaveTrace:
    """Accounting of one dispatched wave (host clock, ``perf_counter``).

    ``t_start`` / ``t_end`` are the wave's gather start and solve end, so
    waves can be placed on one timeline; ``stall_s`` is backpressure: the
    producer's wait for a buffer credit plus the consumer's wait for the
    gathered wave (0 in the sync engine, where neither wait exists).
    """
    wave: int                   # wave index (fold order)
    machines: int               # machine blocks in the wave (≤ W)
    rows: int                   # candidate rows materialized (machines · μ)
    bytes_moved: int            # host → device bytes of the wave
    gather_s: float             # host: source reads + block assembly
    h2d_s: float                # copy to the card (synced)
    solve_s: float              # dispatch + fold on the card (synced)
    per_host_rows: list[int] | None = None  # rows each ingestion host served
    t_start: float = 0.0        # perf_counter at the gather's start
    t_end: float = 0.0          # perf_counter at the solve's end
    stall_s: float = 0.0        # backpressure: credit wait + queue wait

    @property
    def device_s(self) -> float:
        """The wave's device-side seconds: the copy and the solve."""
        return self.h2d_s + self.solve_s


@dataclasses.dataclass
class EngineStats:
    """Round-0 engine summary (``TreeResult.engine_stats``)."""
    engine: str                 # "sync" | "pipelined"
    hosts: int                  # ingestion hosts (1: one gather)
    waves: int
    wall_s: float               # the engine's whole run, host clock
    gather_s: float             # Σ gather
    h2d_s: float                # Σ copies to the card
    solve_s: float              # Σ solve
    bytes_moved: int            # Σ host → device bytes
    overlap_ratio: float        # share of the gather hidden under the device
    max_in_flight: int          # high-water mark of live host wave buffers
    traces: list[WaveTrace] = dataclasses.field(default_factory=list)
    fault_stats: "FaultStats | None" = None  # set where supervision ran
    span_wall_s: float = 0.0    # max(t_end) − min(t_start) over the traces

    @property
    def overlap_ratio_legacy(self) -> float:
        """The ratio over the engine's whole measured ``wall_s`` instead of
        the waves' span: the loop around the waves only adds wall, so it
        is at most ``overlap_ratio`` (a cross-check of the span form)."""
        return overlap_ratio(self.gather_s, self.h2d_s + self.solve_s,
                             self.wall_s)

    @property
    def width_trajectory(self) -> list[int]:
        """Machines per wave in wave order (constant but for the tail under
        a fixed width)."""
        return [t.machines for t in self.traces]

    @property
    def distinct_shapes(self) -> int:
        """Distinct wave widths dispatched."""
        return len(set(self.width_trajectory))

    def summary(self) -> dict:
        """A JSON-able record of the run."""
        return {
            "engine": self.engine, "hosts": self.hosts, "waves": self.waves,
            "wall_s": self.wall_s, "gather_s": self.gather_s,
            "h2d_s": self.h2d_s, "solve_s": self.solve_s,
            "bytes_moved": self.bytes_moved,
            "overlap_ratio": self.overlap_ratio,
            "span_wall_s": self.span_wall_s,
            "stall_s": sum(t.stall_s for t in self.traces),
            "max_in_flight": self.max_in_flight,
            "width_trajectory": self.width_trajectory,
            "distinct_shapes": self.distinct_shapes,
            **({"faults": self.fault_stats.summary()}
               if self.fault_stats is not None else {}),
        }


def overlap_ratio(gather_s: float, device_s: float, wall_s: float) -> float:
    """Share of the gather time hidden under the device time:
    ``(gather + device − wall) / gather``, clamped to [0, 1] (timer jitter
    can push it past either end on tiny waves)."""
    if gather_s <= 0.0:
        return 0.0
    return min(1.0, max(0.0, (gather_s + device_s - wall_s) / gather_s))


def overlap_from_traces(traces: list[WaveTrace]) -> tuple[float, float]:
    """``(span_wall, overlap_ratio)`` from the waves' timestamps:
    ``span_wall = max(t_end) − min(t_start)``, the wall the waves occupied
    without the engine's loop around them; ``(0, 0)`` without traces."""
    stamped = [t for t in traces if t.t_end > 0.0]
    if not stamped:
        return 0.0, 0.0
    span = max(t.t_end for t in stamped) - min(t.t_start for t in stamped)
    g = sum(t.gather_s for t in stamped)
    s = sum(t.device_s for t in stamped)
    return span, overlap_ratio(g, s, span)


# -- fault supervision records (read by core/tree.py without the supervisor)

FAULT_KINDS = ("transient-retry", "latency", "straggler", "hedge",
               "evict", "drop")


@dataclasses.dataclass
class FaultEvent:
    """One supervision decision, in the order the supervisor made it."""
    kind: str                   # one of FAULT_KINDS
    wave: int                   # the wave it belongs to
    attempt: int                # gather attempt (0: the first try)
    detail: str = ""            # host id, error, ...
    seconds: float = 0.0        # backoff, straggler overrun, ...

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(f"fault kind {self.kind!r} not in {FAULT_KINDS}")


@dataclasses.dataclass
class FaultStats:
    """A run's fault-supervision record (``TreeResult.fault_stats``).

    ``dropped_rows / total_rows`` is the dropped fraction held to the
    Lemma 3.4 budget: a dropped machine forfeits at most its μ-slice of
    round 0's candidates.
    """
    retries: int = 0            # transient gather retries issued
    hedges: int = 0             # speculative re-gathers launched
    hedges_won: int = 0         # hedges that finished first
    evictions: int = 0          # lost hosts re-routed to survivors
    dropped_waves: int = 0      # waves folded as dead past the budget
    dropped_machines: int = 0   # machine blocks in dropped waves
    dropped_rows: int = 0       # valid candidate rows they forfeited
    total_rows: int = 0         # round 0's rows (the fraction's denominator)
    recovered_s: float = 0.0    # wall inside successful recoveries
    backoff_s: float = 0.0      # wall asleep between retries
    events: list[FaultEvent] = dataclasses.field(default_factory=list)

    @property
    def dropped_fraction(self) -> float:
        return 0.0 if self.total_rows <= 0 else (
            self.dropped_rows / self.total_rows)

    def record(self, event: FaultEvent) -> None:
        self.events.append(event)

    def summary(self) -> dict:
        return {
            "retries": self.retries,
            "hedges": self.hedges, "hedges_won": self.hedges_won,
            "evictions": self.evictions,
            "dropped_waves": self.dropped_waves,
            "dropped_machines": self.dropped_machines,
            "dropped_rows": self.dropped_rows,
            "total_rows": self.total_rows,
            "dropped_fraction": self.dropped_fraction,
            "recovered_s": self.recovered_s, "backoff_s": self.backoff_s,
            "events": len(self.events),
        }

    def replay_signature(self) -> dict:
        """The counters a replay of the same seeded fault profile must
        reproduce exactly (hedges fire on wall-clock thresholds, so they
        are left out)."""
        return {
            "retries": self.retries, "evictions": self.evictions,
            "dropped_waves": self.dropped_waves,
            "dropped_machines": self.dropped_machines,
            "dropped_rows": self.dropped_rows,
        }


class StragglerMonitor:
    """Gather rate per machine, feeding the hedge threshold: a windowed
    median (robust to the stragglers themselves) and an EWMA (drift); the
    threshold takes the larger, times ``factor``.  ``None`` until
    ``min_samples`` waves were seen, so a cold start never hedges."""

    def __init__(self, factor: float = 3.0, window: int = 50,
                 min_samples: int = 3, alpha: float = 0.3):
        if factor <= 1.0:
            raise ValueError(f"factor={factor} ≤ 1")
        self.factor = factor
        self.window = window
        self.min_samples = min_samples
        self.alpha = alpha
        self.rates: list[float] = []    # seconds per machine, recent window
        self.ewma: float | None = None

    def observe(self, seconds: float, machines: int) -> None:
        rate = seconds / max(1, machines)
        self.rates = (self.rates + [rate])[-self.window:]
        self.ewma = rate if self.ewma is None else (
            self.alpha * rate + (1.0 - self.alpha) * self.ewma)

    def threshold(self, machines: int,
                  rate_hint: float | None = None) -> float | None:
        """Seconds a ``machines``-wide gather may take before it is hedged,
        or ``None`` while too few waves were seen; a ``rate_hint`` (a
        planner's measured rate) takes precedence."""
        if len(self.rates) < self.min_samples and rate_hint is None:
            return None
        rate = rate_hint if rate_hint is not None else max(
            sorted(self.rates)[len(self.rates) // 2], self.ewma or 0.0)
        return self.factor * rate * max(1, machines)


@dataclasses.dataclass
class RoundCheckpoint:
    """One round-boundary checkpoint write."""
    round: int                  # the round the snapshot resumes into
    write_s: float              # serialize + write (writer thread if async)
    wait_s: float               # what the round loop paid for it: the
    #                             barrier before the next snapshot (async)
    #                             or the whole write (sync)

    @property
    def hidden_s(self) -> float:
        """Write seconds overlapped with the next round's work."""
        return max(0.0, self.write_s - self.wait_s)


@dataclasses.dataclass
class CheckpointStats:
    """A run's checkpoint record (``TreeResult.checkpoint_stats``)."""
    mode: str                   # "sync" | "async"
    rounds: list[RoundCheckpoint] = dataclasses.field(default_factory=list)

    @property
    def write_s(self) -> float:
        return sum(r.write_s for r in self.rounds)

    @property
    def wait_s(self) -> float:
        return sum(r.wait_s for r in self.rounds)

    @property
    def hidden_s(self) -> float:
        return sum(r.hidden_s for r in self.rounds)

    @property
    def hidden_fraction(self) -> float:
        """Share of the write time hidden under the rounds' work."""
        w = self.write_s
        return 0.0 if w <= 0.0 else min(1.0, self.hidden_s / w)

    def summary(self) -> dict:
        return {"mode": self.mode, "rounds": len(self.rounds),
                "write_s": self.write_s, "wait_s": self.wait_s,
                "hidden_s": self.hidden_s,
                "hidden_fraction": self.hidden_fraction}
