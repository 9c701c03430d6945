"""Fault supervision of round 0's gathers (counterpart of
``repro.engine.faults``).

Algorithm 1 takes a max over machine solutions, so a lost partition costs
an additive Lemma 3.4 term instead of the run.  The supervisor handles
failures that happen while round 0 streams:

  * **Retry with exponential backoff** — a transient gather error is
    retried up to ``max_retries`` times, ``backoff_s · backoff_mult^r``
    apart, within an optional per-wave ``deadline_s``.
  * **Host eviction** — a :class:`~repro_torch.core.sources.HostLostError`
    re-plans (``IngestionPlan.evict`` gives the host's range to its
    neighbours) and retries at once; the plan stitches by global index, so
    the recovered wave is the same bytes.
  * **Hedged re-gather** — a gather running past ``hedge_factor ×`` the
    measured gather rate gets a second attempt beside it; the first to
    finish wins.  Gathers are deterministic by content, so a hedge changes
    when rows arrive, never which.
  * **Bounded degradation** — a wave past its budget is *dropped*: its
    machines fold as dead (value −inf, solutions masked, no oracle calls)
    and the run goes on, until the dropped share of round 0's rows passes
    ``max_dropped_fraction`` (:class:`DroppedFractionExceeded`).

:class:`FaultInjector` is the seeded chaos harness over the same seams.
Every decision is a function of ``(profile.seed, tag, wave, attempt)``
through NumPy's ``default_rng``, the draws the JAX package makes, so a
profile replays the same faults in either package.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Any, Callable

import numpy as np

from repro_torch.engine.stats import FaultEvent, FaultStats, StragglerMonitor


def _host_lost() -> type:
    """:class:`repro_torch.core.sources.HostLostError`, resolved at the
    first fault (``core`` imports ``engine``, so a module-level import here
    would cycle)."""
    from repro_torch.core.sources import HostLostError
    return HostLostError


class TransientIOError(IOError):
    """A transient gather failure: a retry is expected to succeed."""


class PermanentGatherError(RuntimeError):
    """A gather failure that persists across retries (a killed wave): it
    spends the retry budget and lands in the drop path."""


class DroppedFractionExceeded(RuntimeError):
    """The dropped rows passed ``FaultPolicy.max_dropped_fraction``, the
    Lemma 3.4 budget: the coreset's bound would no longer hold."""


class GatherDeadlineExceeded(TimeoutError):
    """A wave attempt ran past ``FaultPolicy.deadline_s``."""


# what the supervisor retries; anything else propagates at once
RETRYABLE = (OSError, TimeoutError, PermanentGatherError)

_HEDGE_BIT = 1 << 16   # a hedged attempt draws under its own attempt id


@dataclasses.dataclass(frozen=True)
class FaultPolicy:
    """How the engine answers gather faults."""
    max_retries: int = 3            # attempts after the first
    backoff_s: float = 0.05         # sleep before retry 1
    backoff_mult: float = 2.0       # growth per retry
    backoff_max_s: float = 2.0      # backoff ceiling
    deadline_s: float | None = None  # per-wave wall budget across attempts
    hedge: bool = True              # race a second gather past stragglers
    hedge_factor: float = 3.0       # straggler: this × the gather estimate
    hedge_min_waves: int = 3        # waves seen before a hedge may fire
    max_dropped_fraction: float = 0.5  # the Lemma 3.4 budget
    evict_hosts: bool = True        # re-plan around lost hosts

    def __post_init__(self):
        if (self.max_retries < 0 or self.backoff_s < 0
                or self.backoff_mult < 1.0
                or self.backoff_max_s < self.backoff_s
                or (self.deadline_s is not None and self.deadline_s <= 0)
                or self.hedge_factor <= 1.0 or self.hedge_min_waves < 1
                or not 0.0 <= self.max_dropped_fraction <= 1.0):
            raise ValueError(f"invalid {self}")

    def backoff(self, retry: int) -> float:
        """Sleep before the ``retry``-th retry (0-based)."""
        return min(self.backoff_max_s,
                   self.backoff_s * self.backoff_mult ** retry)


@dataclasses.dataclass(frozen=True)
class FaultProfile:
    """What the chaos harness injects; every decision seeded."""
    transient_rate: float = 0.0     # P(transient error) a wave attempt
    kill_waves: tuple[int, ...] = ()  # waves whose every attempt fails
    dead_host: int | None = None    # host id that dies for good ...
    dead_host_wave: int = 0         # ... from this wave on
    latency_s: float = 0.0          # injected sleep when latency fires
    latency_rate: float = 0.0       # P(latency) a wave attempt
    slow_waves: tuple[int, ...] = ()  # waves whose first attempt sleeps
    #                                   latency_s (a certain straggler)
    seed: int = 0

    def __post_init__(self):
        if (not 0.0 <= self.transient_rate < 1.0
                or not 0.0 <= self.latency_rate <= 1.0
                or self.latency_s < 0.0):
            raise ValueError(f"invalid {self}")

    @classmethod
    def from_spec(cls, spec: str) -> "FaultProfile":
        """Parse ``"transient=0.3,seed=7,dead_host=1,dead_host_wave=2,
        kill=3;5"``: keys transient, kill, dead_host, dead_host_wave,
        latency (or latency_s), latency_rate, slow, seed; lists take ``;``.
        """
        kw: dict[str, Any] = {}
        for part in filter(None, (p.strip() for p in spec.split(","))):
            key, _, val = part.partition("=")
            if not val:
                raise ValueError(f"malformed fault-profile entry {part!r} "
                                 "(want key=value)")
            if key == "transient":
                kw["transient_rate"] = float(val)
            elif key == "kill":
                kw["kill_waves"] = tuple(int(v) for v in val.split(";"))
            elif key == "slow":
                kw["slow_waves"] = tuple(int(v) for v in val.split(";"))
            elif key in ("dead_host", "dead_host_wave", "seed"):
                kw[key] = int(val)
            elif key in ("latency_s", "latency"):
                kw["latency_s"] = float(val)
            elif key == "latency_rate":
                kw["latency_rate"] = float(val)
            else:
                raise ValueError(f"unknown fault-profile key {key!r}")
        return cls(**kw)


class FaultInjector:
    """Seeded chaos harness over the gather seams.

    ``wave_hook(wave, attempt)`` fires at the start of each supervised wave
    attempt (transient errors, killed waves, latency); ``host_hook(wave,
    attempt)`` makes the per-host callback :meth:`IngestionPlan.gather`
    calls before each host's pull (a lost host fails there).  The draws
    are counter-based, ``default_rng((seed, tag, wave, attempt))``: no
    state, so hedges and replays draw the same bits.
    """

    _TAG_TRANSIENT = 0xFA01
    _TAG_LATENCY = 0xFA02

    def __init__(self, profile: FaultProfile):
        self.profile = profile

    def _roll(self, tag: int, wave: int, attempt: int) -> float:
        return float(np.random.default_rng(
            (self.profile.seed, tag, wave, attempt)).random())

    def wave_hook(self, wave: int, attempt: int) -> None:
        p = self.profile
        if wave in p.kill_waves:
            raise PermanentGatherError(
                f"injected permanent kill of wave {wave}")
        if p.latency_s > 0.0 and (
                (wave in p.slow_waves and attempt == 0)
                or (p.latency_rate > 0.0 and self._roll(
                    self._TAG_LATENCY, wave, attempt) < p.latency_rate)):
            time.sleep(p.latency_s)
        if p.transient_rate > 0.0 and self._roll(
                self._TAG_TRANSIENT, wave, attempt) < p.transient_rate:
            raise TransientIOError(
                f"injected transient fault (wave {wave}, attempt {attempt})")

    def host_hook(self, wave: int, attempt: int):
        p = self.profile
        if p.dead_host is None:
            return None

        def hook(shard) -> None:
            if shard.host == p.dead_host and wave >= p.dead_host_wave:
                raise _host_lost()(shard.host)

        return hook


class _Race:
    """First-completion-wins rendezvous of a primary and a hedged gather."""

    def __init__(self):
        self._lock = threading.Lock()
        self._done = threading.Event()
        self._pending = 0
        self.result: Any = None
        self.winner: str | None = None
        self.errors: list[BaseException] = []

    def register(self) -> None:
        with self._lock:
            self._pending += 1

    def complete(self, tag: str, result=None,
                 exc: BaseException | None = None) -> None:
        with self._lock:
            self._pending -= 1
            if exc is not None:
                self.errors.append(exc)
            elif self.winner is None:
                self.result, self.winner = result, tag
            settled = self.winner is not None or self._pending == 0
        if settled:
            self._done.set()

    def wait(self, timeout: float | None) -> bool:
        return self._done.wait(timeout)


class FaultSupervisor:
    """Applies a :class:`FaultPolicy` to every supervised wave gather.

    ``gather(wave, machines, rows, attempt_fn)`` drives ``attempt_fn(
    attempt)`` to a result, an eviction-assisted result, or a bounded drop,
    and returns ``(result, dropped)``; the caller folds a dropped wave as
    machines that never ran.

    With ``concurrent_ok`` (the source allows concurrent gathers) attempts
    run on daemon threads, so a deadline can abandon a hung attempt and a
    hedge can race a straggler; otherwise attempts run inline and the
    deadline is checked between them.  The supervisor is driven from the
    gather side only (one wave at a time), so only :class:`_Race` locks.
    """

    def __init__(self, policy: FaultPolicy, total_rows: int, *,
                 injector: FaultInjector | None = None,
                 monitor: StragglerMonitor | None = None,
                 rate_hint: Callable[[], float | None] | None = None,
                 concurrent_ok: bool = False,
                 evict_cb: Callable[[int], bool] | None = None,
                 tracer=None):
        self.policy = policy
        self.injector = injector
        self.monitor = monitor or StragglerMonitor(
            factor=policy.hedge_factor, min_samples=policy.hedge_min_waves)
        self.rate_hint = rate_hint
        self.concurrent_ok = concurrent_ok
        self.evict_cb = evict_cb
        self.stats = FaultStats(total_rows=total_rows)
        self.tracer = tracer    # decisions become "fault" spans/instants

    def gather(self, wave: int, machines: int, rows: int,
               attempt_fn: Callable[[int], Any]) -> tuple[Any, bool]:
        pol, st = self.policy, self.stats
        deadline = (None if pol.deadline_s is None
                    else time.perf_counter() + pol.deadline_s)
        t_first_fail: float | None = None
        attempt, retries_left = 0, pol.max_retries
        host_lost = _host_lost()
        while True:
            t0 = time.perf_counter()
            try:
                result = self._attempt(wave, machines, attempt, attempt_fn,
                                       deadline)
            except host_lost as exc:
                if self._evict(exc.host, wave):
                    t_first_fail = t_first_fail or t0
                    attempt += 1      # a fresh route, no backoff: the
                    continue          # survivors were never the problem
                self._drop(wave, machines, rows,
                           f"host {exc.host} lost, eviction unavailable")
                return None, True
            except RETRYABLE as exc:
                t_first_fail = t_first_fail or t0
                now = time.perf_counter()
                out_of_time = deadline is not None and now >= deadline
                if retries_left <= 0 or out_of_time:
                    self._drop(wave, machines, rows,
                               f"{type(exc).__name__}: {exc}"
                               + (" [deadline]" if out_of_time else
                                  " [retries exhausted]"))
                    return None, True
                pause = pol.backoff(attempt)
                if deadline is not None:
                    pause = min(pause, max(0.0, deadline - now))
                st.retries += 1
                st.backoff_s += pause
                st.record(FaultEvent(
                    kind="transient-retry", wave=wave, attempt=attempt,
                    detail=f"{type(exc).__name__}: {exc}", seconds=pause))
                ts = time.perf_counter() if self.tracer is not None else 0.0
                time.sleep(pause)
                if self.tracer is not None:
                    self.tracer.emit("retry-backoff", "fault", ts,
                                     time.perf_counter(), wave=wave,
                                     attempt=attempt,
                                     error=type(exc).__name__)
                retries_left -= 1
                attempt += 1
                continue
            self.monitor.observe(time.perf_counter() - t0, machines)
            if t_first_fail is not None:
                st.recovered_s += time.perf_counter() - t_first_fail
                if self.tracer is not None:
                    self.tracer.emit("recovery", "fault", t_first_fail,
                                     time.perf_counter(), wave=wave,
                                     attempts=attempt + 1)
            return result, False

    def _evict(self, host: int, wave: int) -> bool:
        if not self.policy.evict_hosts or self.evict_cb is None:
            return False
        if not self.evict_cb(host):
            return False
        self.stats.evictions += 1
        self.stats.record(FaultEvent(
            kind="evict", wave=wave, attempt=0,
            detail=f"host {host} re-routed to survivors"))
        if self.tracer is not None:
            self.tracer.instant("evict", "fault", wave=wave, host=host)
        return True

    def _drop(self, wave: int, machines: int, rows: int, why: str) -> None:
        st = self.stats
        st.dropped_waves += 1
        st.dropped_machines += machines
        st.dropped_rows += rows
        st.record(FaultEvent(kind="drop", wave=wave, attempt=0,
                             detail=f"{machines} machines ({rows} rows): "
                                    f"{why}"))
        if self.tracer is not None:
            self.tracer.instant("drop", "fault", wave=wave,
                                machines=machines, rows=rows, why=why)
        if st.dropped_fraction > self.policy.max_dropped_fraction:
            raise DroppedFractionExceeded(
                f"dropped {st.dropped_rows}/{st.total_rows} rows "
                f"({st.dropped_fraction:.3f}) > max_dropped_fraction="
                f"{self.policy.max_dropped_fraction}: the Lemma 3.4 "
                f"degradation budget is spent")

    def _hedge_threshold(self, machines: int) -> float | None:
        if not (self.policy.hedge and self.concurrent_ok):
            return None
        hint = self.rate_hint() if self.rate_hint is not None else None
        return self.monitor.threshold(machines, rate_hint=hint)

    def _attempt(self, wave: int, machines: int, attempt: int,
                 attempt_fn: Callable[[int], Any],
                 deadline: float | None) -> Any:
        """One attempt, hedged where armed; raises on failure."""
        thr = self._hedge_threshold(machines)
        run = self._instrumented(wave, attempt_fn)
        if not self.concurrent_ok:
            return run(attempt)
        race = _Race()
        self._spawn(race, run, attempt, tag="primary")
        t0 = time.perf_counter()
        hedged = False
        while True:
            now = time.perf_counter()
            waits = [deadline - now] if deadline is not None else []
            if thr is not None and not hedged:
                waits.append(t0 + thr - now)
            if race.wait(max(0.0, min(waits)) if waits else None):
                break
            now = time.perf_counter()
            if deadline is not None and now >= deadline:
                # the attempts are abandoned (daemon threads whose late
                # results the race discards); the retry loop decides
                raise GatherDeadlineExceeded(
                    f"wave {wave} attempt {attempt} past the "
                    f"{self.policy.deadline_s} s deadline")
            if thr is not None and not hedged and now - t0 >= thr:
                hedged = True
                st = self.stats
                st.hedges += 1
                st.record(FaultEvent(
                    kind="straggler", wave=wave, attempt=attempt,
                    detail=f"gather past the {thr:.3f} s threshold",
                    seconds=now - t0))
                st.record(FaultEvent(kind="hedge", wave=wave,
                                     attempt=attempt | _HEDGE_BIT))
                if self.tracer is not None:
                    self.tracer.instant("hedge", "fault", wave=wave,
                                        threshold_s=thr)
                self._spawn(race, run, attempt | _HEDGE_BIT, tag="hedge")
        if race.winner is None:
            raise race.errors[0]
        if race.winner == "hedge":
            self.stats.hedges_won += 1
            if self.tracer is not None:
                self.tracer.instant("hedge-won", "fault", wave=wave)
        return race.result

    def _instrumented(self, wave: int, attempt_fn):
        inj = self.injector

        def run(attempt: int):
            # the raw attempt id (hedge bit included) keys the injector's
            # draws: a hedge must not replay its primary's fault
            if inj is not None:
                inj.wave_hook(wave, attempt)
            return attempt_fn(attempt)

        return run

    def _spawn(self, race: _Race, run, attempt: int, tag: str) -> None:
        race.register()

        def work():
            try:
                race.complete(tag, result=run(attempt))
            except BaseException as exc:  # handed to the supervisor
                race.complete(tag, exc=exc)

        threading.Thread(target=work, daemon=True,
                         name=f"gather-{tag}").start()
