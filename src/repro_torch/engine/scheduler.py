"""The wave scheduler of a streaming round 0 (counterpart of
``repro.engine.scheduler``).

Round-0 ingestion is a sequence of waves; each wave is a host *gather*
(source reads and the assembly of its machine blocks in page-locked host
buffers), an *H2D* copy of those buffers to the card, and a device
*solve* (dispatch and the best-solution fold).  The sync engine
serializes the three per wave:

    g0 → h0 → s0 → g1 → h1 → s1 → ...        wall = Σ(g + h + s)

The pipelined engine gathers wave t + 1 on a producer thread while the
caller thread stages and solves wave t, with at most ``max_in_flight``
gathered host waves alive at once:

    g0 → h0 s0  h1 s1  h2 s2 ...
          g1     g2     g3 ...               wall ≈ g0 + max(Σg, Σ(h + s))

Contract, for both engines:

  * **Bit identity** — ``solve`` sees exactly the buffers ``gather``
    produced, in wave order, so the fold order and failure injection are
    those of the resident round.
  * **Backpressure** — a credit is taken before a gather starts and given
    back once the wave's copy to the card has completed (the stage is
    followed by a device synchronize), so a host buffer is never refilled
    while a copy may still read it; the high-water mark is recorded.
  * **Every launch stays on the caller thread** — PyTorch keeps the
    current stream per thread, so the producer touches the source, NumPy
    and host memory only; ``stage`` and ``solve`` run on the caller.
  * **Timing** — the stage and the solve each end in a device
    synchronize in both engines, so their host-clock seconds are the
    card's work and the two engines' columns compare like with like.
  * **Telemetry** — a ``tracer`` gets a ``gather`` span per wave from the
    thread that gathered it, and ``stage`` and ``solve`` spans from the
    caller, each closed after its synchronize; the pipelined engine adds
    ``sem-block`` (producer) and ``queue-wait`` (consumer) stall spans and
    ``scheduler.stall_s`` histograms.  It observes only.
"""
from __future__ import annotations

import dataclasses
import queue
import sys
import threading
import time
from typing import Any, Callable, NamedTuple

import torch

from repro_torch.engine.stats import (EngineStats, WaveTrace,
                                      overlap_from_traces)

ENGINES = ("sync", "pipelined")


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """How round 0 executes (orthogonal to what it computes)."""
    mode: str = "sync"          # sync | pipelined
    max_in_flight: int = 2      # gathered host waves alive at once
    hosts: int = 1              # ingestion hosts sharding each gather
    join_timeout_s: float = 30.0  # producer shutdown grace before a hung
    #                               gather is reported

    def __post_init__(self):
        if self.mode not in ENGINES:
            raise ValueError(f"engine {self.mode!r} not in {ENGINES}")
        if self.max_in_flight < 2:
            raise ValueError(f"pipelining needs ≥ 2 wave buffers (got "
                             f"max_in_flight={self.max_in_flight})")
        if self.hosts < 1:
            raise ValueError(f"hosts={self.hosts} < 1")
        if self.join_timeout_s <= 0:
            raise ValueError(f"join_timeout_s={self.join_timeout_s} ≤ 0")


class HostWave(NamedTuple):
    """One gathered wave: host payload and accounting, made by ``gather``."""
    payload: Any                # opaque to the engine; ``stage`` takes it
    machines: int
    rows: int
    bytes_moved: int            # host → device bytes of the wave's buffers
    per_host_rows: list[int] | None = None


class _Abort(Exception):
    """Producer-side signal that the consumer stopped; never escapes."""


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_waves(gather: Callable[[int], HostWave | None],
              stage: Callable[[Any], Any],
              solve: Callable[[int, Any], None],
              cfg: EngineConfig, device: torch.device,
              on_trace: Callable[[WaveTrace], None] | None = None,
              tracer=None) -> EngineStats:
    """Drive gather → stage → solve per wave until ``gather(i)`` returns
    ``None``, under ``cfg.mode``.

    ``gather`` runs on a producer thread in pipelined mode (it must launch
    nothing on the card); ``stage(payload)`` and ``solve(i, staged)`` run
    on the caller thread in wave order.  ``on_trace`` receives each wave's
    trace on the caller thread before the next wave is staged.  ``tracer``
    (a :class:`repro_torch.engine.telemetry.Tracer`) gets the spans of the
    module docstring.
    """
    if cfg.mode == "sync":
        return _run_sync(gather, stage, solve, cfg, device, on_trace, tracer)
    return _run_pipelined(gather, stage, solve, cfg, device, on_trace,
                          tracer)


def _stage_and_solve(i: int, hw: HostWave, stage, solve, device,
                     release=None, tracer=None) -> tuple[float, float, float]:
    """Stage and solve one wave on the caller thread; returns the three
    host-clock readings (before the stage, after it, after the solve)."""
    t1 = time.perf_counter()
    staged = stage(hw.payload)
    _sync(device)                 # the copy has read the host buffers
    if release is not None:
        release()
    t2 = time.perf_counter()
    solve(i, staged)
    _sync(device)
    t3 = time.perf_counter()
    if tracer is not None:
        tracer.emit("stage", "wave", t1, t2, wave=i, machines=hw.machines,
                    bytes=hw.bytes_moved)
        tracer.emit("solve", "wave", t2, t3, wave=i, machines=hw.machines)
    return t1, t2, t3


def _finalize(engine: str, cfg: EngineConfig, traces: list[WaveTrace],
              wall_s: float, max_live: int) -> EngineStats:
    span, overlap = overlap_from_traces(traces)
    return EngineStats(
        engine=engine, hosts=cfg.hosts, waves=len(traces), wall_s=wall_s,
        gather_s=sum(t.gather_s for t in traces),
        h2d_s=sum(t.h2d_s for t in traces),
        solve_s=sum(t.solve_s for t in traces),
        bytes_moved=sum(t.bytes_moved for t in traces),
        overlap_ratio=overlap if engine == "pipelined" else 0.0,
        max_in_flight=max_live, traces=traces, span_wall_s=span)


def _run_sync(gather, stage, solve, cfg, device, on_trace, tracer=None
              ) -> EngineStats:
    """The bit-identity reference: gather, stage and solve serialized."""
    traces: list[WaveTrace] = []
    t_run = time.perf_counter()
    i = 0
    while True:
        t0 = time.perf_counter()
        hw = gather(i)
        if hw is None:
            break
        t1, t2, t3 = _stage_and_solve(i, hw, stage, solve, device,
                                      tracer=tracer)
        if tracer is not None:
            tracer.emit("gather", "wave", t0, t1, wave=i,
                        machines=hw.machines, rows=hw.rows,
                        bytes=hw.bytes_moved)
        traces.append(WaveTrace(
            wave=i, machines=hw.machines, rows=hw.rows,
            bytes_moved=hw.bytes_moved, gather_s=t1 - t0, h2d_s=t2 - t1,
            solve_s=t3 - t2, per_host_rows=hw.per_host_rows, t_start=t0,
            t_end=t3))
        if on_trace is not None:
            on_trace(traces[-1])
        i += 1
    return _finalize("sync", cfg, traces, time.perf_counter() - t_run,
                     max_live=1 if traces else 0)


class _BufferGauge:
    """Counts live gathered wave buffers; enforces and records the bound."""

    def __init__(self, limit: int):
        self._sem = threading.Semaphore(limit)
        self._lock = threading.Lock()
        self._live = 0
        self.high_water = 0

    def acquire(self, abort: threading.Event) -> bool:
        while not self._sem.acquire(timeout=0.1):
            if abort.is_set():
                return False
        with self._lock:
            self._live += 1
            self.high_water = max(self.high_water, self._live)
        return True

    def release(self) -> None:
        with self._lock:
            self._live -= 1
        self._sem.release()


_DONE = object()    # producer → consumer: no more waves
_FAILED = object()  # producer → consumer: the exception is in the slot


def _run_pipelined(gather, stage, solve, cfg, device, on_trace, tracer=None
                   ) -> EngineStats:
    """Wave t + 1 gathers on a producer thread while wave t is staged and
    solved on the caller thread."""
    out: queue.Queue = queue.Queue(maxsize=max(1, cfg.max_in_flight - 1))
    abort = threading.Event()
    gauge = _BufferGauge(cfg.max_in_flight)
    # the producer's exception lands here before any queue traffic: the
    # wake-up put below may give up once the consumer has stopped, the
    # slot cannot be lost
    exc_slot: list[BaseException] = []

    def put(item) -> bool:
        while not abort.is_set():
            try:
                out.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def produce():
        try:
            i = 0
            while True:
                ts = time.perf_counter()
                if not gauge.acquire(abort):
                    raise _Abort
                t0 = time.perf_counter()
                hw = gather(i)
                t1 = time.perf_counter()
                if hw is None:
                    gauge.release()
                    break
                if tracer is not None:
                    if t0 > ts:
                        tracer.emit("sem-block", "stall", ts, t0, wave=i,
                                    side="producer")
                    tracer.metrics.histogram(
                        "scheduler.stall_s", side="producer").observe(t0 - ts)
                    tracer.emit("gather", "wave", t0, t1, wave=i,
                                machines=hw.machines, rows=hw.rows,
                                bytes=hw.bytes_moved)
                if not put((i, hw, t0, t1, t0 - ts)):
                    raise _Abort
                i += 1
            put((_DONE, None, 0.0, 0.0, 0.0))
        except _Abort:
            pass
        except BaseException as exc:  # surfaces on the caller
            exc_slot.append(exc)
            put((_FAILED, None, 0.0, 0.0, 0.0))

    producer = threading.Thread(target=produce, name="wave-prefetch",
                                daemon=True)
    traces: list[WaveTrace] = []
    t_run = time.perf_counter()
    producer.start()
    try:
        expect = 0
        while True:
            tw0 = time.perf_counter()
            i, hw, g0, g1, p_stall = out.get()
            tw1 = time.perf_counter()
            if i is _FAILED:
                raise exc_slot[0]
            if i is _DONE:
                break
            if i != expect:
                raise RuntimeError(f"wave order broke: got {i}, want "
                                   f"{expect}")
            if tracer is not None:
                if tw1 > tw0:
                    tracer.emit("queue-wait", "stall", tw0, tw1, wave=i,
                                side="consumer")
                tracer.metrics.histogram(
                    "scheduler.stall_s", side="consumer").observe(tw1 - tw0)
            t1, t2, t3 = _stage_and_solve(i, hw, stage, solve, device,
                                          release=gauge.release,
                                          tracer=tracer)
            traces.append(WaveTrace(
                wave=i, machines=hw.machines, rows=hw.rows,
                bytes_moved=hw.bytes_moved, gather_s=g1 - g0, h2d_s=t2 - t1,
                solve_s=t3 - t2, per_host_rows=hw.per_host_rows, t_start=g0,
                t_end=t3, stall_s=p_stall + (tw1 - tw0)))
            if on_trace is not None:
                on_trace(traces[-1])
            expect += 1
    finally:
        abort.set()
        producer.join(timeout=cfg.join_timeout_s)
        if producer.is_alive():
            # a gather is stuck past the grace: its thread is leaked.
            # Raise when nothing else propagates; else annotate that error
            msg = (f"wave-prefetch producer did not stop within "
                   f"{cfg.join_timeout_s} s of shutdown: a gather is hung "
                   f"and its thread leaked (a FaultPolicy deadline bounds "
                   f"gathers)")
            in_flight = sys.exc_info()[1]
            if in_flight is None:
                raise RuntimeError(msg)
            in_flight.add_note(msg)
        elif exc_slot and sys.exc_info()[1] is None:
            # the producer failed after the consumer drained its waves
            raise exc_slot[0]
    return _finalize("pipelined", cfg, traces, time.perf_counter() - t_run,
                     max_live=gauge.high_water)
