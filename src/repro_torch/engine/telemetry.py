"""Telemetry: span tracing, metrics and run manifests (counterpart of
``repro.engine.telemetry``).

One event stream for every layer of a run:

  * :class:`Tracer` — thread-safe spans (host ``perf_counter`` clock,
    one track per thread and named tracks for ingestion hosts, a
    category, attributes) and instants, emitted from the engine's seams:
    each wave's gather, H2D stage and solve on both schedulers with their
    backpressure stalls, per-host gathers, fault retries, hedges and
    evictions, the autotuner's rung moves, checkpoint snapshots, writes
    and barrier waits, rounds and the run;
  * :class:`MetricsRegistry` — labelled counters, gauges and histograms;
    :func:`feed_result_metrics` projects a result's stats records onto
    it, so those records and the spans are views of one trace stream;
  * exporters — Chrome ``trace_event`` JSON (Perfetto,
    ``chrome://tracing``), a JSONL event log, and the
    :class:`RunManifest` written atomically next to the checkpoints;
  * :func:`profiler_session` — a ``torch.profiler`` session around a
    block, its Chrome trace written into a directory.

Telemetry observes only: every seam guards on ``tracer is not None`` and
an instrumented run gives the uninstrumented result bit for bit.  The
solve of a wave ends in a device synchronize before its span closes, so a
solve span covers the card's work.  The port's extra step, the H2D stage
on the caller thread, is a ``stage`` span of category ``wave``; the
engine's overlap counts the stage and the solve as the device side, so
:func:`wave_overlap_from_spans` takes the stage and solve spans together.
The report lines of :func:`format_report` are the JAX package's, byte for
byte, for the same manifest.
"""
from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import json
import os
import threading
import time
from typing import Any, Iterator

import numpy as np
import torch

from repro_torch.engine.stats import CheckpointStats, EngineStats, FaultStats

SCHEMA_VERSION = 1

_DTYPE_LABELS = {"float32": "fp32", "bfloat16": "bf16", "uint16": "bf16",
                 "fp32": "fp32", "bf16": "bf16", "int8": "int8"}


def dtype_label(dtype) -> str:
    """The manifest's label of a storage dtype: ``fp32`` | ``bf16`` |
    ``int8`` | the raw NumPy name.  bf16 bit patterns (uint16, the host
    form of bf16 rows here) and ``torch.bfloat16`` read ``bf16``."""
    if isinstance(dtype, torch.dtype):
        name = str(dtype).removeprefix("torch.")
    elif isinstance(dtype, str) and dtype in _DTYPE_LABELS:
        name = dtype
    else:
        name = np.dtype(dtype).name
    return _DTYPE_LABELS.get(name, name)


#: span categories the engine emits ("serve": the selection service's
#: requests and batches, once it is ported)
CATEGORIES = ("wave", "host", "fault", "autotune", "ckpt", "round", "run",
              "stall", "serve")


@dataclasses.dataclass
class SpanEvent:
    """One finished span (``phase="X"``) or instant (``phase="i"``);
    times are raw ``time.perf_counter()`` seconds, the clock of
    ``WaveTrace``'s stamps."""
    name: str
    cat: str
    t0: float
    t1: float                   # == t0 for instants
    track: int                  # compact track id (thread or named track)
    phase: str = "X"            # "X" span | "i" instant
    args: dict = dataclasses.field(default_factory=dict)

    @property
    def dur_s(self) -> float:
        return self.t1 - self.t0


class Tracer:
    """Thread-safe collector of spans and instants.

    Every emitting thread gets its own track; actors that are not threads
    (ingestion hosts) get named tracks through ``track=``, so a host's
    gathers line up on one lane whichever pool thread served them.  An
    emission is one append under the lock: the engine emits per wave,
    never per row.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self.epoch = time.perf_counter()     # trace time zero
        self.created_unix = time.time()      # wall-clock anchor (export)
        self.events: list[SpanEvent] = []
        self._tracks: dict[Any, int] = {}    # key → compact track id
        self._track_names: dict[int, str] = {}
        self.metrics = MetricsRegistry()

    @staticmethod
    def now() -> float:
        return time.perf_counter()

    def _track_id(self, track: str | None) -> int:
        if track is None:
            th = threading.current_thread()
            key, name = ("thread", th.ident), th.name
        else:
            key, name = ("named", track), track
        with self._lock:
            tid = self._tracks.get(key)
            if tid is None:
                tid = len(self._tracks)
                self._tracks[key] = tid
                self._track_names[tid] = name
            return tid

    def track_names(self) -> dict[int, str]:
        with self._lock:
            return dict(self._track_names)

    def emit(self, name: str, cat: str, t0: float, t1: float, *,
             track: str | None = None, **args) -> None:
        """Record a span timed by the caller (the seams hold their own
        ``perf_counter`` readings)."""
        ev = SpanEvent(name=name, cat=cat, t0=t0, t1=t1,
                       track=self._track_id(track), args=args)
        with self._lock:
            self.events.append(ev)

    def instant(self, name: str, cat: str, *, track: str | None = None,
                **args) -> None:
        t = time.perf_counter()
        ev = SpanEvent(name=name, cat=cat, t0=t, t1=t,
                       track=self._track_id(track), phase="i", args=args)
        with self._lock:
            self.events.append(ev)

    @contextlib.contextmanager
    def span(self, name: str, cat: str, *, track: str | None = None,
             **args) -> Iterator[dict]:
        """A span around a block; yields its args dict, so the block may
        attach results before the span ends."""
        t0 = time.perf_counter()
        try:
            yield args
        finally:
            self.emit(name, cat, t0, time.perf_counter(), track=track,
                      **args)

    def spans(self, cat: str | None = None,
              name: str | None = None) -> list[SpanEvent]:
        with self._lock:
            evs = list(self.events)
        return [e for e in evs
                if (cat is None or e.cat == cat)
                and (name is None or e.name == name)]

    def export_chrome_trace(self, path: str) -> None:
        """Chrome ``trace_event`` JSON, one track per thread or host, times
        in unrounded float microseconds from the trace epoch (an overlap
        recomputed from the file matches the engine's to float
        precision)."""
        pid = os.getpid()
        out: list[dict] = [
            {"ph": "M", "pid": pid, "tid": tid, "name": "thread_name",
             "args": {"name": name}}
            for tid, name in sorted(self.track_names().items())]
        with self._lock:
            events = list(self.events)
        for e in sorted(events, key=lambda e: e.t0):
            rec = {"name": e.name, "cat": e.cat, "pid": pid, "tid": e.track,
                   "ts": (e.t0 - self.epoch) * 1e6, "ph": e.phase,
                   "args": e.args}
            if e.phase == "X":
                rec["dur"] = (e.t1 - e.t0) * 1e6
            else:
                rec["s"] = "t"
            out.append(rec)
        _atomic_write_json(path, {"traceEvents": out,
                                  "displayTimeUnit": "ms",
                                  "otherData": {
                                      "schema_version": SCHEMA_VERSION,
                                      "created_unix": self.created_unix}})

    def export_jsonl(self, path: str) -> None:
        """One JSON object a line: the meta record, the tracks, then the
        events in start order (:func:`read_jsonl_events` reads it)."""
        lines = [json.dumps({"type": "meta",
                             "schema_version": SCHEMA_VERSION,
                             "created_unix": self.created_unix})]
        lines += [json.dumps({"type": "track", "tid": tid, "name": name})
                  for tid, name in sorted(self.track_names().items())]
        with self._lock:
            events = list(self.events)
        for e in sorted(events, key=lambda e: e.t0):
            lines.append(json.dumps({
                "type": "span" if e.phase == "X" else "instant",
                "name": e.name, "cat": e.cat, "tid": e.track,
                "t0": e.t0 - self.epoch, "t1": e.t1 - self.epoch,
                "args": e.args}))
        _atomic_write_text(path, "\n".join(lines) + "\n")


def read_jsonl_events(path: str) -> list[dict]:
    """The records of a :meth:`Tracer.export_jsonl` file."""
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                out.append(json.loads(line))
    return out


class Counter:
    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def inc(self, v: float = 1.0) -> None:
        self.value += v


class Gauge:
    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)


class Histogram:
    """Every observation kept: the engine observes per wave or per round,
    so the counts are small and no bucket bounds are needed."""
    __slots__ = ("samples",)

    def __init__(self):
        self.samples: list[float] = []

    def observe(self, v: float) -> None:
        self.samples.append(float(v))

    def summary(self) -> dict:
        s = sorted(self.samples)
        n = len(s)
        if n == 0:
            return {"count": 0, "sum": 0.0}
        return {"count": n, "sum": sum(s), "min": s[0], "max": s[-1],
                "mean": sum(s) / n, "p50": s[n // 2],
                "p95": s[min(n - 1, int(0.95 * n))]}


class MetricsRegistry:
    """Labelled counters, gauges and histograms behind one lock, keyed
    ``name{k=v,...}`` with the labels sorted; :meth:`snapshot` is the
    JSON-able export."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: dict[str, Counter] = {}
        self._gauges: dict[str, Gauge] = {}
        self._histograms: dict[str, Histogram] = {}

    @staticmethod
    def _key(name: str, labels: dict) -> str:
        if not labels:
            return name
        inner = ",".join(f"{k}={labels[k]}" for k in sorted(labels))
        return f"{name}{{{inner}}}"

    def _get(self, store: dict, cls, name: str, labels: dict):
        key = self._key(name, labels)
        with self._lock:
            inst = store.get(key)
            if inst is None:
                inst = store[key] = cls()
            return inst

    def counter(self, name: str, **labels) -> Counter:
        return self._get(self._counters, Counter, name, labels)

    def gauge(self, name: str, **labels) -> Gauge:
        return self._get(self._gauges, Gauge, name, labels)

    def histogram(self, name: str, **labels) -> Histogram:
        return self._get(self._histograms, Histogram, name, labels)

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "counters": {k: c.value for k, c in self._counters.items()},
                "gauges": {k: g.value for k, g in self._gauges.items()},
                "histograms": {k: h.summary()
                               for k, h in self._histograms.items()},
            }

    def export_json(self, path: str) -> None:
        _atomic_write_json(path, {"schema_version": SCHEMA_VERSION,
                                  **self.snapshot()})


def feed_result_metrics(registry: MetricsRegistry, result) -> None:
    """Project a ``TreeResult``'s ``engine_stats``, ``fault_stats``,
    ``checkpoint_stats`` and solve depths onto ``registry``, under the JAX
    package's keys (``engine.h2d_s`` is the port's one addition)."""
    es: EngineStats | None = getattr(result, "engine_stats", None)
    if es is not None:
        lab = {"engine": es.engine}
        registry.counter("engine.waves", **lab).inc(es.waves)
        registry.counter("engine.bytes_moved", **lab).inc(es.bytes_moved)
        registry.gauge("engine.overlap_ratio", **lab).set(es.overlap_ratio)
        registry.gauge("engine.max_in_flight", **lab).set(es.max_in_flight)
        for t in es.traces:
            registry.histogram("engine.gather_s", **lab).observe(t.gather_s)
            registry.histogram("engine.h2d_s", **lab).observe(t.h2d_s)
            registry.histogram("engine.solve_s", **lab).observe(t.solve_s)
            registry.histogram("engine.stall_s", **lab).observe(t.stall_s)
            registry.histogram("engine.wave_machines", **lab).observe(
                t.machines)
    fs: FaultStats | None = getattr(result, "fault_stats", None)
    if fs is not None:
        registry.counter("faults.retries").inc(fs.retries)
        registry.counter("faults.hedges").inc(fs.hedges)
        registry.counter("faults.hedges_won").inc(fs.hedges_won)
        registry.counter("faults.evictions").inc(fs.evictions)
        registry.counter("faults.dropped_rows").inc(fs.dropped_rows)
        registry.counter("faults.backoff_s").inc(fs.backoff_s)
    cs: CheckpointStats | None = getattr(result, "checkpoint_stats", None)
    if cs is not None:
        lab = {"mode": cs.mode}
        for r in cs.rounds:
            registry.histogram("ckpt.write_s", **lab).observe(r.write_s)
            registry.histogram("ckpt.wait_s", **lab).observe(r.wait_s)
        registry.gauge("ckpt.hidden_fraction", **lab).set(cs.hidden_fraction)
    depths = getattr(result, "depth_per_round", None)
    if depths:
        registry.gauge("solve.depth_total").set(
            int(getattr(result, "solve_depth", 0)))
        for dv in depths:
            registry.histogram("solve.depth_per_round").observe(int(dv))


def wave_overlap_from_spans(gathers: list[tuple[float, float]],
                            solves: list[tuple[float, float]]
                            ) -> tuple[float, float]:
    """``(span_wall, overlap_ratio)`` from raw span intervals, the
    arithmetic ``EngineStats`` applies to its waves' stamps.  Here the
    device side is the stage and solve spans together: pass both lists'
    intervals as ``solves``."""
    if not gathers or not solves:
        return 0.0, 0.0
    g = sum(t1 - t0 for t0, t1 in gathers)
    s = sum(t1 - t0 for t0, t1 in solves)
    wall = max(t1 for _, t1 in solves + gathers) - min(
        t0 for t0, _ in solves + gathers)
    if g <= 0.0:
        return wall, 0.0
    return wall, min(1.0, max(0.0, (g + s - wall) / g))


def top_spans(events: list[SpanEvent], limit: int = 10) -> list[dict]:
    """Spans aggregated by ``(cat, name)``: count, total and mean seconds,
    the largest total first."""
    agg: dict[tuple[str, str], list[float]] = {}
    for e in events:
        if e.phase == "X":
            agg.setdefault((e.cat, e.name), []).append(e.dur_s)
    rows = [{"cat": c, "name": n, "count": len(d), "total_s": sum(d),
             "mean_s": sum(d) / len(d)} for (c, n), d in agg.items()]
    rows.sort(key=lambda r: -r["total_s"])
    return rows[:limit]


MANIFEST_NAME = "run_manifest.json"

#: the fields a valid manifest carries
MANIFEST_REQUIRED = ("schema_version", "config", "config_fingerprint",
                     "dtype", "run", "phases")


@dataclasses.dataclass
class RunManifest:
    """A run's identity and outcome, written atomically next to the
    checkpoints; :func:`format_report` prints from it, so the manifest
    and the console never disagree.  Floats are kept unrounded."""
    config: dict
    config_fingerprint: str
    run: dict                               # n, d, k, mu, value, rounds, ...
    dtype: str = "fp32"
    source_fingerprint: str | None = None
    schema_version: int = SCHEMA_VERSION
    created_unix: float = 0.0
    engine: dict | None = None
    ingest: dict | None = None
    bytes: dict | None = None
    faults: dict | None = None              # counters + replay_signature
    checkpoint: dict | None = None
    phases: dict = dataclasses.field(default_factory=dict)
    feasibility: dict | None = None
    recheck: dict | None = None
    serve: dict | None = None               # the selection service's
    #                                         counters, once it is ported
    adaptivity: dict | None = None          # sequential solve depth

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    def write(self, path: str) -> str:
        if not self.created_unix:
            self.created_unix = time.time()
        _atomic_write_json(path, self.to_dict())
        return path

    @classmethod
    def load(cls, path: str) -> "RunManifest":
        """Unknown keys are dropped and missing required sections default
        to empty, so :meth:`validate` reports a truncated manifest instead
        of the load failing on it."""
        with open(path) as f:
            data = json.load(f)
        known = {f.name for f in dataclasses.fields(cls)}
        merged: dict = {"config": {}, "config_fingerprint": "", "run": {}}
        merged.update({k: v for k, v in data.items() if k in known})
        return cls(**merged)

    def validate(self) -> list[str]:
        """Problems of this manifest (empty: valid)."""
        problems = []
        d = self.to_dict()
        for field in MANIFEST_REQUIRED:
            if d.get(field) in (None, {}, ""):
                problems.append(f"missing required field {field!r}")
        for field in ("value", "rounds", "oracle_calls"):
            if field not in self.run:
                problems.append(f"run section missing {field!r}")
        if self.engine is not None:
            for field in ("engine", "wall_s", "gather_s", "solve_s",
                          "overlap_ratio", "width_trajectory"):
                if field not in self.engine:
                    problems.append(f"engine section missing {field!r}")
        return problems


def config_fingerprint(cfg) -> str:
    """A stable hash of a ``TreeConfig``, telemetry left out (attaching a
    tracer does not change which run this is)."""
    return hashlib.sha256(json.dumps(
        config_dict(cfg), sort_keys=True).encode()).hexdigest()[:16]


def config_dict(cfg) -> dict:
    """A JSON-able view of a ``TreeConfig`` without its telemetry field."""
    out = {}
    for f in dataclasses.fields(cfg):
        if f.name == "telemetry":
            continue
        v = getattr(cfg, f.name)
        if dataclasses.is_dataclass(v):
            v = dataclasses.asdict(v)
        out[f.name] = v
    return out


def build_manifest(cfg, result, *, n: int, d: int, dtype_label: str,
                   itemsize: int = 4, qcols: int = 0,
                   source_fingerprint: str | None = None,
                   dataset: str | None = None) -> RunManifest:
    """The manifest of a finished ``TreeResult``, with or without a tracer
    attached to the run."""
    run = {"n": n, "d": d, "k": cfg.k, "mu": cfg.capacity,
           "algorithm": cfg.algorithm, "seed": cfg.seed,
           "value": float(result.value), "rounds": int(result.rounds),
           "oracle_calls": int(result.oracle_calls),
           "machines_per_round": list(result.machines_per_round),
           "round_values": [float(v) for v in result.round_values]}
    if dataset is not None:
        run["dataset"] = dataset
    m = RunManifest(config=config_dict(cfg),
                    config_fingerprint=config_fingerprint(cfg),
                    run=run, dtype=dtype_label,
                    source_fingerprint=source_fingerprint)
    es = result.engine_stats
    if es is not None:
        m.engine = {
            "engine": es.engine, "hosts": es.hosts, "waves": es.waves,
            "wall_s": es.wall_s, "span_wall_s": es.span_wall_s,
            "gather_s": es.gather_s, "h2d_s": es.h2d_s,
            "solve_s": es.solve_s,
            "stall_s": sum(t.stall_s for t in es.traces),
            "bytes_moved": es.bytes_moved,
            "overlap_ratio": es.overlap_ratio,
            "overlap_ratio_legacy": es.overlap_ratio_legacy,
            "max_in_flight": es.max_in_flight,
            "width_trajectory": es.width_trajectory,
            "distinct_shapes": es.distinct_shapes,
        }
    ing = result.ingest
    if ing is not None:
        m.ingest = {
            "wave_machines": ing.wave_machines, "waves": ing.waves,
            "peak_wave_rows": ing.peak_wave_rows,
            "peak_wave_bytes": ing.peak_wave_bytes,
            "attr_dim": ing.attr_dim, "total_bytes": ing.total_bytes,
            "wall_seconds": ing.wall_seconds,
        }
        row_bytes = d * itemsize + (ing.attr_dim + qcols) * 4
        fp32_row_bytes = (d + ing.attr_dim) * 4
        m.bytes = {"dtype": dtype_label, "itemsize": itemsize,
                   "qcols": qcols, "row_bytes": row_bytes,
                   "fp32_row_bytes": fp32_row_bytes,
                   "resident_bytes": n * row_bytes}
    fs = result.fault_stats
    if fs is not None:
        m.faults = {**fs.summary(),
                    "recovered_s": fs.recovered_s,
                    "backoff_s": fs.backoff_s,
                    "replay_signature": fs.replay_signature()}
    cs = result.checkpoint_stats
    if cs is not None:
        m.checkpoint = {"mode": cs.mode, "rounds": len(cs.rounds),
                        "write_s": cs.write_s, "wait_s": cs.wait_s,
                        "hidden_s": cs.hidden_s,
                        "hidden_fraction": cs.hidden_fraction}
    depths = result.depth_per_round
    if depths:
        # greedy pays k dependent launches a round: the adaptivity baseline
        greedy_depth = cfg.k * int(result.rounds)
        m.adaptivity = {
            "algorithm": cfg.algorithm, "eps": cfg.eps,
            "solve_depth": int(result.solve_depth),
            "depth_per_round": [int(v) for v in depths],
            "greedy_depth": greedy_depth,
            "reduction": (greedy_depth / result.solve_depth
                          if result.solve_depth else 0.0),
        }
    walls = result.round_walls or []
    m.phases = {
        "total_wall_s": float(result.total_wall_s or 0.0),
        "round0_wall_s": float(walls[0]) if walls else 0.0,
        "later_rounds_wall_s": float(sum(walls[1:])),
        "checkpoint_write_s": cs.write_s if cs is not None else 0.0,
        "checkpoint_wait_s": cs.wait_s if cs is not None else 0.0,
    }
    return m


def format_report(m: RunManifest) -> list[str]:
    """The report lines of a run (prefixes ``TREE:``, ``ingest:``,
    ``bytes:``, ``engine:``, ``autotune:``, ``faults:``, ``checkpoint:``,
    ``adaptivity:``, ``feasibility:``, ``recheck:``, ``serve:``), the JAX
    package's lines byte for byte for the same manifest."""
    r, lines = m.run, []
    lines.append(f"TREE: f={r['value']:.6f} rounds={r['rounds']} "
                 f"machines/round={r['machines_per_round']} "
                 f"oracle_calls={r['oracle_calls']}")
    if m.ingest is not None and m.bytes is not None:
        ing, by = m.ingest, m.bytes
        lines.append(
            f"ingest: W={ing['wave_machines']} waves={ing['waves']} "
            f"peak_wave_rows={ing['peak_wave_rows']} "
            f"peak_wave_bytes={ing['peak_wave_bytes']} "
            f"attr_dim={ing['attr_dim']} "
            f"(resident would hold {by['resident_bytes']} bytes)")
        lines.append(
            f"bytes: dtype={by['dtype']} itemsize={by['itemsize']} "
            f"row_bytes={by['row_bytes']} "
            f"fp32_row_bytes={by['fp32_row_bytes']} "
            f"saved={1.0 - by['row_bytes'] / by['fp32_row_bytes']:.1%} "
            f"peak_wave_bytes={ing['peak_wave_bytes']} "
            f"total_bytes={ing['total_bytes']}")
    if m.engine is not None:
        es = m.engine
        lines.append(
            f"engine: {es['engine']} hosts={es['hosts']} "
            f"wall={es['wall_s']:.3f}s gather={es['gather_s']:.3f}s "
            f"solve={es['solve_s']:.3f}s overlap={es['overlap_ratio']:.2%} "
            f"bytes={es['bytes_moved']} "
            f"max_in_flight={es['max_in_flight']}")
        if m.config.get("wave_autotune"):
            lines.append(f"autotune: widths={es['width_trajectory']} "
                         f"distinct_shapes={es['distinct_shapes']}")
    if m.faults is not None:
        fs = m.faults
        lines.append(
            f"faults: retries={fs['retries']} hedges={fs['hedges']} "
            f"hedges_won={fs['hedges_won']} evictions={fs['evictions']} "
            f"dropped_waves={fs['dropped_waves']} "
            f"dropped_rows={fs['dropped_rows']}/{fs['total_rows']} "
            f"dropped_fraction={fs['dropped_fraction']:.4f} "
            f"recovered={fs['recovered_s']:.3f}s "
            f"backoff={fs['backoff_s']:.3f}s")
    if m.checkpoint is not None:
        ck = m.checkpoint
        lines.append(
            f"checkpoint: {ck['mode']} rounds={ck['rounds']} "
            f"write={ck['write_s']:.3f}s stalled={ck['wait_s']:.3f}s "
            f"hidden={ck['hidden_fraction']:.2%}")
    if m.adaptivity is not None:
        ad = m.adaptivity
        lines.append(
            f"adaptivity: alg={ad['algorithm']} eps={ad['eps']} "
            f"solve_depth={ad['solve_depth']} "
            f"depth/round={ad['depth_per_round']} "
            f"greedy_depth={ad['greedy_depth']} "
            f"reduction={ad['reduction']:.1f}x")
    if m.feasibility is not None:
        fz = m.feasibility
        lines.append(f"feasibility: {'OK' if fz['ok'] else 'VIOLATED'} "
                     f"({fz['detail']})")
    if m.recheck is not None:
        rc = m.recheck
        lines.append(f"recheck: fp32={rc['fp32']:.6f} "
                     f"solve={rc['solve']:.6f} "
                     f"rel_gap={rc['rel_gap']:.2e} {rc['status']}")
    if m.serve is not None:
        sv = m.serve
        lines.append(
            f"serve: requests={sv['requests']} batches={sv['batches']} "
            f"p50_ms={sv['latency_p50_ms']:.3f} "
            f"p95_ms={sv['latency_p95_ms']:.3f} "
            f"qdepth_max={sv['queue_depth_max']}")
        lines.append(
            f"serve: compile-cache keys={sv['cache_keys']} "
            f"compiles={sv['compiles']} hits={sv['cache_hits']} "
            f"steady_retraces={sv['steady_retraces']}")
        lines.append(
            f"serve: deltas={sv['deltas']} "
            f"changed_machines={sv['changed_machines']} "
            f"rebuilds={sv['rebuilds']}")
    return lines


PROFILE_TRACE_NAME = "torch_profile.json"


@contextlib.contextmanager
def profiler_session(profile_dir: str | None) -> Iterator[Any]:
    """A ``torch.profiler`` session around a block, its Chrome trace
    written to ``profile_dir/torch_profile.json`` at the end (CPU
    activity, and CUDA activity where a card is present); a no-op without
    a directory.  Yields the profiler (None for the no-op).  A profiler
    that does not start degrades to the no-op with a warning: profiling
    never fails the run."""
    if not profile_dir:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = None
    try:
        os.makedirs(profile_dir, exist_ok=True)
        prof = profile(activities=activities)
        prof.__enter__()
    except Exception as exc:                   # pragma: no cover - env dep
        import warnings
        warnings.warn(f"torch.profiler unavailable ({exc}); continuing "
                      f"without a device profile", RuntimeWarning)
        prof = None
    try:
        yield prof
    finally:
        if prof is not None:
            prof.__exit__(None, None, None)
            prof.export_chrome_trace(
                os.path.join(profile_dir, PROFILE_TRACE_NAME))


def _atomic_write_text(path: str, text: str) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        f.write(text)
    os.replace(tmp, path)


def _atomic_write_json(path: str, obj) -> None:
    _atomic_write_text(path, json.dumps(obj, indent=1, sort_keys=True))
