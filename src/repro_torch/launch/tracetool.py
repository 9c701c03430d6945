"""Trace inspector for the unified telemetry layer (counterpart of
``repro.launch.tracetool``).

    PYTHONPATH=src python -m repro_torch.launch.tracetool trace.json \
        [--manifest run_manifest.json] [--limit N] [--tol 1e-6]

Reads a trace exported by either package's ``Tracer``
(:class:`repro_torch.engine.telemetry.Tracer` writes the JAX package's
formats) — the Chrome ``trace_event`` JSON (``--trace-out``) or the JSONL
structured-event log — and prints:

  * an event census (spans / instants / tracks),
  * the top span groups by total seconds (``top_spans``),
  * the wave overlap ratio **recomputed from the raw gather/solve span
    intervals** (:func:`wave_overlap_from_spans` — the same arithmetic
    ``EngineStats`` applies to its ``WaveTrace`` timestamps).

With ``--manifest`` it additionally validates the :class:`RunManifest`
(required fields present) and cross-checks the manifest's reported
``engine.overlap_ratio`` against the span-recomputed value to ``--tol``
(default 1e-6): the console report, the manifest, and the trace file are
three views of one event stream, and this tool proves they agree.

Exit status is non-zero on any validation or cross-check failure, so CI
can gate on it directly (grep the ``cross-check: ... PASS`` line).
"""
from __future__ import annotations

import argparse
import json
import sys

from repro_torch.engine.telemetry import (RunManifest, SpanEvent,
                                          read_jsonl_events,
                                          top_spans, wave_overlap_from_spans)


def load_trace(path: str) -> tuple[list[SpanEvent], dict[int, str]]:
    """Parse either trace format back into ``SpanEvent`` records.

    Chrome export stores microseconds relative to the trace epoch, JSONL
    stores seconds; both come back as seconds here.  Unrounded floats
    survive the JSON round-trip exactly, so overlap reconstruction holds
    to float precision.
    """
    with open(path) as f:
        text = f.read()
    try:
        doc = json.loads(text)
    except json.JSONDecodeError:
        doc = None                  # multiple lines → JSONL
    events: list[SpanEvent] = []
    tracks: dict[int, str] = {}
    if isinstance(doc, dict) and "traceEvents" in doc:
        for rec in doc["traceEvents"]:
            ph = rec.get("ph")
            if ph == "M" and rec.get("name") == "thread_name":
                tracks[rec["tid"]] = rec["args"]["name"]
            elif ph in ("X", "i"):
                t0 = rec["ts"] / 1e6
                t1 = t0 + (rec.get("dur", 0.0) / 1e6)
                events.append(SpanEvent(
                    name=rec["name"], cat=rec.get("cat", ""), t0=t0, t1=t1,
                    track=rec["tid"], phase=ph, args=rec.get("args", {})))
    else:
        for rec in read_jsonl_events(path):
            kind = rec.get("type")
            if kind == "track":
                tracks[rec["tid"]] = rec["name"]
            elif kind in ("span", "instant"):
                events.append(SpanEvent(
                    name=rec["name"], cat=rec["cat"], t0=rec["t0"],
                    t1=rec["t1"], track=rec["tid"],
                    phase="X" if kind == "span" else "i",
                    args=rec.get("args", {})))
    return events, tracks


def span_overlap(events: list[SpanEvent]) -> tuple[float, float, int]:
    """``(span_wall, overlap, n_waves)`` from the wave-category spans: the
    gather spans against the device side, which is the stage (H2D) and
    solve spans together, as ``EngineStats`` counts it.  A JAX package
    trace has no stage spans, so its solve spans alone are the device side
    there, as the JAX tool reads them."""
    def spans(name):
        return [(e.t0, e.t1) for e in events
                if e.cat == "wave" and e.name == name and e.phase == "X"]

    solves = spans("solve")
    wall, ov = wave_overlap_from_spans(spans("gather"),
                                       spans("stage") + solves)
    return wall, ov, len(solves)


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("trace", help="Chrome trace JSON or JSONL event log")
    ap.add_argument("--manifest", default=None,
                    help="RunManifest JSON to validate and cross-check "
                         "against the trace")
    ap.add_argument("--limit", type=int, default=10,
                    help="top span groups to print")
    ap.add_argument("--tol", type=float, default=1e-6,
                    help="overlap cross-check tolerance")
    args = ap.parse_args(argv)

    events, tracks = load_trace(args.trace)
    n_spans = sum(1 for e in events if e.phase == "X")
    n_inst = len(events) - n_spans
    print(f"trace: {len(events)} events ({n_spans} spans, "
          f"{n_inst} instants) tracks={len(tracks)}")
    for tid in sorted(tracks):
        print(f"  track {tid}: {tracks[tid]}")

    print(f"top spans (by total seconds, limit={args.limit}):")
    for row in top_spans(events, limit=args.limit):
        print(f"  {row['cat']}/{row['name']}: count={row['count']} "
              f"total={row['total_s']:.3f}s mean={row['mean_s']:.4f}s")

    wall, ov, n_waves = span_overlap(events)
    if n_waves:
        print(f"overlap(spans): waves={n_waves} wall={wall:.3f}s "
              f"overlap={ov:.2%}")

    status = 0
    if args.manifest:
        m = RunManifest.load(args.manifest)
        problems = m.validate()
        if problems:
            status = 1
            for p in problems:
                print(f"manifest: INVALID — {p}")
        else:
            print(f"manifest: OK fingerprint={m.config_fingerprint} "
                  f"dtype={m.dtype} value={m.run['value']:.6f} "
                  f"rounds={m.run['rounds']}")
        if m.engine is not None and n_waves:
            want = float(m.engine["overlap_ratio"])
            delta = abs(want - ov)
            ok = delta <= args.tol
            status = status or (0 if ok else 2)
            print(f"cross-check: overlap manifest={want:.6f} "
                  f"spans={ov:.6f} delta={delta:.2e} "
                  f"{'PASS' if ok else 'FAIL'} (tol={args.tol:g})")
    elif not events:
        status = 1
        print("trace: EMPTY — no events")
    return status


if __name__ == "__main__":
    sys.exit(main())
