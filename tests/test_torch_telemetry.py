"""The port's telemetry against the JAX package on the CPU
(``tests/test_telemetry.py``'s counterpart; its trace-tool tests wait for
the port of ``launch/tracetool.py``): spans, tracks and thread safety, the
Chrome and JSONL exports, the registry's keys, the engine's, planner's,
supervisor's and checkpoint writer's spans, an instrumented run equal to
an uninstrumented one, the run manifest (atomic, validated, printed as the
JAX package prints it) and the sources' fingerprints."""
import json
import os
import threading

import jax.numpy as jnp
import numpy as np
import pytest

from repro.core import ExemplarClustering as JExemplar
from repro.core import TreeConfig as JTreeConfig
from repro.core import tree_maximize as jtree
from repro.core import sources as jsrc
from repro.data import sources as jdsrc
from repro.engine import telemetry as jtel
from repro.engine import FaultPolicy as JFaultPolicy
from repro_torch.convert import objective_from_numpy
from repro_torch.core import (ArraySource, ChunkedSource, Knapsack,
                              QuantizedSource, TreeConfig, tree_maximize)
from repro_torch.data.sources import ShardedSource
from repro_torch.engine import (CATEGORIES, MANIFEST_NAME, SCHEMA_VERSION,
                                FaultInjector, FaultPolicy, FaultProfile,
                                MetricsRegistry, RunManifest, Tracer,
                                build_manifest, config_fingerprint,
                                dtype_label, feed_result_metrics,
                                format_report, profiler_session,
                                read_jsonl_events, top_spans,
                                wave_overlap_from_spans)
from repro_torch.engine.telemetry import PROFILE_TRACE_NAME

from _torch_parity import assert_same_tree, jax_tree_plan, tree_inputs


def _run(data, obj, *, tracer=None, engine="sync", dtype=None,
         constraint=None, attrs=None, W=3, **cfg_kw):
    src = ChunkedSource.from_array(data, 128, attrs=attrs)
    if dtype is not None and dtype != "fp32":
        src = QuantizedSource(src, dtype)
    cfg = TreeConfig(k=6, capacity=60, seed=4, engine=engine,
                     telemetry=tracer, **cfg_kw)
    return tree_maximize(obj, src, cfg, device="cpu", wave_machines=W,
                         constraint=constraint)


def _setup(seed=0):
    data, E = tree_inputs(n=601, ne=96, seed=seed)
    return data, objective_from_numpy(E, "cpu")


# -- the tracer ---------------------------------------------------------


def test_span_context_manager_nests_and_orders():
    tr = Tracer()
    with tr.span("outer", "round", step=1) as args:
        with tr.span("inner", "wave"):
            pass
        args["rows"] = 7
    inner, outer = tr.spans()
    assert (inner.name, outer.name) == ("inner", "outer")     # end order
    assert outer.t0 <= inner.t0 <= inner.t1 <= outer.t1
    assert outer.args == {"step": 1, "rows": 7}
    assert tr.spans(cat="wave") == [inner]
    assert tr.spans(name="outer") == [outer]


def test_instants_and_named_tracks():
    tr = Tracer()
    tr.instant("evict", "fault", host=2)
    tr.emit("host-gather", "host", 1.0, 2.0, track="host-1", rows=5)
    ev_i, ev_x = tr.events
    assert ev_i.phase == "i" and ev_i.t0 == ev_i.t1
    assert ev_x.phase == "X" and ev_x.dur_s == 1.0
    names = tr.track_names()
    assert names[ev_i.track] == threading.current_thread().name
    assert names[ev_x.track] == "host-1"
    assert CATEGORIES == jtel.CATEGORIES


def test_tracer_thread_safety():
    tr = Tracer()
    n_threads, n_spans = 8, 200
    gate = threading.Barrier(n_threads)   # every thread alive at once

    def work(i):
        gate.wait(timeout=30)
        for j in range(n_spans):
            with tr.span(f"w{i}", "wave", j=j):
                pass

    threads = [threading.Thread(target=work, args=(i,), name=f"t{i}")
               for i in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert len(tr.events) == n_threads * n_spans
    assert sorted(tr.track_names().values()) == sorted(
        f"t{i}" for i in range(n_threads))


def test_chrome_trace_and_jsonl_round_trips(tmp_path):
    tr = Tracer()
    with tr.span("gather", "wave", wave=0, rows=10):
        pass
    tr.instant("hedge", "fault", wave=0)
    path = str(tmp_path / "trace.json")
    tr.export_chrome_trace(path)
    doc = json.load(open(path))
    assert doc["otherData"]["schema_version"] == SCHEMA_VERSION == \
        jtel.SCHEMA_VERSION
    evs = doc["traceEvents"]
    assert [e for e in evs if e["ph"] == "M"][0]["name"] == "thread_name"
    (x,) = [e for e in evs if e["ph"] == "X"]
    (i,) = [e for e in evs if e["ph"] == "i"]
    assert x["cat"] == "wave" and x["args"] == {"wave": 0, "rows": 10}
    assert abs(x["dur"] / 1e6 - tr.events[0].dur_s) < 1e-12
    assert i["s"] == "t"
    jpath = str(tmp_path / "events.jsonl")
    tr.export_jsonl(jpath)
    recs = read_jsonl_events(jpath)
    assert recs == jtel.read_jsonl_events(jpath)
    assert recs[0]["type"] == "meta"
    span = next(r for r in recs if r["type"] == "span")
    assert span["t0"] == tr.events[0].t0 - tr.epoch        # exact
    assert span["t1"] == tr.events[0].t1 - tr.epoch
    assert [r["type"] for r in recs].count("track") == 1


def test_registry_keys_and_summaries_equal_jax(tmp_path):
    ours, theirs = MetricsRegistry(), jtel.MetricsRegistry()
    for reg in (ours, theirs):
        reg.counter("engine.waves", engine="sync").inc(3)
        reg.counter("engine.waves", engine="sync").inc()
        reg.gauge("overlap", engine="pipelined").set(0.75)
        h = reg.histogram("gather_s", host=1, engine="pipelined")
        for v in (0.1, 0.3, 0.2, 0.7, 0.05):
            h.observe(v)
    assert ours.snapshot() == theirs.snapshot()
    path = str(tmp_path / "metrics.json")
    ours.export_json(path)
    assert json.load(open(path))["counters"] == {
        "engine.waves{engine=sync}": 4.0}


def test_span_views_equal_jax():
    gathers = [(0.0, 1.0), (1.0, 2.0)]
    solves = [(1.0, 3.0), (3.0, 4.0)]
    for g, s in ((gathers, solves), ([], []), ([(0.0, 1.0)], [(1.5, 2.0)]),
                 ([(0.0, 0.0)], [(0.0, 1.0)])):
        assert wave_overlap_from_spans(g, s) == \
            jtel.wave_overlap_from_spans(g, s)
    tr, jtr = Tracer(), jtel.Tracer()
    for t in (tr, jtr):
        for w in range(3):
            t.emit("gather", "wave", 0.0, 1.0, wave=w)
        t.emit("solve", "wave", 0.0, 5.0)
        t.instant("hedge", "fault")
    assert top_spans(tr.events) == top_spans(jtr.events)
    assert top_spans(tr.events)[1] == {"cat": "wave", "name": "gather",
                                       "count": 3, "total_s": 3.0,
                                       "mean_s": 1.0}


def test_dtype_label_vocabulary():
    import torch
    assert dtype_label(np.float32) == jtel.dtype_label(np.float32) == "fp32"
    assert dtype_label(np.int8) == jtel.dtype_label(np.int8) == "int8"
    assert dtype_label(np.uint16) == dtype_label(torch.bfloat16) == \
        jtel.dtype_label(jnp.bfloat16) == "bf16"
    assert dtype_label(np.float64) == jtel.dtype_label(np.float64)


# -- the engine's spans -------------------------------------------------


def test_span_counts_pipelined_equal_sync():
    data, obj = _setup(3)
    tr_s, tr_p = Tracer(), Tracer()
    a = _run(data, obj, tracer=tr_s, engine="sync")
    b = _run(data, obj, tracer=tr_p, engine="pipelined")
    assert_same_tree(a, b)
    for name in ("gather", "stage", "solve"):
        assert (len(tr_s.spans(cat="wave", name=name))
                == len(tr_p.spans(cat="wave", name=name))
                == a.engine_stats.waves)
    for tr, res in ((tr_s, a), (tr_p, b)):
        assert len(tr.spans(cat="run")) == 1
        assert len(tr.spans(cat="round")) == res.rounds
        assert [s.args["depth"] for s in tr.spans(cat="round")] == \
            res.depth_per_round
    assert tr_s.spans(cat="stall") == []
    assert "wave-prefetch" in tr_p.track_names().values()
    snap = tr_p.metrics.snapshot()["histograms"]
    assert snap["scheduler.stall_s{side=consumer}"]["count"] == b.engine_stats.waves


def test_trace_overlap_equals_engine_stats(tmp_path):
    data, obj = _setup(7)
    tr = Tracer()
    res = _run(data, obj, tracer=tr, engine="pipelined")
    path = str(tmp_path / "trace.json")
    tr.export_chrome_trace(path)
    doc = json.load(open(path))["traceEvents"]

    def spans(name):
        return [(e["ts"] / 1e6, (e["ts"] + e["dur"]) / 1e6) for e in doc
                if e["ph"] == "X" and e["cat"] == "wave"
                and e["name"] == name]

    es = res.engine_stats
    _, ov = wave_overlap_from_spans(spans("gather"),
                                    spans("stage") + spans("solve"))
    assert abs(ov - es.overlap_ratio) < 1e-9
    g = [(s.t0, s.t1) for s in tr.spans("wave", "gather")]
    dev = [(s.t0, s.t1) for s in tr.spans("wave", "stage")
           + tr.spans("wave", "solve")]
    wall, ov = wave_overlap_from_spans(g, dev)
    assert abs(ov - es.overlap_ratio) < 1e-9
    assert abs(wall - es.span_wall_s) < 1e-9
    assert es.overlap_ratio_legacy <= es.overlap_ratio + 1e-12


def test_host_gather_spans_on_named_tracks():
    data, obj = _setup(9)
    tr = Tracer()
    res = _run(data, obj, tracer=tr, engine="pipelined", hosts=2)
    host_spans = tr.spans(cat="host", name="host-gather")
    names = tr.track_names()
    assert {names[s.track] for s in host_spans} == {"host-0", "host-1"}
    assert {s.args["wave"] for s in host_spans} == set(
        range(res.engine_stats.waves))
    assert all(s.args["rows"] > 0 for s in host_spans)


def test_fault_and_checkpoint_spans(tmp_path):
    data, obj = _setup(11)
    tr = Tracer()
    res = _run(data, obj, tracer=tr, engine="pipelined", hosts=3,
               fault_policy=FaultPolicy(backoff_s=0.001, hedge=False),
               checkpoint_dir=str(tmp_path), async_checkpoint=True)
    clean = _run(data, obj, engine="pipelined", hosts=3)
    assert_same_tree(res, clean)
    tr2 = Tracer()
    src = ChunkedSource.from_array(data, 128)
    inj = FaultInjector(FaultProfile(transient_rate=0.3, dead_host=1,
                                     dead_host_wave=1, seed=2))
    faulted = tree_maximize(obj, src, TreeConfig(
        k=6, capacity=60, seed=4, engine="pipelined", hosts=3,
        fault_policy=FaultPolicy(backoff_s=0.001, hedge=False),
        telemetry=tr2), device="cpu", wave_machines=3, fault_injector=inj)
    assert_same_tree(faulted, clean)
    fs = faulted.fault_stats
    assert len(tr2.spans(cat="fault", name="retry-backoff")) == fs.retries > 0
    assert len(tr2.spans(cat="fault", name="evict")) == fs.evictions == 1
    assert tr2.spans(cat="fault", name="recovery")
    cs = res.checkpoint_stats
    writes = tr.spans(cat="ckpt", name="ckpt-write")
    assert [s.args["round"] for s in writes] == [r.round for r in cs.rounds]
    # the writes run on writer threads, off the caller's track (a finished
    # thread's ident may be reused, so the track's name is the first
    # thread's that held it)
    main = tr._track_id(None)
    assert all(s.track != main for s in writes)
    assert len(tr.spans(cat="ckpt", name="ckpt-snapshot")) == res.rounds


@pytest.mark.parametrize("engine", ["sync", "pipelined"])
@pytest.mark.parametrize("dtype", ["fp32", "int8"])
def test_instrumented_run_equals_uninstrumented(engine, dtype):
    data, obj = _setup(11)
    plain = _run(data, obj, engine=engine, dtype=dtype)
    traced = _run(data, obj, tracer=Tracer(), engine=engine, dtype=dtype)
    assert_same_tree(plain, traced)
    assert plain.manifest is None and traced.manifest is not None


def test_instrumented_constrained_autotuned_run_equals_jax_resident():
    data, E = tree_inputs(n=601, ne=96, seed=13)
    attrs = np.random.default_rng(7).uniform(0.2, 1.0, (601, 1)).astype(
        np.float32)
    from repro.core import Knapsack as JKnapsack
    jres = jtree(JExemplar(jnp.asarray(E)), jnp.asarray(data),
                 JTreeConfig(k=6, capacity=60, seed=4),
                 constraint=JKnapsack(budget=3.0, col=0), attrs=attrs)
    plan = jax_tree_plan(4, 60, jres.machines_per_round)
    tr = Tracer()
    res = tree_maximize(objective_from_numpy(E, "cpu"),
                        ArraySource(data, attrs=attrs),
                        TreeConfig(k=6, capacity=60, seed=4,
                                   engine="pipelined", wave_autotune=True,
                                   telemetry=tr), device="cpu", plan=plan,
                        constraint=Knapsack(budget=3.0, col=0))
    np.testing.assert_array_equal(res.sel_rows, np.asarray(jres.sel_rows))
    np.testing.assert_array_equal(res.sel_attrs, np.asarray(jres.sel_attrs))
    assert res.oracle_calls == int(jres.oracle_calls)
    assert res.manifest.engine["width_trajectory"] == \
        res.engine_stats.width_trajectory


def test_config_fingerprint_ignores_telemetry_and_equals_jax():
    a = TreeConfig(k=6, capacity=60, seed=4)
    b = TreeConfig(k=6, capacity=60, seed=4, telemetry=Tracer())
    c = TreeConfig(k=6, capacity=61, seed=4)
    assert config_fingerprint(a) == config_fingerprint(b)
    assert config_fingerprint(a) != config_fingerprint(c)
    for kw in ({}, dict(engine="pipelined", hosts=2, wave_autotune=True),
               dict(capacity_bytes=1 << 20, algorithm="threshold_batch")):
        assert config_fingerprint(TreeConfig(k=6, capacity=60, **kw)) == \
            jtel.config_fingerprint(JTreeConfig(k=6, capacity=60, **kw))
    pol = dict(max_retries=2, deadline_s=1.5)
    assert config_fingerprint(TreeConfig(
        k=6, capacity=60, fault_policy=FaultPolicy(**pol))) == \
        jtel.config_fingerprint(JTreeConfig(
            k=6, capacity=60, fault_policy=JFaultPolicy(**pol)))


# -- the run manifest ---------------------------------------------------


def test_manifest_written_next_to_checkpoints_and_valid(tmp_path):
    data, obj = _setup(15)
    tr = Tracer()
    res = _run(data, obj, tracer=tr, engine="pipelined", dtype="int8",
               checkpoint_dir=str(tmp_path))
    m = res.manifest
    assert m.validate() == []
    assert m.dtype == "int8" and m.source_fingerprint.endswith(
        "|q=int8:B=4096")
    assert m.run["value"] == float(res.value)
    assert m.engine["width_trajectory"] == res.engine_stats.width_trajectory
    assert m.phases["round0_wall_s"] == res.round_walls[0]
    assert m.faults is None
    on_disk = RunManifest.load(os.path.join(str(tmp_path), MANIFEST_NAME))
    assert on_disk.validate() == [] and on_disk.run == m.run
    assert jtel.RunManifest.load(os.path.join(
        str(tmp_path), MANIFEST_NAME)).validate() == []
    snap = tr.metrics.snapshot()
    assert snap["counters"]["engine.waves{engine=pipelined}"] == \
        res.engine_stats.waves


def test_manifest_atomic_under_a_kill_mid_write(tmp_path, monkeypatch):
    data, obj = _setup(17)
    res = _run(data, obj)
    m = build_manifest(TreeConfig(k=6, capacity=60, seed=4), res,
                       n=len(data), d=data.shape[1], dtype_label="fp32")
    path = str(tmp_path / "run_manifest.json")
    m.write(path)
    before = open(path).read()

    def boom(src, dst):
        raise KeyboardInterrupt("killed mid-write")

    monkeypatch.setattr(os, "replace", boom)
    m.run["value"] = -1.0
    with pytest.raises(KeyboardInterrupt):
        m.write(path)
    monkeypatch.undo()
    assert open(path).read() == before
    assert RunManifest.load(path).validate() == []


def test_manifest_validate_reports_missing_fields():
    m = RunManifest(config={}, config_fingerprint="", run={})
    problems = m.validate()
    assert problems == jtel.RunManifest(config={}, config_fingerprint="",
                                        run={}).validate()
    assert any("'value'" in p for p in problems)
    m = RunManifest(config={"k": 1}, config_fingerprint="ab", dtype="fp32",
                    run={"value": 1.0, "rounds": 1, "oracle_calls": 2},
                    phases={"total_wall_s": 0.1}, engine={"engine": "sync"})
    assert any("engine section missing" in p for p in m.validate())


@pytest.mark.parametrize("extra", ["plain", "faults-ckpt-autotune"])
def test_format_report_lines_equal_jax(tmp_path, extra):
    data, obj = _setup(19)
    kw = {} if extra == "plain" else dict(
        wave_autotune=True, checkpoint_dir=str(tmp_path),
        fault_policy=FaultPolicy(backoff_s=0.001, hedge=False))
    res = _run(data, obj, engine="pipelined", **kw)
    cfg = TreeConfig(k=6, capacity=60, seed=4, engine="pipelined", **kw)
    m = build_manifest(cfg, res, n=len(data), d=data.shape[1],
                       dtype_label="fp32")
    m.feasibility = {"ok": True, "detail": "knapsack 2.9/3.0"}
    m.recheck = {"fp32": 0.5, "solve": 0.5, "rel_gap": 0.0, "status": "PASS"}
    m.serve = {"requests": 3, "batches": 2, "latency_p50_ms": 1.5,
               "latency_p95_ms": 2.25, "queue_depth_max": 4,
               "cache_keys": 1, "compiles": 1, "cache_hits": 2,
               "steady_retraces": 0, "deltas": 1, "changed_machines": 2,
               "rebuilds": 0}
    lines = format_report(m)
    jm = jtel.RunManifest(**json.loads(json.dumps(m.to_dict())))
    assert lines == jtel.format_report(jm)
    es = res.engine_stats
    assert lines[0] == (f"TREE: f={res.value:.6f} rounds={res.rounds} "
                        f"machines/round={res.machines_per_round} "
                        f"oracle_calls={res.oracle_calls}")
    assert (f"engine: {es.engine} hosts={es.hosts} wall={es.wall_s:.3f}s "
            f"gather={es.gather_s:.3f}s") in "\n".join(lines)
    assert ("autotune:" in "".join(lines)) == (extra != "plain")


# -- the sources' fingerprints ------------------------------------------


def _source_pairs():
    r = np.random.default_rng(0)
    data = r.standard_normal((300, 5)).astype(np.float32)
    attrs = r.uniform(0.2, 1.0, (300, 1)).astype(np.float32)
    shards = [data[s:s + 70] for s in range(0, 300, 70)]
    pairs = {
        "array": (ArraySource(data), jsrc.ArraySource(data)),
        "array-attrs": (ArraySource(data, attrs=attrs),
                        jsrc.ArraySource(data, attrs=attrs)),
        "chunked": (ChunkedSource.from_array(data, 64),
                    jsrc.ChunkedSource.from_array(data, 64)),
        "sharded": (ShardedSource.from_arrays(shards),
                    jdsrc.ShardedSource.from_arrays(shards)),
    }
    for store in ("fp32", "bf16", "int8"):
        pairs[f"quantized-{store}"] = (
            QuantizedSource(ArraySource(data), store, 64),
            jsrc.QuantizedSource(jsrc.ArraySource(data), store, 64))
    pairs["sliced"] = (ArraySource(data).slice(10, 200),
                       jsrc.ArraySource(data).slice(10, 200))
    pairs["sliced-quantized"] = (
        QuantizedSource(ChunkedSource.from_array(data, 64), "bf16",
                        32).slice(0, 150),
        jsrc.QuantizedSource(jsrc.ChunkedSource.from_array(data, 64),
                             "bf16", 32).slice(0, 150))
    return pairs


@pytest.mark.parametrize("kind", sorted(_source_pairs()))
def test_source_fingerprints_equal_jax(kind):
    ours, theirs = _source_pairs()[kind]
    assert ours.fingerprint() == theirs.fingerprint()


def test_profiler_session_writes_a_trace(tmp_path):
    import torch
    with profiler_session(None) as prof:
        assert prof is None
    with profiler_session("") as prof:
        assert prof is None
    d = str(tmp_path / "prof")
    with profiler_session(d) as prof:
        torch.ones(64) @ torch.ones(64)
    assert prof is not None
    doc = json.load(open(os.path.join(d, PROFILE_TRACE_NAME)))
    assert doc["traceEvents"]


def test_feed_result_metrics_keys_equal_jax(tmp_path):
    """The same run in both packages (pipelined, async checkpoints, a
    fault policy) projects onto the same registry keys; the port adds
    ``engine.h2d_s``.  Counts and sums are the port result's own."""
    data, E = tree_inputs(n=601, ne=96, seed=21)
    kw = dict(k=6, capacity=60, seed=4, engine="pipelined",
              async_checkpoint=True)
    jres = jtree(JExemplar(jnp.asarray(E)),
                 jsrc.ChunkedSource.from_array(data, 128),
                 JTreeConfig(checkpoint_dir=str(tmp_path / "j"),
                             fault_policy=JFaultPolicy(), **kw),
                 wave_machines=3)
    res = _run(data, objective_from_numpy(E, "cpu"), engine="pipelined",
               checkpoint_dir=str(tmp_path / "t"), async_checkpoint=True,
               fault_policy=FaultPolicy())
    ours, theirs = MetricsRegistry(), jtel.MetricsRegistry()
    feed_result_metrics(ours, res)
    jtel.feed_result_metrics(theirs, jres)
    a, b = ours.snapshot(), theirs.snapshot()
    for kind in ("counters", "gauges", "histograms"):
        assert set(a[kind]) - {"engine.h2d_s{engine=pipelined}"} == \
            set(b[kind])
    es = res.engine_stats
    assert a["counters"]["engine.waves{engine=pipelined}"] == es.waves
    assert a["gauges"]["engine.overlap_ratio{engine=pipelined}"] == \
        es.overlap_ratio
    gh = a["histograms"]["engine.gather_s{engine=pipelined}"]
    assert gh["count"] == es.waves and abs(gh["sum"] - es.gather_s) < 1e-9
    assert a["gauges"]["solve.depth_total"] == res.solve_depth
