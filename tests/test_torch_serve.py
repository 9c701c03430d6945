"""Selection serving of the port against the JAX package on the CPU:
ingest and the resident state, persistence across the packages, served
answers against JAX ``offline_solve``, the ``Dynamic*`` constraints'
limit reading, delta == rebuild, the compile cache's accounting and LRU
bounds, the dispatcher, and the telemetry names.

One small session (n = 112, d = 5, μ = 12, k = 4, L = 10, 24 eval rows:
``tests/test_serve.py``'s fixture and seeds).  The port replays the JAX
service's threefry draws through ``_torch_parity.jax_serve_plan``; each
JAX reference answer is built once, in the module fixture."""
import json
import os
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import ArraySource
from repro.core import TreeConfig as JTreeConfig
from repro.core import constraints as jcons
from repro.engine import Tracer as JTracer
from repro.serve import SelectionRequest as JRequest
from repro.serve import SelectionService as JService
from repro.serve import SessionState as JSession
from repro.serve import ingest as jingest
from repro.serve import offline_solve as joffline
from repro.serve import round_ladder as jround_ladder
from repro_torch import testing
from repro_torch.core import TreeConfig, algorithms, check_feasible
from repro_torch.core import constraints as cons
from repro_torch.core.objectives import ExemplarClustering
from repro_torch.engine import Tracer
from repro_torch.kernels import ref
from repro_torch.serve import (CompileCache, Dispatcher, SelectionRequest,
                               SelectionService, SessionState,
                               build_constraint, constraint_params,
                               constraint_signature, ingest, offline_solve,
                               round_ladder, serve_batch)

from _torch_parity import cuda, jax_serve_plan  # noqa: F401

N, D, MU, K, SEED = 112, 5, 12, 4, 5      # L = 10, 8 free slots
N_EVAL = 24
CONS = [None, "knapsack:budget=1.5", "partition:caps=2,2,2:col=1",
        "intersection:knapsack:budget=2.0+partition:caps=2,2,2:col=1"]
QUERIED = [(None, 3), ("knapsack:budget=1.5", 3)]     # (constraint, seed)
BUDGETS = [1.1, 1.4264969649957493e-06]   # not fp32-exact; the readings part


def _data():
    rng = np.random.default_rng(11)
    X = rng.normal(size=(N, D)).astype(np.float32)
    attrs = np.zeros((N, 2), np.float32)
    attrs[:, 0] = rng.uniform(0.2, 1.0, N).astype(np.float32)
    attrs[:, 1] = rng.integers(0, 3, N).astype(np.float32)
    E = X[rng.choice(N, N_EVAL, replace=False)]
    return X, attrs, E


def _tiny_attrs(attrs):
    """Weights at which the two knapsack-limit readings of the tiny budget
    part: every third item weighs the larger limit (one such item fits under
    it and none under the smaller), the rest 1.0."""
    dyn, static = _limits(BUDGETS[1])
    out = attrs.copy()
    out[:, 0] = 1.0
    out[::3, 0] = max(dyn, static)
    return out


def _limits(budget):
    """(dynamic, static) readings of a budget's knapsack limit."""
    dyn = float(ref.dynamic_limit(torch.tensor(np.float32(budget))))
    return dyn, ref.knapsack_limit(np.float32(budget))


def _tail_plan(seed, ladder):
    return jax_serve_plan(SEED, seed, ladder, MU)


def _session(X, attrs, engine="sync", hosts=1):
    cfg = TreeConfig(k=K, capacity=MU, seed=SEED, engine=engine, hosts=hosts)
    L = -(-N // MU)
    return ingest(X, cfg, attrs=attrs, plan=jax_serve_plan(SEED, 0, (L,), MU))


def _service(st, E, **kw):
    return SelectionService(st, E, device="cpu", tail_plan=_tail_plan, **kw)


@pytest.fixture(scope="module")
def world():
    X, attrs, E = _data()
    jcfg = JTreeConfig(k=K, capacity=MU, seed=SEED)
    jst = jingest(ArraySource(X), jcfg, attrs=attrs)
    jtiny = jingest(ArraySource(X), jcfg, attrs=_tiny_attrs(attrs))
    refs = {}
    for c in CONS:
        refs[(c, None, 0)] = joffline(jst, E, JRequest(k=K, constraint=c))
    for c, seed in QUERIED:
        refs[(c, "q", seed)] = joffline(
            jst, E, JRequest(k=K, constraint=c, query=X[17], seed=seed))
    refs[(BUDGETS[0], None, 0)] = joffline(
        jst, E, JRequest(k=K, constraint=f"knapsack:budget={BUDGETS[0]}"))
    refs[(BUDGETS[1], None, 0)] = joffline(
        jtiny, E, JRequest(k=K, constraint=f"knapsack:budget={BUDGETS[1]}"))
    st = _session(X, attrs)
    return dict(X=X, attrs=attrs, E=E, jst=jst, refs=refs, st=st,
                svc=_service(st, E))


def _same(a, b, exact_value=True):
    """Two answers agree: rows, attrs, mask, calls and depth exactly; the
    value exactly or (port against JAX) within the port's tolerance."""
    np.testing.assert_array_equal(a.rows, np.asarray(b.rows))
    np.testing.assert_array_equal(a.attrs, np.asarray(b.attrs))
    np.testing.assert_array_equal(a.mask, np.asarray(b.mask))
    assert a.oracle_calls == b.oracle_calls
    assert a.solve_depth == b.solve_depth
    if exact_value:
        assert a.value == b.value
    else:
        testing.assert_close(np.float32(a.value), np.float32(b.value),
                             "served value")


# ---------------------------------------------------------------------------
# ingestion → resident state; persistence
# ---------------------------------------------------------------------------


def _same_positions(st, jst):
    """The port's id → slot index holds the JAX session's ``_pos``."""
    assert all(st.position(i) == ms for i, ms in jst._pos.items())
    assert int((st._slot >= 0).sum()) == len(jst._pos)


@pytest.mark.parametrize("engine,hosts", [("sync", 1), ("pipelined", 2)])
def test_ingest_matches_jax_ingest(world, engine, hosts):
    st = _session(world["X"], world["attrs"], engine, hosts)
    jst = world["jst"]
    assert (st.Mp, st.L, st.n_items, st.a) == (jst.Mp, jst.L, N, 2)
    for f in ("blocks", "attrs", "valid", "item_ids", "versions"):
        np.testing.assert_array_equal(getattr(st, f), getattr(jst, f), f)
    _same_positions(st, jst)
    assert not st.blocks[~st.valid].any()


def test_fingerprint_and_round_ladder_match_jax(world):
    assert world["st"].fingerprint() == world["jst"].fingerprint()
    for Mp, k, mu in ((10, K, MU), (1, K, MU), (2000, 50, 22_500),
                      (37, 5, 16)):
        assert round_ladder(Mp, k, mu) == jround_ladder(Mp, k, mu)
    assert round_ladder(10, K, MU) == (10, 4, 2, 1)
    for fn in (round_ladder, jround_ladder):
        with pytest.raises(ValueError, match="stalls"):
            fn(4, 11, 12)                 # ceil(4·11/12) = 4: no progress


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_session_files_load_in_either_package(world, tmp_path, writer):
    st, jst = world["st"], world["jst"]
    (st if writer == "port" else jst).save(str(tmp_path))
    port, jax_ = SessionState.load(str(tmp_path)), JSession.load(str(tmp_path))
    for loaded in (port, jax_):
        for f in ("blocks", "attrs", "valid", "item_ids", "versions"):
            np.testing.assert_array_equal(getattr(loaded, f),
                                          getattr(st, f), f)
        assert loaded.fingerprint() == st.fingerprint()
    _same_positions(port, jax_)
    _same_positions(port, jst)
    with open(os.path.join(tmp_path, "session.json")) as f:
        assert sorted(json.load(f)) == sorted(
            ["mu", "d", "a", "L", "Mp", "seed", "permutation", "n_base",
             "next_id", "generation", "dropped_rows"])


# ---------------------------------------------------------------------------
# served against the JAX reference; port served against port offline
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("c", CONS)
def test_served_equals_jax_offline(world, c):
    got = world["svc"].query(SelectionRequest(k=K, constraint=c))
    _same(got, world["refs"][(c, None, 0)], exact_value=False)
    assert got.feasible, got.detail
    ok, detail = check_feasible(cons.from_spec(c) if c else None, got.attrs,
                                got.mask)
    assert ok, detail


@pytest.mark.parametrize("c,seed", QUERIED)
def test_served_query_equals_jax_offline(world, c, seed):
    req = SelectionRequest(k=K, constraint=c, query=world["X"][17], seed=seed)
    got = world["svc"].query(req)
    _same(got, world["refs"][(c, "q", seed)], exact_value=False)
    _same(got, offline_solve(world["st"], world["E"], req, device="cpu",
                             tail_plan=_tail_plan))


@pytest.mark.parametrize("n_req", [1, 2, 3])          # buckets 1, 2, 4
def test_served_batch_equals_offline_bits(world, n_req):
    reqs = [SelectionRequest(k=K, constraint=f"knapsack:budget={b}", seed=s)
            for b, s in ((1.5, 0), (0.9, 4), (2.7, 7))[:n_req]]
    svc = _service(world["st"], world["E"])
    for got, req in zip(svc.serve(reqs), reqs):
        assert got.batch_size == n_req
        _same(got, offline_solve(world["st"], world["E"], req, device="cpu",
                                 tail_plan=_tail_plan))


def test_request_seed_changes_only_the_tail(world):
    svc = _service(world["st"], world["E"])
    a = svc.query(SelectionRequest(k=K, seed=1))
    assert svc.sol_hits == 0
    b = svc.query(SelectionRequest(k=K, seed=2))
    assert svc.sol_hits == 1            # round 0 came from the cache
    assert a.value != b.value or not np.array_equal(a.rows, b.rows)
    _same(b, offline_solve(world["st"], world["E"],
                           SelectionRequest(k=K, seed=2), device="cpu",
                           tail_plan=_tail_plan))


# ---------------------------------------------------------------------------
# the Dynamic* constraints
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fused", [True, False])
def test_dynamic_constraints_select_as_static(world, fused):
    """Equal parameters (fp32-exact, not tiny budgets): the same picks,
    calls and value on the fused path and on the scan."""
    st = world["st"]
    T = torch.from_numpy(st.blocks)
    mask = torch.from_numpy(st.valid)
    at = torch.from_numpy(st.attrs)
    obj = ExemplarClustering(torch.from_numpy(world["E"]))
    pairs = [(cons.Knapsack(1.5), cons.DynamicKnapsack(torch.tensor(1.5))),
             (cons.PartitionMatroid((2, 1, 2), col=1),
              cons.DynamicPartitionMatroid(torch.tensor([2, 1, 2],
                                                        dtype=torch.int32),
                                           col=1))]
    pairs.append((cons.Intersection(tuple(p for p, _ in pairs)),
                  cons.Intersection(tuple(q for _, q in pairs))))
    for static, dynamic in pairs:
        a = algorithms.greedy(obj, T, mask, K, constraint=static, attrs=at,
                              fused=fused)
        b = algorithms.greedy(obj, T, mask, K, constraint=dynamic, attrs=at,
                              fused=fused)
        for x, y in zip(a, b):
            assert torch.equal(x, y)
        sel = a.sel_idx.numpy()
        for m in range(st.Mp):
            picked = st.attrs[m][np.maximum(sel[m], 0)]
            assert (static.check_np(picked, sel[m] >= 0)
                    == dynamic.check_np(picked, sel[m] >= 0))


def test_constraint_packing_round_trips():
    c = cons.from_spec("intersection:knapsack:budget=2.0+"
                       "partition:caps=2,1,3:col=1")
    sig, params = constraint_signature(c), constraint_params(c)
    assert sig == ("intersection", ("knapsack", 0), ("partition", 1, 3))
    assert params.tolist() == [2.0, 2.0, 1.0, 3.0]
    built = build_constraint(sig, torch.from_numpy(params))
    kn, pm = built.parts
    assert isinstance(kn, cons.DynamicKnapsack) and float(kn.budget) == 2.0
    assert pm.caps.dtype == torch.int32 and pm.caps.tolist() == [2, 1, 3]
    assert constraint_signature(built) == sig
    np.testing.assert_array_equal(constraint_params(built), params)


@pytest.mark.parametrize("budget", BUDGETS)
def test_knapsack_limit_follows_jax_dynamic_reading(world, budget):
    """The service's knapsack limit is the device's fp32 ``budget + TOL``
    (JAX ``DynamicKnapsack``), not the static class's one rounding: at the
    tiny budget the two part and the served answer is the JAX one."""
    attrs = world["attrs"] if budget == BUDGETS[0] else _tiny_attrs(
        world["attrs"])
    dyn, static = _limits(budget)
    jdyn = float(jnp.float32(budget) + jcons.KNAPSACK_TOL)
    assert dyn == jdyn
    if budget == BUDGETS[1]:
        assert dyn != static
    st = _session(world["X"], attrs)
    req = SelectionRequest(k=K, constraint=f"knapsack:budget={budget}")
    got = _service(st, world["E"]).query(req)
    _same(got, world["refs"][(budget, None, 0)], exact_value=False)
    if budget == BUDGETS[1]:
        assert int(got.mask.sum()) == (1 if dyn > static else 0)


# ---------------------------------------------------------------------------
# deltas: delta-then-query ≡ rebuild-then-query
# ---------------------------------------------------------------------------


def _delta_args(kind, X):
    rng = np.random.default_rng(77)
    ins = (X[rng.choice(N, 6, replace=False)] * np.float32(0.5),
           np.ascontiguousarray(
               np.stack([rng.uniform(0.2, 1.0, 6),
                         rng.integers(0, 3, 6).astype(float)],
                        axis=1).astype(np.float32)))
    dels = [int(i) for i in rng.choice(N, 5, replace=False)]
    if kind == "insert":
        return ins[0], ins[1], None
    if kind == "delete":
        return None, None, dels
    return ins[0], ins[1], dels


def _fresh(world, **kw):
    cfg = TreeConfig(k=K, capacity=MU, seed=SEED)
    return ingest(world["X"], cfg, attrs=world["attrs"], **kw)


@pytest.mark.parametrize("kind", ["insert", "delete", "mixed"])
@pytest.mark.parametrize("c,alg", [(None, "greedy"),
                                   ("knapsack:budget=1.5", "greedy"),
                                   (None, "stochastic_greedy")])
def test_delta_equals_rebuild(world, kind, c, alg):
    rows, ia, dels = _delta_args(kind, world["X"])
    req = SelectionRequest(k=K, constraint=c, algorithm=alg)
    E = world["E"]

    s1 = _fresh(world)
    v1 = SelectionService(s1, E, device="cpu")
    v1.query(req)                          # fill the solution cache
    rep = v1.apply_delta(insert_rows=rows, insert_attrs=ia, delete_ids=dels)
    assert not rep.rebuilt and rep.changed_machines
    a = v1.query(req)
    assert v1.partial_resolves == 1 and v1.sol_hits == 0

    s1.rebuild()                           # the same session, re-ingested
    assert s1.generation == 1
    b = SelectionService(s1, E, device="cpu").query(req)

    s3 = _fresh(world)                     # fresh ingest + the same delta
    s3.apply_delta(insert_rows=rows, insert_attrs=ia, delete_ids=dels)
    c3 = SelectionService(s3, E, device="cpu").query(req)

    np.testing.assert_array_equal(s1.item_ids, s3.item_ids)
    np.testing.assert_array_equal(s1._slot, s3._slot)
    live = np.flatnonzero(s1._slot >= 0)
    np.testing.assert_array_equal(s1.item_ids.reshape(-1)[s1._slot[live]],
                                  live)
    assert live.size == s1.n_items and s1._slot.size == s1.next_id
    for other in (b, c3):
        _same(a, other)
    assert a.feasible, a.detail


def test_delta_capacity_overflow_falls_back_to_rebuild(world):
    s = _fresh(world)
    n_ins = s.free_slots + 4
    rng = np.random.default_rng(3)
    rows = rng.normal(size=(n_ins, D)).astype(np.float32)
    ia = np.zeros((n_ins, 2), np.float32)
    ia[:, 0] = 0.5
    rep = s.apply_delta(insert_rows=rows, insert_attrs=ia)
    assert rep.rebuilt and s.generation == 1
    assert s.n_items == N + n_ins and s.L * MU >= s.n_items
    assert rep.changed_machines == list(range(s.Mp))
    res = SelectionService(s, world["E"], device="cpu").query(
        SelectionRequest(k=K, constraint="knapsack:budget=1.5"))
    assert res.feasible, res.detail


def test_delete_unknown_id_raises(world):
    s = _fresh(world)
    s.apply_delta(delete_ids=[7])
    with pytest.raises(KeyError):
        s.apply_delta(delete_ids=[7])      # already gone
    with pytest.raises(KeyError):
        s.apply_delta(delete_ids=[10_000])


# ---------------------------------------------------------------------------
# caches: no warm entry built twice; LRU bounds
# ---------------------------------------------------------------------------


def test_warm_entries_never_rebuilt_on_new_params(world):
    X = world["X"]
    svc = SelectionService(world["st"], world["E"], device="cpu")
    svc.query(SelectionRequest(k=K, constraint="knapsack:budget=1.5"))
    svc.query(SelectionRequest(k=K, query=X[2]))
    c0 = svc.cache.compiles
    assert c0 == 4                          # round 0 + tail, two fuse keys
    svc.query(SelectionRequest(k=K, constraint="knapsack:budget=0.9"))
    svc.query(SelectionRequest(k=K, constraint="knapsack:budget=2.7",
                               seed=4))
    svc.query(SelectionRequest(k=K, query=X[33]))
    svc.query(SelectionRequest(k=K, query=X[44]))
    assert svc.cache.compiles == c0, "a parameter-only change rebuilt"
    assert svc.cache.steady_retraces() == 0
    svc.query(SelectionRequest(k=5))
    grew = svc.cache.compiles - c0
    assert grew == 2                        # a novel k: two new entries
    svc.query(SelectionRequest(k=5))
    assert svc.cache.compiles == c0 + grew
    assert all(c == 1 for c in svc.cache._trace_counts.values())
    stats = svc.serve_stats()
    assert stats["graph_entries"] == 0 and stats["replays"] == 0
    assert stats["cache_keys"] == 6 and stats["cache_hits"] >= 5


def test_sol_cache_lru_bounded_and_correct(world):
    svc = SelectionService(_fresh(world), world["E"], device="cpu",
                           sol_cache_capacity=2)
    r3 = svc.query(SelectionRequest(k=3))
    svc.query(SelectionRequest(k=4))
    svc.query(SelectionRequest(k=5))          # capacity 2: k=3 evicted
    stats = svc.serve_stats()
    assert stats["sol_cache_capacity"] == 2
    assert stats["sol_cache_entries"] == 2
    assert stats["sol_cache_evictions"] == 1
    _same(r3, svc.query(SelectionRequest(k=3)))   # re-solved, same bits
    svc.query(SelectionRequest(k=3))              # a hit refreshes recency
    hits = svc.serve_stats()["sol_cache_hits"]
    svc.query(SelectionRequest(k=6))              # evicts k=5, not k=3
    svc.query(SelectionRequest(k=3))
    assert svc.serve_stats()["sol_cache_hits"] == hits + 1


def test_compile_cache_lru_bounded_and_correct(world):
    svc = SelectionService(_fresh(world), world["E"], device="cpu",
                           compile_cache_capacity=1)
    r3 = svc.query(SelectionRequest(k=3))
    svc.query(SelectionRequest(k=4))          # capacity 1: entries evicted
    stats = svc.serve_stats()
    assert stats["cache_capacity"] == 1
    assert stats["cache_keys"] == 1
    assert stats["cache_evictions"] >= 1
    _same(r3, svc.query(SelectionRequest(k=3)))
    assert svc.serve_stats()["steady_retraces"] == 0
    with pytest.raises(ValueError):
        CompileCache(capacity=0)


def test_cache_eviction_metrics_registered(world):
    tracer = Tracer()
    svc = SelectionService(_fresh(world), world["E"], device="cpu",
                           tracer=tracer, compile_cache_capacity=1,
                           sol_cache_capacity=1)
    for k in (3, 4, 5):
        svc.query(SelectionRequest(k=k))
    snap = tracer.metrics.snapshot()
    assert snap["counters"]["serve_compile_cache_evictions"] >= 1
    assert snap["counters"]["serve_sol_cache_evictions"] == 2
    assert snap["gauges"]["serve_compile_cache_entries"] == 1
    assert snap["gauges"]["serve_sol_cache_entries"] == 1


def test_unbounded_caches_by_default(world):
    svc = world["svc"]
    assert svc.cache.capacity is None and svc.sol_cache_capacity is None
    assert svc.serve_stats()["cache_evictions"] == 0
    assert svc.serve_stats()["sol_cache_evictions"] == 0


# ---------------------------------------------------------------------------
# dispatcher
# ---------------------------------------------------------------------------


def test_dispatcher_max_batch_1_equals_direct(world):
    svc = SelectionService(world["st"], world["E"], device="cpu")
    reqs = [SelectionRequest(k=K, seed=s) for s in range(4)]
    reqs.append(SelectionRequest(k=K, constraint="knapsack:budget=1.5"))
    dp = Dispatcher(svc, max_batch=1)
    try:
        threaded = dp.map(reqs, timeout=60)
    finally:
        dp.close(timeout=60)
    assert not dp._thread.is_alive()
    for t, r in zip(threaded, reqs):
        _same(t, svc.serve([r])[0])
        assert t.batch_size == 1
    assert svc.queue_depth_max >= 1
    for t, r in zip(serve_batch(svc, reqs[:2]), svc.serve(reqs[:2])):
        _same(t, r)


def test_dispatcher_errors_reach_every_waiter(world):
    """The worker is held inside its first batch (an event, not a sleep)
    while three requests queue behind it, one of them invalid: the next
    drain takes all three, and each of their futures gets the error."""
    svc = SelectionService(world["st"], world["E"], device="cpu")
    entered, release = threading.Event(), threading.Event()
    serve = svc.serve

    def held(reqs):
        if not entered.is_set():
            entered.set()
            assert release.wait(timeout=60)
        return serve(reqs)

    svc.serve = held
    dp = Dispatcher(svc, max_batch=8)
    try:
        first = dp.submit(SelectionRequest(k=K))
        assert entered.wait(timeout=60)
        queued = [dp.submit(SelectionRequest(k=K, seed=1)),
                  dp.submit(SelectionRequest(k=MU + 3)),    # invalid
                  dp.submit(SelectionRequest(k=K, seed=2))]
        release.set()
        assert first.result(timeout=60).mask.any()
        for fut in queued:
            with pytest.raises(ValueError, match="must satisfy"):
                fut.result(timeout=60)
    finally:
        release.set()
        dp.close(timeout=60)
    assert not dp._thread.is_alive()
    assert svc.queue_depth_max == 3


# ---------------------------------------------------------------------------
# telemetry
# ---------------------------------------------------------------------------


def _traced_run(svc_cls, req_cls, st, E, tracer, **kw):
    svc = svc_cls(st, E, tracer=tracer, compile_cache_capacity=1,
                  sol_cache_capacity=1, **kw)
    svc.serve([req_cls(k=K), req_cls(k=K, seed=1)])
    svc.note_queue_depth(2)
    svc.apply_delta(delete_ids=[0])
    svc.query(req_cls(k=K))                 # a partial re-solve
    svc.query(req_cls(k=3))                 # evictions
    return svc


def test_serve_spans_and_metric_names_match_jax(world, tmp_path):
    X, attrs, E = world["X"], world["attrs"], world["E"]
    jt, tt = JTracer(), Tracer()
    jsvc = _traced_run(JService, JRequest,
                       jingest(ArraySource(X), JTreeConfig(k=K, capacity=MU,
                                                           seed=SEED),
                               attrs=attrs), E, jt)
    svc = _traced_run(SelectionService, SelectionRequest,
                      _session(X, attrs), E, tt, device="cpu",
                      tail_plan=_tail_plan)

    def spans(tr):
        return sorted({(ev.name, ev.cat, ev.phase) for ev in tr.events})

    assert spans(tt) == spans(jt)
    js, ts = jt.metrics.snapshot(), tt.metrics.snapshot()
    for kind in ("counters", "gauges", "histograms"):
        assert sorted(ts[kind]) == sorted(js[kind]), kind
    assert ts["counters"] == js["counters"]
    jstats, stats = jsvc.serve_stats(), svc.serve_stats()
    assert set(jstats) <= set(stats)
    for key in ("requests", "batches", "queue_depth_max", "cache_keys",
                "compiles", "cache_hits", "cache_evictions",
                "steady_retraces", "sol_cache_hits", "sol_cache_entries",
                "sol_cache_evictions", "partial_resolves", "deltas",
                "changed_machines", "rebuilds"):
        assert stats[key] == jstats[key], key
    out = str(tmp_path / "trace.json")
    tt.export_chrome_trace(out)
    with open(out) as f:
        trace = json.load(f)
    evs = trace["traceEvents"] if isinstance(trace, dict) else trace
    assert any(ev.get("cat") == "serve" for ev in evs if isinstance(ev, dict))


# ---------------------------------------------------------------------------
# on the card: one captured entry, replayed with no recapture
# ---------------------------------------------------------------------------


def test_graph_entry_replays_without_recapture_on_card(cuda, world):  # noqa: F811
    st = _fresh(world)
    svc = SelectionService(st, world["E"], device=cuda)
    reqs = [SelectionRequest(k=K, constraint=f"knapsack:budget={b}")
            for b in (1.5, 0.9, 2.7)]
    first = svc.query(reqs[0])                 # eager answer, then capture
    assert svc.cache.compiles == 2 and len(svc.cache.graph_keys) == 2
    for req in reqs[1:]:                       # replays of both entries
        got = svc.query(req)
        _same(got, offline_solve(st, world["E"], req, device=cuda))
        assert got.feasible, got.detail
    _same(svc.query(reqs[0]), first)           # the warm tail, same bits
    stats = svc.serve_stats()
    assert stats["compiles"] == 2 and stats["steady_retraces"] == 0
    assert stats["replays"] == 5
    svc.apply_delta(delete_ids=[0, 1])         # staged in place: no recapture
    svc.query(reqs[1])
    assert svc.serve_stats()["steady_retraces"] == 0
