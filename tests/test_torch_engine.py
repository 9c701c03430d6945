"""The port's round-0 engine on the CPU: the pipelined scheduler and the
ingestion hosts give the sync engine's result bit for bit over every
source kind, host count and row dtype, and under knapsack ∩ partition; the
pipelined multi-host TREE equals the JAX package's *resident* TREE for one
plan (its streaming path fails two of its own tests on this JAX, ROADMAP
queue 3); backpressure, producer errors, the planner's stitch, locality,
shard-aligned host splits and attributes riding with their rows."""
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import ExemplarClustering as JExemplar
from repro.core import Intersection as JIntersection
from repro.core import Knapsack as JKnapsack
from repro.core import PartitionMatroid as JPartition
from repro.core import TreeConfig as JTreeConfig
from repro.core import tree_maximize as jtree
from repro.data import sources as jdsrc
from repro_torch import testing
from repro_torch.convert import constraint_from_jax, objective_from_numpy
from repro_torch.core import (ArraySource, ChunkedSource, QuantizedSource,
                              TreeConfig, tree_maximize)
from repro_torch.core.sources import HostLostError, SlicedSource
from repro_torch.data.sources import ShardedSource
from repro_torch.engine import (EngineConfig, HostWave, IngestionPlan,
                                WaveTrace, overlap_from_traces, run_waves)

from _torch_parity import assert_same_tree, jax_tree_plan, tree_inputs

K, MU = 8, 60
JCONS = JIntersection((JKnapsack(budget=4.0, col=0),
                       JPartition(caps=(4, 4, 4), col=1)))
JOIN_S = 30.0


def _attrs(n, seed=7):
    r = np.random.default_rng(seed)
    return np.stack([r.uniform(0.2, 1.0, n), r.integers(0, 3, n)],
                    1).astype(np.float32)


SOURCES = {
    "array": lambda d, a: ArraySource(d, attrs=a),
    "chunked": lambda d, a: ChunkedSource.from_array(d, 97, attrs=a),
    "sharded": lambda d, a: ShardedSource.from_arrays(
        [d[s:s + 130] for s in range(0, len(d), 130)],
        attrs=None if a is None else
        [a[s:s + 130] for s in range(0, len(d), 130)]),
}


def _source(kind, store, data, attrs=None):
    src = SOURCES[kind](data, attrs)
    return src if store == "fp32" else QuantizedSource(src, store, 128)


@pytest.mark.parametrize("store", ["fp32", "bf16", "int8"])
@pytest.mark.parametrize("hosts", [1, 2, 3])
@pytest.mark.parametrize("kind", sorted(SOURCES))
def test_pipelined_equals_sync(kind, hosts, store):
    data, E = tree_inputs(seed=1)
    obj = objective_from_numpy(E, "cpu")
    sync = tree_maximize(obj, _source(kind, store, data),
                         TreeConfig(k=K, capacity=MU, seed=5), device="cpu",
                         wave_machines=3)
    pipe = tree_maximize(obj, _source(kind, store, data),
                         TreeConfig(k=K, capacity=MU, seed=5,
                                    engine="pipelined", hosts=hosts),
                         device="cpu", wave_machines=3)
    assert_same_tree(pipe, sync)
    es = pipe.engine_stats
    assert (es.engine, es.hosts, sync.engine_stats.engine) == (
        "pipelined", hosts, "sync")
    assert es.waves == pipe.ingest.waves == 4
    assert es.width_trajectory == [3, 3, 3, 2] and es.distinct_shapes == 2
    assert 1 <= es.max_in_flight <= 2
    for t in es.traces:
        if hosts > 1:
            assert len(t.per_host_rows) == hosts
            assert sum(t.per_host_rows) == t.rows
        else:
            assert t.per_host_rows is None
    assert [t.wave for t in es.traces] == [0, 1, 2, 3]
    assert pipe.fault_stats is None and pipe.checkpoint_stats is None


@pytest.mark.parametrize("alg", ["greedy", "threshold_batch"])
def test_pipelined_hosts_equal_sync_under_knapsack_and_partition(alg):
    data, E = tree_inputs(seed=2)
    attrs = _attrs(len(data))
    obj = objective_from_numpy(E, "cpu")
    cons = constraint_from_jax(JCONS)

    def run(**kw):
        return tree_maximize(
            obj, ChunkedSource.from_array(data, 128, attrs=attrs),
            TreeConfig(k=K, capacity=MU, seed=4, algorithm=alg, **kw),
            device="cpu", wave_machines=2, constraint=cons)

    sync, pipe = run(), run(engine="pipelined", hosts=2)
    assert_same_tree(pipe, sync)
    np.testing.assert_array_equal(pipe.sel_attrs, sync.sel_attrs)


@pytest.mark.parametrize("alg,hosts,constrained", [
    ("greedy", 3, False), ("threshold_batch", 2, True)])
def test_pipelined_hosts_match_jax_resident(alg, hosts, constrained):
    data, E = tree_inputs(n=900, seed=3)
    attrs = _attrs(len(data)) if constrained else None
    jres = jtree(JExemplar(jnp.asarray(E)), jnp.asarray(data),
                 JTreeConfig(k=K, capacity=MU, algorithm=alg, seed=0),
                 constraint=JCONS if constrained else None, attrs=attrs)
    plan = jax_tree_plan(0, MU, jres.machines_per_round)
    res = tree_maximize(
        objective_from_numpy(E, "cpu"), data,
        TreeConfig(k=K, capacity=MU, algorithm=alg, engine="pipelined",
                   hosts=hosts), device="cpu", plan=plan, wave_machines=4,
        constraint=constraint_from_jax(JCONS) if constrained else None,
        attrs=attrs)
    np.testing.assert_array_equal(res.sel_rows, np.asarray(jres.sel_rows))
    np.testing.assert_array_equal(res.sel_mask, np.asarray(jres.sel_mask))
    testing.assert_close(res.value, jres.value)
    assert res.oracle_calls == int(jres.oracle_calls)
    assert res.rounds == jres.rounds
    assert res.machines_per_round == list(jres.machines_per_round)
    assert res.depth_per_round == list(jres.depth_per_round)
    assert res.engine_stats.engine == "pipelined"


@pytest.mark.parametrize("knob", [dict(engine="pipelined"), dict(hosts=2)])
def test_engine_knobs_imply_streaming_for_an_array(knob):
    data, E = tree_inputs(seed=4)
    obj = objective_from_numpy(E, "cpu")
    resident = tree_maximize(obj, data, TreeConfig(k=K, capacity=MU, seed=2),
                             device="cpu")
    streamed = tree_maximize(obj, data,
                             TreeConfig(k=K, capacity=MU, seed=2, **knob),
                             device="cpu")
    assert_same_tree(streamed, resident)
    assert streamed.ingest is not None and resident.ingest is None
    assert streamed.engine_stats is not None and resident.engine_stats is None
    assert streamed.ingest.waves == streamed.ingest.total_machines


def test_backpressure_high_water_mark_through_the_tree():
    data, E = tree_inputs(n=1200, seed=5)
    pipe = tree_maximize(objective_from_numpy(E, "cpu"),
                         ChunkedSource.from_array(data, 256),
                         TreeConfig(k=K, capacity=MU, seed=1,
                                    engine="pipelined", max_in_flight=3),
                         device="cpu", wave_machines=2)
    es = pipe.engine_stats
    assert es.waves == 10 and 1 <= es.max_in_flight <= 3
    assert es.wall_s > 0 and es.span_wall_s > 0
    assert all(t.stall_s >= 0 and t.t_end >= t.t_start for t in es.traces)


def test_backpressure_blocks_the_producer():
    """While wave 0 solves, the producer may gather waves 1 and 2 (two
    credits) but not wave 3: observed from inside the solve, with the
    producer's progress ordered by an event, not by sleeps."""
    lock = threading.Lock()
    live, peak, gathered = [0], [0], []
    wave2 = threading.Event()
    seen_in_solve0 = []

    def gather(i):
        if i == 12:
            return None
        with lock:
            live[0] += 1
            peak[0] = max(peak[0], live[0])
            gathered.append(i)
        if i == 2:
            wave2.set()
        return HostWave(payload=i, machines=1, rows=1, bytes_moved=4)

    def stage(payload):
        with lock:
            live[0] -= 1
        return payload

    def solve(i, staged):
        assert staged == i
        if i == 0:
            assert wave2.wait(JOIN_S)
            with lock:
                seen_in_solve0.extend(gathered)

    stats = run_waves(gather, stage, solve,
                      EngineConfig(mode="pipelined", max_in_flight=2),
                      torch.device("cpu"))
    assert seen_in_solve0 == [0, 1, 2]       # wave 3 waited for a credit
    assert stats.waves == 12 and peak[0] <= 2
    assert stats.max_in_flight == 2
    assert [t.wave for t in stats.traces] == list(range(12))


def test_producer_exception_surfaces_on_the_caller():
    seen = []

    def gather(i):
        if i == 3:
            raise RuntimeError("source died")
        return HostWave(payload=i, machines=1, rows=1, bytes_moved=4)

    with pytest.raises(RuntimeError, match="source died"):
        run_waves(gather, lambda p: p, lambda i, s: seen.append(i),
                  EngineConfig(mode="pipelined"), torch.device("cpu"))
    assert seen == [0, 1, 2]
    assert not [t for t in threading.enumerate()
                if t.name == "wave-prefetch" and t.is_alive()]


def test_a_failing_source_surfaces_through_the_pipelined_tree():
    data, E = tree_inputs(seed=6)

    class Failing(ArraySource):
        calls = 0

        def gather(self, idx):
            Failing.calls += 1
            if Failing.calls == 3:
                raise OSError("disk gone")
            return super().gather(idx)

    with pytest.raises(OSError, match="disk gone"):
        tree_maximize(objective_from_numpy(E, "cpu"), Failing(data),
                      TreeConfig(k=K, capacity=MU, engine="pipelined"),
                      device="cpu", wave_machines=2)


@pytest.mark.parametrize("parallel", [False, True])
def test_planner_stitch_equals_one_gather(parallel):
    data, _ = tree_inputs(n=500, seed=6)
    src = ChunkedSource.from_array(data, 64)
    plan = IngestionPlan.build(src, 3)
    idx = np.random.default_rng(0).integers(0, 500, 200)
    rows, attrs, per_host = plan.gather(idx, parallel=parallel)
    np.testing.assert_array_equal(rows, data[idx])
    assert attrs is None and sum(per_host) == len(idx)
    np.testing.assert_array_equal(plan.owner_of(idx),
                                  np.searchsorted([0, 167, 333], idx,
                                                  side="right") - 1)
    assert [(s.lo, s.hi) for s in plan.shards] == [(0, 167), (167, 333),
                                                   (333, 500)]


def test_sliced_source_asserts_locality_and_loss():
    data, _ = tree_inputs(n=300, seed=7)
    view = ArraySource(data).slice(100, 200)
    assert isinstance(view, SlicedSource) and view.local_n == 100
    np.testing.assert_array_equal(view.gather(np.array([100, 199])),
                                  data[[100, 199]])
    with pytest.raises(ValueError, match="non-local"):
        view.gather(np.array([99]))
    with pytest.raises(ValueError, match="non-local"):
        view.gather(np.array([150, 200]))
    view.mark_lost(4)
    with pytest.raises(HostLostError) as err:
        view.gather(np.array([150]))
    assert err.value.host == 4


@pytest.mark.parametrize("sizes,hosts", [
    ((130,) * 5, 3), ((50, 200, 25, 100, 225), 4), ((100, 100), 3)])
def test_host_splits_align_to_shards_as_jax(sizes, hosts):
    data, _ = tree_inputs(n=sum(sizes), seed=8)
    starts = np.concatenate([[0], np.cumsum(sizes)])
    shards = [data[s:e] for s, e in zip(starts, starts[1:])]
    got = ShardedSource.from_arrays(shards).host_split_points(hosts)
    assert got == jdsrc.ShardedSource.from_arrays(shards).host_split_points(
        hosts)
    assert got[0] == 0 and got[-1] == len(data) and got == sorted(set(got))
    if hosts <= len(sizes):
        assert set(got) <= set(starts.tolist())
    q = QuantizedSource(ShardedSource.from_arrays(shards), "int8", 64)
    assert q.host_split_points(hosts) == got


def test_attributes_travel_with_their_rows():
    data, _ = tree_inputs(n=400, seed=9)
    attrs = _attrs(len(data))
    src = SOURCES["sharded"](data, attrs)
    plan = IngestionPlan.build(src, 3)
    idx = np.random.default_rng(2).integers(0, 400, 333)
    rows, got, per_host = plan.gather(idx, with_attrs=True, parallel=True)
    np.testing.assert_array_equal(rows, data[idx])
    np.testing.assert_array_equal(got, attrs[idx])
    assert sum(per_host) == 333


def test_overlap_from_traces():
    def tr(w, t0, g, dev):
        return WaveTrace(wave=w, machines=1, rows=1, bytes_moved=0,
                         gather_s=g, h2d_s=dev / 2, solve_s=dev / 2,
                         t_start=t0, t_end=t0 + g + dev)

    # 1 s of gather and 1 s of device a wave, waves 1 s apart: 4 s of
    # wall for 6 s of work; wave 0's gather is never hidden
    traces = [tr(0, 10.0, 1.0, 1.0), tr(1, 11.0, 1.0, 1.0),
              tr(2, 12.0, 1.0, 1.0)]
    span, ratio = overlap_from_traces(traces)
    assert span == 4.0 and ratio == pytest.approx(2.0 / 3.0)
    assert overlap_from_traces([]) == (0.0, 0.0)


@pytest.mark.parametrize("kw,err", [
    (dict(engine="async"), ValueError), (dict(hosts=0), ValueError),
    (dict(max_in_flight=1), ValueError),
    (dict(checkpoint_delta_every=-1), ValueError),
    (dict(async_checkpoint=True), ValueError)])
def test_tree_config_checks_the_engine_knobs(kw, err):
    with pytest.raises(err):
        TreeConfig(k=K, capacity=MU, **kw)
