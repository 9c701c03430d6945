"""The port's fault supervision on the CPU: the seeded injector draws the
JAX package's bits; the supervisor retries, drops, spends its budget,
honours its deadline, evicts and lets a hedge win, with the threads of
those tests ordered by events, not sleeps; recovery leaves the TREE's
result as the fault-free run's, a killed wave folds as ``fail_machines``
but with fewer oracle calls, and the ``replay_signature`` of a chaos run
equals the JAX package's for the same profile, wave width and hosts."""
import dataclasses
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import ExemplarClustering as JExemplar
from repro.core import TreeConfig as JTreeConfig
from repro.core import sources as jsrc
from repro.core import tree_maximize as jtree
from repro.engine import faults as jfaults
from repro_torch.convert import objective_from_numpy
from repro_torch.core import (ArraySource, ChunkedSource, Knapsack,
                              TreeConfig, check_feasible, run_round,
                              tree_maximize)
from repro_torch.core import partition as part_lib
from repro_torch.core.plan import TorchPlan
from repro_torch.core.sources import HostLostError
from repro_torch.data.sources import ShardedSource
from repro_torch.engine import (DroppedFractionExceeded, FaultInjector,
                                FaultPolicy, FaultProfile, FaultStats,
                                FaultSupervisor, PermanentGatherError,
                                StragglerMonitor, TransientIOError)
from repro_torch.engine.faults import _HEDGE_BIT

from _torch_parity import assert_same_tree, jax_tree_plan, tree_inputs

K, MU = 8, 60
JOIN_S = 30.0
# fast retries, no hedges: the stats of a seeded run replay exactly
FAST = FaultPolicy(max_retries=4, backoff_s=0.001, backoff_max_s=0.005,
                   hedge=False)
JFAST = jfaults.FaultPolicy(max_retries=4, backoff_s=0.001,
                            backoff_max_s=0.005, hedge=False)


def _tree(data, E, src=ArraySource, **kw):
    inj = kw.pop("fault_injector", None)
    fail = kw.pop("fail_machines", None)
    cfg = TreeConfig(k=K, capacity=MU, seed=5, **kw)
    return tree_maximize(objective_from_numpy(E, "cpu"), src(data), cfg,
                         device="cpu", wave_machines=3, fault_injector=inj,
                         fail_machines=fail)


def test_policy_backoff_is_exponential_and_capped():
    pol = FaultPolicy(backoff_s=0.1, backoff_mult=2.0, backoff_max_s=0.5)
    assert [pol.backoff(r) for r in range(5)] == pytest.approx(
        [0.1, 0.2, 0.4, 0.5, 0.5])
    assert pol.backoff(10) == 0.5
    with pytest.raises(ValueError):
        FaultPolicy(hedge_factor=1.0)


def test_profile_from_spec_round_trip():
    spec = ("transient=0.3, seed=7, dead_host=1, dead_host_wave=2, "
            "kill=3;5, slow=2;4, latency=0.05, latency_rate=0.1")
    p = FaultProfile.from_spec(spec)
    assert p == FaultProfile(transient_rate=0.3, seed=7, dead_host=1,
                             dead_host_wave=2, kill_waves=(3, 5),
                             slow_waves=(2, 4), latency_s=0.05,
                             latency_rate=0.1)
    assert dataclasses.asdict(p) == dataclasses.asdict(
        jfaults.FaultProfile.from_spec(spec))
    with pytest.raises(ValueError, match="unknown"):
        FaultProfile.from_spec("bogus=1")
    with pytest.raises(ValueError, match="malformed"):
        FaultProfile.from_spec("transient")


def _outcome(hook, *args):
    try:
        hook(*args)
        return "ok"
    except Exception as exc:         # the kind of fault, across packages
        return type(exc).__name__


@pytest.mark.parametrize("seed", [0, 7, 11])
def test_injector_draws_equal_jax(seed):
    kw = dict(transient_rate=0.4, kill_waves=(3,), dead_host=1,
              dead_host_wave=2, seed=seed)
    ours = FaultInjector(FaultProfile(**kw))
    theirs = jfaults.FaultInjector(jfaults.FaultProfile(**kw))
    attempts = [0, 1, 2, 3, _HEDGE_BIT, 1 | _HEDGE_BIT]
    assert _HEDGE_BIT == jfaults._HEDGE_BIT
    for wave in range(24):
        for attempt in attempts:
            for tag in (FaultInjector._TAG_TRANSIENT,
                        FaultInjector._TAG_LATENCY):
                assert ours._roll(tag, wave, attempt) == theirs._roll(
                    tag, wave, attempt)
            assert _outcome(ours.wave_hook, wave, attempt) == _outcome(
                theirs.wave_hook, wave, attempt)
            ho, ht = ours.host_hook(wave, attempt), theirs.host_hook(
                wave, attempt)
            for host in range(4):
                shard = type("Shard", (), {"host": host})()
                want = _outcome(ht, shard)
                assert _outcome(ho, shard) == want
                assert want == ("HostLostError" if host == 1 and wave >= 2
                                else "ok")
    fired = [_outcome(ours.wave_hook, w, 0) for w in range(24)]
    assert "TransientIOError" in fired and "ok" in fired
    assert FaultInjector(FaultProfile()).host_hook(0, 0) is None


def _supervise(policy=FAST, total_rows=1000, **kw):
    return FaultSupervisor(policy, total_rows=total_rows, **kw)


def test_supervisor_retries_then_succeeds():
    sup = _supervise()
    calls = []

    def attempt_fn(attempt):
        calls.append(attempt)
        if len(calls) < 3:
            raise TransientIOError("flaky")
        return "rows"

    assert sup.gather(0, machines=2, rows=100,
                      attempt_fn=attempt_fn) == ("rows", False)
    assert calls == [0, 1, 2]
    st = sup.stats
    assert (st.retries, st.dropped_waves) == (2, 0) and st.recovered_s > 0
    assert [e.kind for e in st.events] == ["transient-retry"] * 2


def test_supervisor_drops_past_its_retries():
    sup = _supervise(policy=FaultPolicy(max_retries=2, backoff_s=0.0))

    def attempt_fn(attempt):
        raise PermanentGatherError("always")

    assert sup.gather(5, machines=3, rows=150,
                      attempt_fn=attempt_fn) == (None, True)
    st = sup.stats
    assert (st.retries, st.dropped_waves, st.dropped_machines,
            st.dropped_rows) == (2, 1, 3, 150)
    assert st.dropped_fraction == pytest.approx(0.15)
    assert st.events[-1].kind == "drop"


def test_supervisor_raises_when_the_budget_is_spent():
    sup = _supervise(policy=FaultPolicy(max_retries=0, backoff_s=0.0,
                                        max_dropped_fraction=0.1))

    def attempt_fn(attempt):
        raise TransientIOError("always")

    with pytest.raises(DroppedFractionExceeded, match="Lemma 3.4"):
        sup.gather(0, machines=4, rows=200, attempt_fn=attempt_fn)


def test_a_bug_is_not_retried():
    sup = _supervise()

    def attempt_fn(attempt):
        raise KeyError("a bug, not a fault")

    with pytest.raises(KeyError):
        sup.gather(0, machines=1, rows=10, attempt_fn=attempt_fn)
    assert sup.stats.retries == 0


def _join(threads):
    for t in threads:
        t.join(JOIN_S)
        assert not t.is_alive()


def test_supervisor_honours_the_deadline():
    """An attempt held by a gate that opens only after the supervisor has
    given up: the deadline abandons it and the wave is dropped."""
    gate = threading.Event()
    threads = []

    def attempt_fn(attempt):
        threads.append(threading.current_thread())
        assert gate.wait(JOIN_S)
        return "late"

    sup = _supervise(policy=FaultPolicy(max_retries=50, backoff_s=0.001,
                                        deadline_s=0.05, hedge=False),
                     concurrent_ok=True)
    try:
        assert sup.gather(0, machines=1, rows=10,
                          attempt_fn=attempt_fn) == (None, True)
    finally:
        gate.set()
        _join(threads)
    assert sup.stats.dropped_waves == 1 and sup.stats.retries == 0
    assert "[deadline]" in sup.stats.events[-1].detail


def test_supervisor_evicts_a_lost_host_without_spending_retries():
    evicted = []

    def evict_cb(host):
        evicted.append(host)
        return True

    sup = _supervise(policy=FaultPolicy(max_retries=0, backoff_s=0.0),
                     evict_cb=evict_cb)
    calls = []

    def attempt_fn(attempt):
        calls.append(attempt)
        if len(calls) == 1:
            raise HostLostError(7)
        return "rerouted"

    assert sup.gather(0, machines=2, rows=100,
                      attempt_fn=attempt_fn) == ("rerouted", False)
    assert evicted == [7] and calls == [0, 1]
    assert (sup.stats.evictions, sup.stats.retries) == (1, 0)
    unavailable = _supervise(evict_cb=lambda host: False)
    assert unavailable.gather(
        0, machines=2, rows=100,
        attempt_fn=lambda a: (_ for _ in ()).throw(HostLostError(0))) == (
        None, True)
    assert unavailable.stats.evictions == 0


def test_supervisor_hedge_first_completion_wins():
    """The primary waits until the hedge has finished, so the hedge wins
    whatever the host's timing; the threshold (2 × 0.1 ms) arms it."""
    hedge_done = threading.Event()
    threads = []

    def attempt_fn(attempt):
        threads.append(threading.current_thread())
        if attempt & _HEDGE_BIT:
            hedge_done.set()
            return "hedge"
        assert hedge_done.wait(JOIN_S)
        return "primary"

    sup = _supervise(policy=FaultPolicy(hedge_factor=2.0, hedge_min_waves=1),
                     rate_hint=lambda: 1e-4, concurrent_ok=True)
    try:
        assert sup.gather(0, machines=1, rows=10,
                          attempt_fn=attempt_fn) == ("hedge", False)
    finally:
        hedge_done.set()
        _join(threads)
    st = sup.stats
    assert (st.hedges, st.hedges_won) == (1, 1)
    assert [e.kind for e in st.events] == ["straggler", "hedge"]


def test_straggler_monitor_threshold():
    mon = StragglerMonitor(factor=3.0, min_samples=3, alpha=0.5)
    assert mon.threshold(10) is None
    assert mon.threshold(10, rate_hint=0.01) == pytest.approx(0.3)
    for seconds in (1.0, 1.0, 4.0):           # 0.1, 0.1, 0.4 s a machine
        mon.observe(seconds, 10)
    # the larger of the median (0.1) and the EWMA (0.25), times 3, × 20
    assert mon.threshold(20) == pytest.approx(15.0)
    assert mon.threshold(20, rate_hint=0.05) == pytest.approx(3.0)


def test_replay_signature_leaves_out_the_timing():
    a, b = FaultStats(total_rows=10), FaultStats(total_rows=10)
    a.retries = b.retries = 2
    a.hedges, b.hedges = 5, 0
    a.recovered_s, b.recovered_s = 1.0, 2.0
    assert a.replay_signature() == b.replay_signature()


@pytest.mark.parametrize("engine", ["sync", "pipelined"])
def test_transient_faults_equal_the_fault_free_run(engine):
    data, E = tree_inputs(seed=1)
    clean = _tree(data, E, engine=engine)
    faulted = _tree(data, E, engine=engine, fault_policy=FAST,
                    fault_injector=FaultInjector(
                        FaultProfile(transient_rate=0.3, seed=7)))
    again = _tree(data, E, engine=engine, fault_policy=FAST,
                  fault_injector=FaultInjector(
                      FaultProfile(transient_rate=0.3, seed=7)))
    assert_same_tree(faulted, clean)
    fs = faulted.fault_stats
    assert fs.retries > 0 and fs.dropped_waves == fs.dropped_rows == 0
    assert fs.replay_signature() == again.fault_stats.replay_signature()
    assert clean.fault_stats is None


@pytest.mark.parametrize("engine", ["sync", "pipelined"])
def test_a_dead_host_is_evicted_losslessly(engine):
    data, E = tree_inputs(seed=3)

    def sharded(d):
        return ShardedSource.from_arrays([d[s:s + 130]
                                          for s in range(0, len(d), 130)])

    clean = _tree(data, E, src=sharded, engine=engine, hosts=3)
    faulted = _tree(data, E, src=sharded, engine=engine, hosts=3,
                    fault_policy=FAST, fault_injector=FaultInjector(
                        FaultProfile(dead_host=1, dead_host_wave=1)))
    assert_same_tree(faulted, clean)
    fs = faulted.fault_stats
    assert (fs.evictions, fs.dropped_rows) == (1, 0)
    per_host = [t.per_host_rows for t in faulted.engine_stats.traces]
    assert len(per_host[0]) == 3 and all(len(p) == 2 for p in per_host[1:])


def _round0_calls(data, E, machines, seed=5):
    """Round-0 oracle calls of ``machines``, solved on their own."""
    L = part_lib.n_parts(len(data), MU)
    part = part_lib.balanced_partition(TorchPlan(seed), 0, len(data), L,
                                       cap=MU)
    blocks, bmask = part_lib.gather_partition(torch.from_numpy(data), part)
    res = run_round(objective_from_numpy(E, "cpu"), blocks[machines],
                    bmask[machines], k=K)
    return int(res.oracle_calls.sum())


@pytest.mark.parametrize("engine", ["sync", "pipelined"])
def test_a_killed_wave_folds_as_fail_machines(engine):
    data, E = tree_inputs(seed=1)
    dropped = _tree(data, E, engine=engine, fault_policy=FAST,
                    fault_injector=FaultInjector(FaultProfile(
                        kill_waves=(1,))))
    fs = dropped.fault_stats
    assert (fs.dropped_waves, fs.dropped_machines) == (1, 3)
    assert 0 < fs.dropped_rows <= 3 * MU
    assert fs.dropped_fraction == pytest.approx(fs.dropped_rows / len(data))
    assert fs.dropped_fraction <= FAST.max_dropped_fraction
    declared = _tree(data, E, fail_machines={0: [3, 4, 5]})
    assert_same_tree(dropped, declared, work=False)
    assert dropped.oracle_calls < declared.oracle_calls
    assert declared.oracle_calls - dropped.oracle_calls == _round0_calls(
        data, E, [3, 4, 5])


def test_killed_wave_keeps_the_constraint_feasible():
    data, E = tree_inputs(seed=2)
    attrs = np.random.default_rng(7).uniform(0.2, 1.0, (len(data), 1)
                                             ).astype(np.float32)
    spec = Knapsack(budget=3.0, col=0)
    res = tree_maximize(
        objective_from_numpy(E, "cpu"),
        ChunkedSource.from_array(data, 128, attrs=attrs),
        TreeConfig(k=K, capacity=MU, seed=4, fault_policy=FAST),
        device="cpu", wave_machines=2, constraint=spec,
        fault_injector=FaultInjector(FaultProfile(
            kill_waves=(0,), transient_rate=0.2, seed=5)))
    assert res.fault_stats.dropped_waves == 1
    ok, detail = check_feasible(spec, res.sel_attrs, res.sel_mask)
    assert ok, detail


def test_the_dropped_fraction_budget_aborts_the_run():
    data, E = tree_inputs(seed=1)
    with pytest.raises(DroppedFractionExceeded):
        _tree(data, E, engine="pipelined",
              fault_policy=FaultPolicy(max_retries=1, backoff_s=0.0,
                                       max_dropped_fraction=0.3),
              fault_injector=FaultInjector(FaultProfile(
                  kill_waves=(0, 1, 2))))


def test_replay_signature_equals_jax():
    """Transient faults, a dead host and a killed wave over three hosts on
    the sync path, the port on the JAX run's plan: the same counters."""
    data, E = tree_inputs(seed=3)
    kw = dict(transient_rate=0.3, dead_host=1, dead_host_wave=1,
              kill_waves=(2,), seed=7)
    jres = jtree(JExemplar(jnp.asarray(E)), jsrc.ArraySource(data),
                 JTreeConfig(k=K, capacity=MU, seed=5, hosts=3,
                             fault_policy=JFAST),
                 wave_machines=3,
                 fault_injector=jfaults.FaultInjector(
                     jfaults.FaultProfile(**kw)))
    res = tree_maximize(
        objective_from_numpy(E, "cpu"), ArraySource(data),
        TreeConfig(k=K, capacity=MU, hosts=3, fault_policy=FAST),
        device="cpu", wave_machines=3,
        plan=jax_tree_plan(5, MU, jres.machines_per_round),
        fault_injector=FaultInjector(FaultProfile(**kw)))
    sig = res.fault_stats.replay_signature()
    assert sig == jres.fault_stats.replay_signature()
    assert sig["retries"] > 0 and sig["evictions"] == 1
    assert sig["dropped_waves"] == 1
    np.testing.assert_array_equal(res.sel_rows, np.asarray(jres.sel_rows))
    assert res.machines_per_round == list(jres.machines_per_round)
