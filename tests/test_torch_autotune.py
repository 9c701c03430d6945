"""The port's wave autotuner against the JAX package on the CPU
(``tests/test_autotune.py``'s counterpart): the ladder, bound and snap;
the same trace stream into both packages' ``AutotunePlanner`` gives the
same widths; ``suggest_prefetch_depth``; the converged-rung cache, a JAX
file seeding the port; and autotuned and scheduled runs (sync and
pipelined, constrained, sharded) equal to the JAX resident TREE for one
plan, resumed across different width trajectories."""
import json
import shutil

import jax.numpy as jnp
import numpy as np
import pytest

from repro.core import ExemplarClustering as JExemplar
from repro.core import TreeConfig as JTreeConfig
from repro.core import tree_maximize as jtree
from repro.core.sources import ChunkedSource as JChunkedSource
from repro.engine import autotune as jat
from repro.engine import WaveTrace as JWaveTrace
from repro_torch import testing
from repro_torch.convert import constraint_from_jax, objective_from_numpy
from repro_torch.core import ChunkedSource, TreeConfig, tree_maximize
from repro_torch.core import tree as tree_lib
from repro_torch.data.sources import ShardedSource
from repro_torch.engine import (AutotuneCache, AutotunePlanner,
                                FixedWidthPlanner, ScheduledWidthPlanner,
                                Tracer, WaveTrace, bucket_ladder,
                                list_round_checkpoints, shape_bound,
                                snap_down, suggest_prefetch_depth)

from _torch_parity import assert_same_tree, jax_tree_plan, tree_inputs

K, MU = 8, 60


def _traces(machines, gather_s, solve_s, wave=0):
    """One wave's trace in each package (the JAX one has no H2D column)."""
    kw = dict(wave=wave, machines=machines, rows=machines,
              bytes_moved=4 * machines, gather_s=gather_s, solve_s=solve_s)
    return WaveTrace(h2d_s=0.0, **kw), JWaveTrace(**kw)


# -- controller units ---------------------------------------------------


@pytest.mark.parametrize("ndev,w_max", [(1, 1), (1, 8), (2, 12), (1, 497),
                                        (4, 64), (1, 1000), (3, 3)])
def test_ladder_bound_and_snap_match_jax(ndev, w_max):
    ladder = bucket_ladder(ndev, w_max)
    assert ladder == jat.bucket_ladder(ndev, w_max)
    assert shape_bound(ndev, w_max) == jat.shape_bound(ndev, w_max)
    assert len(ladder) <= shape_bound(ndev, w_max)
    for w in range(ladder[0], w_max + 3):
        assert snap_down(ladder, w) == jat.snap_down(ladder, w)
    with pytest.raises(ValueError):
        snap_down(ladder, ladder[0] - 1)


def test_ladder_at_webscope_budget():
    """One card, 256 MiB of fp32 Webscope blocks: 497 machines a wave."""
    assert bucket_ladder(1, 497) == [1, 2, 4, 8, 16, 32, 64, 128, 256, 497]
    assert shape_bound(1, 497) == 10
    with pytest.raises(ValueError):
        bucket_ladder(2, 7)


def test_fixed_and_scheduled_planners():
    p = FixedWidthPlanner(3)
    assert [p.next_width(r) for r in (10, 7, 4, 1)] == [3, 3, 3, 1]
    s = ScheduledWidthPlanner([1, 7, 2])
    j = jat.ScheduledWidthPlanner([1, 7, 2])
    for remaining in (100, 100, 100, 100, 1):
        assert s.next_width(remaining) == j.next_width(remaining)
    with pytest.raises(ValueError):
        ScheduledWidthPlanner([])


def _climb(w, wave):
    return 0.010 + 0.001 * w, 0.001


def _cliff(w, wave):
    return (0.008 + 0.001 * w if w < 8 else 0.020 * w), 0.0001


_INTERIOR = {1: 1.0, 2: 0.55, 4: 0.30, 8: 0.45, 16: 0.90}


def _interior(w, wave):
    return _INTERIOR[w] * w, 0.0001


def _oscillate(w, wave):
    return (0.01 if wave % 2 == 0 else 0.0001) * w, 0.0001


def _first_sample(seen):
    def cost(w, wave):
        seen[w] = seen.get(w, 0) + 1
        return (0.050 if seen[w] == 1 else 0.001) * (8.0 / w) * w, 0.0001
    return cost


def _noisy(w, wave):
    r = np.random.default_rng(wave)
    return float(r.uniform(0.5, 2.0)) * (0.004 + 0.002 * w), \
        float(r.uniform(0.001, 0.05)) * w


SCENARIOS = {
    # name: (ladder cap, start, waves, remaining, cost(w, wave) → (g, s))
    "climb": (16, 1, 24, 1_000, lambda: _climb),
    "back-off": (16, 1, 30, 1_000, lambda: _cliff),
    "interior-optimum": (16, 1, 40, 10_000, lambda: _interior),
    "forced-oscillation": (8, 2, 40, 10_000, lambda: _oscillate),
    "first-sample-discard": (8, 1, 24, 1_000, lambda: _first_sample({})),
    "noisy-both-tracks": (64, 4, 60, 100_000, lambda: _noisy),
    "ragged-tail": (16, 4, 30, 97, lambda: _climb),
}


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_planner_widths_equal_jax_on_the_same_traces(scenario):
    cap, start, waves, remaining, make = SCENARIOS[scenario]
    ladder = bucket_ladder(1, cap)
    port = AutotunePlanner(ladder, start=start, warmup=1)
    ref = jat.AutotunePlanner(ladder, start=start, warmup=1)
    cost = make()
    widths, left = [], remaining
    for wave in range(waves):
        if left <= 0:
            break
        w = port.next_width(left)
        assert w == ref.next_width(left)
        assert w in ladder and 1 <= w <= left
        widths.append(w)
        left -= w
        g, s = cost(w, wave)
        ours, theirs = _traces(w, g, s, wave)
        port.observe(ours)
        ref.observe(theirs)
        assert port.gather_rate() == ref.gather_rate()
    assert port.converged_width() == ref.converged_width()
    if scenario == "climb":
        assert widths[-1] == 16 and widths == sorted(widths)
    if scenario == "back-off":
        assert widths[-1] < 8 and (8 in widths or 16 in widths)
    if scenario == "interior-optimum":
        assert 8 in widths and all(w == 4 for w in widths[-10:])
    if scenario == "first-sample-discard":
        assert widths[-1] == 8


def test_the_device_track_is_the_stage_and_the_solve():
    """The consumer's cost is H2D + solve: a trace split across the two
    columns scores as the JAX trace with their sum as its solve."""
    ladder = bucket_ladder(1, 8)
    a = AutotunePlanner(ladder, start=1)
    b = jat.AutotunePlanner(ladder, start=1)
    for wave in range(12):
        w = a.next_width(1000)
        assert w == b.next_width(1000)
        s = 0.003 * w + 0.02
        a.observe(WaveTrace(wave=wave, machines=w, rows=w, bytes_moved=w,
                            gather_s=0.001, h2d_s=s / 4, solve_s=3 * s / 4))
        b.observe(JWaveTrace(wave=wave, machines=w, rows=w, bytes_moved=w,
                             gather_s=0.001, solve_s=s))


def test_seed_and_rung_instants():
    ladder = bucket_ladder(1, 16)
    p = AutotunePlanner(ladder, start=1)
    p.seed(8)
    tr = Tracer()
    p.tracer = tr
    assert p.next_width(100) == 8 and p.converged_width() == 8
    p.observe(_traces(8, 0.1, 0.01)[0])
    p.next_width(100)
    p.observe(_traces(8, 0.1, 0.01)[0])
    assert p.next_width(100) == 16
    rung = tr.spans(cat="autotune", name="rung")
    assert rung and rung[-1].args["width"] == 16
    assert rung[-1].args["direction"] == "up"
    with pytest.raises(RuntimeError):
        p.seed(4)
    with pytest.raises(ValueError):
        AutotunePlanner(ladder, start=3)


@pytest.mark.parametrize("gather,solve", [
    (0.0, 0.0), (0.1, 10.0), (10.0, 2.0), (100.0, 0.1), (3.0, 3.0),
    (1e-12, 1.0), (1.0, 1e-12), (5.0, 0.9)])
@pytest.mark.parametrize("lo,hi", [(2, 8), (3, 4), (1, 1)])
def test_suggest_prefetch_depth_matches_jax(gather, solve, lo, hi):
    assert suggest_prefetch_depth(gather, solve, lo=lo, hi=hi) == \
        jat.suggest_prefetch_depth(gather, solve, lo=lo, hi=hi)


def test_cache_round_trip_and_a_jax_file_seeds_the_port(tmp_path):
    path = str(tmp_path / "sub" / "cache.json")
    c = AutotuneCache(path)
    assert c.get("x") is None
    c.put("x", 8)
    assert c.get("x") == 8 and jat.AutotuneCache(path).get("x") == 8
    open(path, "w").write("{not json")
    assert c.get("x") is None
    c.put("y", 2)
    assert json.load(open(path)) == {"y": 2}

    data, E = tree_inputs(n=901, seed=1)
    src = ChunkedSource.from_array(data, 128)
    jsrc = JChunkedSource.from_array(data, 128)
    assert src.fingerprint() == jsrc.fingerprint()
    jpath = str(tmp_path / "jax.json")
    jat.AutotuneCache(jpath).put(f"{jsrc.fingerprint()}|mu={MU}|ndev=1", 4)
    res = tree_maximize(objective_from_numpy(E, "cpu"), src,
                        TreeConfig(k=K, capacity=MU, seed=5,
                                   wave_autotune=True, autotune_cache=jpath),
                        device="cpu")
    assert res.engine_stats.width_trajectory[0] == 4
    stored = AutotuneCache(jpath).get(f"{src.fingerprint()}|mu={MU}|ndev=1")
    assert stored in bucket_ladder(1, res.ingest.total_machines)


# -- every trajectory is the fixed-width result -------------------------


def _same_as_jax(res, jres):
    """Integer outputs exactly, values within the tolerance."""
    np.testing.assert_array_equal(res.sel_rows, np.asarray(jres.sel_rows))
    np.testing.assert_array_equal(res.sel_mask, np.asarray(jres.sel_mask))
    testing.assert_close(res.value, jres.value)
    testing.assert_close(res.round_values, jres.round_values)
    assert res.oracle_calls == int(jres.oracle_calls)
    assert res.rounds == jres.rounds
    assert res.machines_per_round == list(jres.machines_per_round)
    assert res.depth_per_round == list(jres.depth_per_round)


def _jax_resident(data, E, seed, constraint=None, attrs=None):
    jres = jtree(JExemplar(jnp.asarray(E)), jnp.asarray(data),
                 JTreeConfig(k=K, capacity=MU, seed=seed),
                 constraint=constraint, attrs=attrs)
    return jres, jax_tree_plan(seed, MU, jres.machines_per_round)


@pytest.mark.parametrize("engine", ["sync", "pipelined"])
def test_autotuned_run_equals_jax_resident(engine):
    data, E = tree_inputs(n=901, seed=1)
    jres, plan = _jax_resident(data, E, 5)
    res = tree_maximize(objective_from_numpy(E, "cpu"),
                        ChunkedSource.from_array(data, 128),
                        TreeConfig(k=K, capacity=MU, seed=5, engine=engine,
                                   wave_autotune=True), device="cpu",
                        plan=plan)
    _same_as_jax(res, jres)
    es = res.engine_stats
    assert sum(es.width_trajectory) == res.ingest.total_machines
    ladder = bucket_ladder(1, res.ingest.total_machines)
    assert set(es.width_trajectory) <= set(ladder)
    assert es.distinct_shapes <= shape_bound(1, ladder[-1])


def test_autotune_caps_at_wave_machines_and_byte_budget():
    data, E = tree_inputs(n=901, seed=7)
    obj = objective_from_numpy(E, "cpu")
    ref = tree_maximize(obj, data, TreeConfig(k=K, capacity=MU, seed=9),
                        device="cpu")
    res = tree_maximize(obj, ChunkedSource.from_array(data, 128),
                        TreeConfig(k=K, capacity=MU, seed=9,
                                   engine="pipelined", wave_autotune=True),
                        device="cpu", wave_machines=4)
    assert max(res.engine_stats.width_trajectory) <= 4
    assert res.ingest.peak_wave_rows <= 4 * MU
    assert_same_tree(res, ref)
    budget = 5 * MU * data.shape[1] * 4
    res = tree_maximize(obj, ChunkedSource.from_array(data, 128),
                        TreeConfig(k=K, capacity=MU, seed=9,
                                   engine="pipelined", wave_autotune=True,
                                   capacity_bytes=budget), device="cpu")
    assert max(res.engine_stats.width_trajectory) <= 5
    assert res.ingest.peak_wave_bytes <= budget
    assert_same_tree(res, ref)


@pytest.mark.parametrize("schedule", [
    [1], [2], [4], [8], [16], [1, 8, 1, 8, 1, 8], [5, 1, 7, 2, 16, 1],
    [16, 16]], ids=["w1", "w2", "w4", "w8", "w16", "oscillate", "mixed",
                    "oversized"])
@pytest.mark.parametrize("engine", ["sync", "pipelined"])
def test_scheduled_widths_equal_jax_resident(engine, schedule):
    data, E = tree_inputs(n=901, seed=3)
    jres, plan = _jax_resident(data, E, 7)
    res = tree_maximize(objective_from_numpy(E, "cpu"),
                        ChunkedSource.from_array(data, 128),
                        TreeConfig(k=K, capacity=MU, seed=7, engine=engine),
                        device="cpu", plan=plan, wave_schedule=schedule)
    _same_as_jax(res, jres)
    assert sum(res.engine_stats.width_trajectory) == \
        res.ingest.total_machines


def test_schedule_constrained_and_sharded_equals_jax_resident():
    from repro.core import Intersection, Knapsack, PartitionMatroid
    data, E = tree_inputs(n=780, seed=4)
    r = np.random.default_rng(11)
    attrs = np.stack([r.uniform(0.2, 1.0, len(data)),
                      r.integers(0, 3, len(data))], 1).astype(np.float32)
    jc = Intersection((Knapsack(budget=4.0, col=0),
                       PartitionMatroid(caps=(3, 3, 3), col=1)))
    jres, plan = _jax_resident(data, E, 2, constraint=jc, attrs=attrs)
    src = ShardedSource.from_arrays(
        [data[s:s + 130] for s in range(0, len(data), 130)],
        attrs=[attrs[s:s + 130] for s in range(0, len(data), 130)])
    for cfg_kw, kw in ((dict(engine="pipelined", hosts=2),
                        dict(wave_schedule=[3, 1, 5, 1])),
                       (dict(engine="pipelined", hosts=3,
                             wave_autotune=True), {})):
        res = tree_maximize(objective_from_numpy(E, "cpu"), src,
                            TreeConfig(k=K, capacity=MU, seed=2, **cfg_kw),
                            device="cpu", plan=plan,
                            constraint=constraint_from_jax(jc), **kw)
        _same_as_jax(res, jres)
        np.testing.assert_array_equal(res.sel_attrs,
                                      np.asarray(jres.sel_attrs))


def test_resume_across_different_width_trajectories(tmp_path, monkeypatch):
    """A checkpoint of a scheduled pipelined run resumes under a fixed
    width, another schedule and the autotuner: the checkpoint holds no
    width."""
    data, E = tree_inputs(n=700, seed=5)
    obj = objective_from_numpy(E, "cpu")

    def run(ckpt=None, resume=False, cfg=None, **kw):
        return tree_maximize(
            obj, ChunkedSource.from_array(data, 100),
            TreeConfig(k=K, capacity=MU, seed=6, checkpoint_dir=ckpt,
                       resume=resume, **(cfg or {})), device="cpu", **kw)

    full = run(wave_machines=2)
    assert full.rounds >= 2
    ck = str(tmp_path / "ck")
    real = tree_lib._save_round

    def crash_after_round_1(d, round_idx, *a):
        real(d, round_idx, *a)
        if round_idx == 1:
            raise KeyboardInterrupt("stopped after round 1")

    monkeypatch.setattr(tree_lib, "_save_round", crash_after_round_1)
    with pytest.raises(KeyboardInterrupt):
        run(ckpt=ck, wave_schedule=[1, 5, 2], cfg=dict(engine="pipelined"))
    monkeypatch.setattr(tree_lib, "_save_round", real)
    assert [r for r, _ in list_round_checkpoints(ck)] == [1]
    for i, kw in enumerate((dict(wave_machines=2),
                            dict(wave_schedule=[7, 1, 1]),
                            dict(cfg=dict(wave_autotune=True,
                                          engine="pipelined")))):
        ck_i = str(tmp_path / f"ck{i}")
        shutil.copytree(ck, ck_i)
        resumed = run(ckpt=ck_i, resume=True, **kw)
        np.testing.assert_array_equal(resumed.sel_rows, full.sel_rows)
        np.testing.assert_array_equal(resumed.sel_mask, full.sel_mask)
        assert resumed.value == full.value
        assert resumed.oracle_calls == full.oracle_calls
        assert resumed.rounds == full.rounds
        assert resumed.machines_per_round == full.machines_per_round[1:]
