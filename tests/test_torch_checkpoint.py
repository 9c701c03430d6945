"""The port's round checkpoints on the CPU: rotation and the latest
pointer, ``keep=0``, the crashed writer's litter, the row-index delta, the
JAX package's files loading in the port and the port's in the JAX
package's loader with the same arrays; a run stopped after its round-1
checkpoint and resumed (sync and async writer, sync and pipelined engine)
ends as the uninterrupted run; a port run resumed from a JAX run's
checkpoint, on the JAX run's plan, returns the JAX result; a write's error
surfaces at the writer's barrier."""
import os
import shutil

import jax.numpy as jnp
import numpy as np
import pytest

from repro.core import ExemplarClustering as JExemplar
from repro.core import TreeConfig as JTreeConfig
from repro.core import tree_maximize as jtree
from repro.engine import checkpoint as jckpt
from repro_torch import testing
from repro_torch.convert import objective_from_numpy
from repro_torch.core import ChunkedSource, TreeConfig, tree_maximize
from repro_torch.core import tree as tree_lib
from repro_torch.engine import (AsyncCheckpointWriter, FaultInjector,
                                FaultPolicy, FaultProfile, clean_stale_tmp,
                                latest_round_checkpoint,
                                list_round_checkpoints,
                                load_round_checkpoint, round_checkpoint_path,
                                write_round_checkpoint)

from _torch_parity import assert_same_tree, jax_tree_plan, tree_inputs

K, MU = 8, 60
KEYS = {"round", "rows", "mask", "best_rows", "best_mask", "best_val",
        "calls"}


def _snapshot(r, t, n=40, width=5):
    """Round ``t``'s arrays as the tree writes them: rows mostly copied from
    round t − 1's (the union of selections), a few zero, one new."""
    rows = r.standard_normal((n, width)).astype(np.float32)
    return dict(rows=rows, mask=r.random(n) < 0.7,
                best_rows=rows[:4].copy(), best_mask=np.ones(4, bool),
                best_val=float(np.float32(r.random())), calls=int(100 * t))


def _chain(rounds=5, seed=0):
    r = np.random.default_rng(seed)
    snaps = [_snapshot(r, 1)]
    for t in range(2, rounds + 1):
        s = _snapshot(r, t)
        prev = snaps[-1]["rows"]
        s["rows"] = prev[r.integers(0, len(prev), len(prev))].copy()
        s["rows"][3] = 0.0
        s["rows"][7] = np.float32(9.5 + t)
        snaps.append(s)
    return snaps


def _assert_arrays(got, want):
    assert set(got) >= KEYS
    for key in KEYS - {"round"}:
        np.testing.assert_array_equal(got[key], np.asarray(want[key]))
        assert np.asarray(got[key]).dtype == np.asarray(want[key]).dtype


def test_rotation_keeps_k_rounds_and_the_latest_pointer(tmp_path):
    d = str(tmp_path)
    snaps = _chain()
    for t, s in enumerate(snaps, 1):
        write_round_checkpoint(d, t, keep=3, **s)
    assert [r for r, _ in list_round_checkpoints(d)] == [3, 4, 5]
    assert latest_round_checkpoint(d) == round_checkpoint_path(d, 5)
    latest = load_round_checkpoint(os.path.join(d, "tree_round.npz"))
    assert int(latest["round"]) == 5
    _assert_arrays(latest, snaps[-1])


def test_keep_zero_keeps_every_round(tmp_path):
    d = str(tmp_path)
    for t, s in enumerate(_chain(), 1):
        write_round_checkpoint(d, t, keep=0, **s)
    assert [r for r, _ in list_round_checkpoints(d)] == [1, 2, 3, 4, 5]
    os.unlink(round_checkpoint_path(d, 5))
    assert latest_round_checkpoint(d) == round_checkpoint_path(d, 4)
    for r, p in list_round_checkpoints(d):
        os.unlink(p)
    assert latest_round_checkpoint(d) == os.path.join(d, "tree_round.npz")
    assert latest_round_checkpoint(str(tmp_path / "none")) is None


def test_clean_stale_tmp_removes_only_a_crashed_writers_files(tmp_path):
    d = str(tmp_path)
    write_round_checkpoint(d, 1, **_chain(1)[0])
    litter = ["tree_round_r0002.npz.tmp.npz", "tree_round.npz.tmp"]
    for f in litter + ["notes.tmp", "tree_round_r0009.npz.keep"]:
        open(os.path.join(d, f), "wb").close()
    removed = clean_stale_tmp(d)
    assert sorted(os.path.basename(p) for p in removed) == sorted(litter)
    assert sorted(os.listdir(d)) == sorted(
        ["notes.tmp", "tree_round_r0009.npz.keep", "tree_round_r0001.npz",
         "tree_round.npz"])
    assert clean_stale_tmp(str(tmp_path / "absent")) == []


@pytest.mark.parametrize("keep", [0, 1])
def test_delta_encoding_round_trips(tmp_path, keep):
    d = str(tmp_path)
    snaps = _chain(6)
    for t, s in enumerate(snaps, 1):
        write_round_checkpoint(d, t, keep=keep, delta_every=3, **s)
    with np.load(round_checkpoint_path(d, 6)) as z:
        assert "delta_base" not in z.files       # a full snapshot every 3
    kept = [r for r, _ in list_round_checkpoints(d)]
    assert kept == ([1, 2, 3, 4, 5, 6] if keep == 0 else [6])
    for t in kept:
        _assert_arrays(load_round_checkpoint(round_checkpoint_path(d, t)),
                       snaps[t - 1])
    if keep == 0:       # ancestors survive rotation with their deltas
        with np.load(round_checkpoint_path(d, 5)) as z:
            assert int(z["delta_base"]) == 4 and "rows" not in z.files
            assert list(z["delta_extra_pos"]) == [7]
        d2 = str(tmp_path / "k2")
        for t, s in enumerate(snaps[:5], 1):
            write_round_checkpoint(d2, t, keep=2, delta_every=3, **s)
        assert [r for r, _ in list_round_checkpoints(d2)] == [3, 4, 5]
        _assert_arrays(load_round_checkpoint(round_checkpoint_path(d2, 5)),
                       snaps[4])


@pytest.mark.parametrize("delta_every", [0, 2])
def test_files_load_across_the_packages(tmp_path, delta_every):
    snaps = _chain(4, seed=3)
    dj, dt = str(tmp_path / "jax"), str(tmp_path / "torch")
    for t, s in enumerate(snaps, 1):
        jckpt.write_round_checkpoint(dj, t, keep=0, delta_every=delta_every,
                                     **s)
        write_round_checkpoint(dt, t, keep=0, delta_every=delta_every, **s)
    for t, s in enumerate(snaps, 1):
        mine = load_round_checkpoint(round_checkpoint_path(dj, t))
        theirs = jckpt.load_round_checkpoint(round_checkpoint_path(dt, t))
        for got in (mine, theirs):
            _assert_arrays(got, s)
            assert int(got["round"]) == t
        with np.load(round_checkpoint_path(dj, t)) as zj, \
                np.load(round_checkpoint_path(dt, t)) as zt:
            assert zj.files == zt.files
            for key in zj.files:
                assert zj[key].dtype == zt[key].dtype
                assert zj[key].tobytes() == zt[key].tobytes()


def _crash_after_round_1(monkeypatch):
    real = tree_lib._save_round

    def save(d, round_idx, *a):
        real(d, round_idx, *a)
        if round_idx == 1:
            raise KeyboardInterrupt("simulated crash")

    monkeypatch.setattr(tree_lib, "_save_round", save)
    return real


@pytest.mark.parametrize("engine", ["sync", "pipelined"])
@pytest.mark.parametrize("async_checkpoint", [False, True])
def test_a_resumed_run_ends_as_the_uninterrupted_run(tmp_path, monkeypatch,
                                                     engine,
                                                     async_checkpoint):
    data, E = tree_inputs(n=700, seed=3)
    obj = objective_from_numpy(E, "cpu")
    ck = str(tmp_path / "ck")

    def run(**kw):
        cfg = TreeConfig(k=K, capacity=MU, seed=6, engine=engine, hosts=2,
                         async_checkpoint=async_checkpoint and
                         "checkpoint_dir" in kw, checkpoint_delta_every=2,
                         **kw)
        return tree_maximize(obj, ChunkedSource.from_array(data, 100), cfg,
                             device="cpu", wave_machines=2)

    full = run()
    assert full.rounds >= 3 and full.checkpoint_stats is None
    checked = run(checkpoint_dir=str(tmp_path / "full"))
    assert_same_tree(checked, full)
    cs = checked.checkpoint_stats
    assert cs.mode == ("async" if async_checkpoint else "sync")
    assert [r.round for r in cs.rounds] == list(range(1, full.rounds + 1))
    assert cs.write_s > 0 and 0.0 <= cs.hidden_fraction <= 1.0
    assert set(cs.summary()) >= {"mode", "write_s", "wait_s", "hidden_s"}

    real = _crash_after_round_1(monkeypatch)
    with pytest.raises(KeyboardInterrupt):
        run(checkpoint_dir=ck)
    monkeypatch.setattr(tree_lib, "_save_round", real)
    assert [r for r, _ in list_round_checkpoints(ck)] == [1]
    open(os.path.join(ck, "tree_round_r0002.npz.tmp.npz"), "wb").close()
    with pytest.warns(RuntimeWarning, match="stale checkpoint"):
        resumed = run(checkpoint_dir=ck, resume=True)
    np.testing.assert_array_equal(resumed.sel_rows, full.sel_rows)
    np.testing.assert_array_equal(resumed.sel_mask, full.sel_mask)
    assert resumed.value == full.value
    assert resumed.oracle_calls == full.oracle_calls
    assert resumed.rounds == full.rounds
    assert resumed.machines_per_round == full.machines_per_round[1:]
    assert resumed.round_values == full.round_values[1:]
    assert resumed.depth_per_round == full.depth_per_round[1:]
    assert resumed.ingest is None and resumed.engine_stats is None


def test_a_faulted_run_resumes_exactly(tmp_path, monkeypatch):
    data, E = tree_inputs(n=700, seed=3)
    obj = objective_from_numpy(E, "cpu")
    pol = FaultPolicy(max_retries=4, backoff_s=0.001, backoff_max_s=0.005,
                      hedge=False)

    def run(**kw):
        return tree_maximize(
            obj, ChunkedSource.from_array(data, 100),
            TreeConfig(k=K, capacity=MU, seed=6, engine="pipelined",
                       fault_policy=pol, **kw), device="cpu",
            wave_machines=2, fault_injector=FaultInjector(
                FaultProfile(transient_rate=0.3, seed=9)))

    full = run()
    assert full.fault_stats.retries > 0
    ck = str(tmp_path / "ck")
    real = _crash_after_round_1(monkeypatch)
    with pytest.raises(KeyboardInterrupt):
        run(checkpoint_dir=ck)
    monkeypatch.setattr(tree_lib, "_save_round", real)
    resumed = run(checkpoint_dir=ck, resume=True)
    np.testing.assert_array_equal(resumed.sel_rows, full.sel_rows)
    assert resumed.value == full.value
    assert resumed.oracle_calls == full.oracle_calls
    assert resumed.fault_stats is None     # round 0 was not run again


def test_a_port_run_resumes_a_jax_checkpoint(tmp_path):
    data, E = tree_inputs(n=900, seed=4)
    jdir, dir_ = str(tmp_path / "jax"), str(tmp_path / "port")
    jres = jtree(JExemplar(jnp.asarray(E)), jnp.asarray(data),
                 JTreeConfig(k=K, capacity=MU, seed=2, checkpoint_dir=jdir,
                             checkpoint_keep=0))
    assert jres.rounds >= 3
    os.makedirs(dir_)
    shutil.copy(round_checkpoint_path(jdir, 1), dir_)
    res = tree_maximize(
        objective_from_numpy(E, "cpu"), data,
        TreeConfig(k=K, capacity=MU, checkpoint_dir=dir_, resume=True),
        device="cpu", plan=jax_tree_plan(2, MU, jres.machines_per_round))
    np.testing.assert_array_equal(res.sel_rows, np.asarray(jres.sel_rows))
    np.testing.assert_array_equal(res.sel_mask, np.asarray(jres.sel_mask))
    testing.assert_close(res.value, jres.value)
    assert res.oracle_calls == int(jres.oracle_calls)
    assert res.rounds == jres.rounds
    assert res.machines_per_round == list(jres.machines_per_round[1:])
    # and the port's own round-2 file loads in the JAX package's loader
    mine = jckpt.load_round_checkpoint(round_checkpoint_path(dir_, 2))
    theirs = jckpt.load_round_checkpoint(round_checkpoint_path(jdir, 2))
    np.testing.assert_array_equal(mine["rows"], theirs["rows"])
    np.testing.assert_array_equal(mine["mask"], theirs["mask"])
    assert int(mine["calls"]) == int(theirs["calls"])


def test_a_write_error_surfaces_at_the_barrier(tmp_path, monkeypatch):
    def fail(*args):
        raise OSError("disk full")

    writer = AsyncCheckpointWriter(fail)
    writer.submit(1, "x")
    with pytest.raises(OSError, match="disk full"):
        writer.wait()
    writer.wait()                           # reported once
    writer.submit(2, "y")
    writer.abort()                          # the caller's error wins
    writer.wait()
    assert [r.round for r in writer.stats().rounds] == [1, 2]

    data, E = tree_inputs(seed=5)
    monkeypatch.setattr(tree_lib, "_save_round", fail)
    with pytest.raises(OSError, match="disk full"):
        tree_maximize(objective_from_numpy(E, "cpu"), data,
                      TreeConfig(k=K, capacity=MU,
                                 checkpoint_dir=str(tmp_path),
                                 async_checkpoint=True), device="cpu")
