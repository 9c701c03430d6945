"""The port's core modules against the JAX package on the CPU: objective,
greedy (scan and fused), algorithm dispatch, partitioning with a replayed
plan, one round with dead machines, and the package's import and device
guards."""
import pkgutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import ExemplarClustering as JExemplar
from repro.core import algorithms as jalg
from repro.core import distributed as jdist
from repro.core import partition as jpart
import repro_torch
from repro_torch import testing
from repro_torch.convert import ArrayPlan, objective_from_numpy
from repro_torch.core import (TorchPlan, TreeConfig, centralized_greedy,
                              tree_maximize)
from repro_torch.core import algorithms, distributed, partition
from repro_torch.core.constraints import Unconstrained

from _torch_parity import make_inputs


def _pair(m, d, seed):
    E = np.random.default_rng(seed).standard_normal((m, d)).astype(np.float32)
    return JExemplar(jnp.asarray(E)), objective_from_numpy(E, "cpu")


def test_objective_oracle_matches_jax():
    X, _, mask = make_inputs(1, 40, 19, 6, seed=11)
    jobj, tobj = _pair(19, 6, seed=12)
    T, Tt = jnp.asarray(X[0]), torch.from_numpy(X[0])
    m, mt = jnp.asarray(mask[0]), torch.from_numpy(mask[0])
    js, ts = jobj.init_state(T, m), tobj.init_state(Tt, mt)
    testing.assert_close(ts["cur_min"], js["cur_min"])
    testing.assert_close(ts["base"], js["base"])
    testing.assert_close(tobj.gains(ts, Tt, mt), jobj.gains(js, T, m))
    js = jobj.update(js, T, jnp.int32(7))
    ts = tobj.update(ts, Tt, torch.tensor(7))
    testing.assert_close(ts["cur_min"], js["cur_min"])
    testing.assert_close(tobj.value(ts), jobj.value(js))


def test_evaluate_matches_jax_and_state_value():
    X, _, _ = make_inputs(1, 12, 23, 5, seed=13)
    jobj, tobj = _pair(23, 5, seed=14)
    smask = np.array([True] * 9 + [False] * 3)
    got = tobj.evaluate(torch.from_numpy(X[0]), torch.from_numpy(smask))
    testing.assert_close(got, jobj.evaluate(jnp.asarray(X[0]),
                                            jnp.asarray(smask)))
    state = tobj.init_state(torch.from_numpy(X[0]), torch.ones(12, dtype=bool))
    for i in range(9):
        state = tobj.update(state, torch.from_numpy(X[0]), torch.tensor(i))
    testing.assert_close(tobj.value(state), got)


@pytest.mark.parametrize("M,n,m,d,k", [(1, 50, 17, 6, 8), (3, 41, 30, 9, 45)])
def test_fused_bit_identical_to_scan(M, n, m, d, k):
    """On the CPU both paths run the plain version: same indices, same
    value bits, same oracle calls — per machine and batched."""
    X, E, mask = make_inputs(M, n, m, d, seed=n + k)
    obj = objective_from_numpy(E, "cpu")
    Xt, mt = torch.from_numpy(X), torch.from_numpy(mask)
    scan = algorithms.greedy(obj, Xt, mt, k, fused=False)
    fused = algorithms.greedy(obj, Xt, mt, k)
    assert torch.equal(scan.sel_idx, fused.sel_idx)
    assert torch.equal(scan.sel_mask, fused.sel_mask)
    assert scan.value.numpy().tobytes() == fused.value.numpy().tobytes()
    assert torch.equal(scan.oracle_calls, fused.oracle_calls)
    assert torch.equal(scan.depth, torch.full((M,), k))
    one = algorithms.greedy(obj, Xt[M - 1], mt[M - 1], k)
    assert torch.equal(one.sel_idx, fused.sel_idx[M - 1])


@pytest.mark.parametrize("fused", [False, True])
def test_greedy_matches_jax(fused):
    X, E, mask = make_inputs(1, 70, 33, 7, seed=21)
    jres = jalg.greedy(JExemplar(jnp.asarray(E)), jnp.asarray(X[0]),
                       jnp.asarray(mask[0]), 12, fused=fused)
    tres = algorithms.greedy(objective_from_numpy(E, "cpu"),
                             torch.from_numpy(X[0]), torch.from_numpy(mask[0]),
                             12, fused=fused)
    np.testing.assert_array_equal(tres.sel_idx.numpy(),
                                  np.asarray(jres.sel_idx))
    np.testing.assert_array_equal(tres.sel_mask.numpy(),
                                  np.asarray(jres.sel_mask))
    assert int(tres.oracle_calls) == int(jres.oracle_calls)
    testing.assert_close(tres.value, jres.value)


def test_run_algorithm_hygiene():
    X, E, mask = make_inputs(1, 20, 8, 3, seed=2)
    obj = objective_from_numpy(E, "cpu")
    args = (obj, torch.from_numpy(X[0]), torch.from_numpy(mask[0]), 3)
    with pytest.raises(ValueError, match="unknown algorithm"):
        algorithms.run_algorithm("lazy_greedy", *args)
    with pytest.raises(ValueError, match="does not accept"):
        algorithms.run_algorithm("greedy", *args, eps=0.1)
    with pytest.raises(ValueError, match="does not accept"):
        algorithms.run_algorithm("greedy", *args, key=1)
    with pytest.raises(ValueError, match="does not accept"):
        algorithms.run_algorithm("threshold_greedy", *args, fused=True)
    for name in ("stochastic_greedy", "threshold_greedy", "threshold_batch"):
        with pytest.raises(NotImplementedError, match="ROADMAP queue 1 item 8"):
            algorithms.run_algorithm(name, *args)
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1 item 7"):
        algorithms.greedy(*args, constraint=object())
    assert algorithms.driver_kwargs("greedy", key=1, eps=0.5) == {}
    assert algorithms.driver_kwargs("greedy", key=1, eps=0.5) == \
        jalg.driver_kwargs("greedy", key=1, eps=0.5)
    assert algorithms.driver_kwargs("stochastic_greedy", key=1, eps=0.5) == \
        {"key": 1, "eps": 0.5}
    assert set(algorithms.ALGORITHM_KWARGS) == set(jalg.ALGORITHM_KWARGS)
    res = algorithms.run_algorithm("greedy", *args,
                                   constraint=Unconstrained())
    assert res.sel_idx.shape == (3,)


@pytest.mark.parametrize("n_items,L,cap", [(100, 4, 30), (97, 7, None),
                                           (10, 1, 12)])
def test_balanced_partition_matches_jax(n_items, L, cap):
    key = jax.random.PRNGKey(n_items)
    jp = jpart.balanced_partition(key, n_items, L, cap=cap)
    n_slots = int(np.asarray(jp.idx).size)
    plan = ArrayPlan([np.asarray(jax.random.permutation(key, n_slots))])
    tp = partition.balanced_partition(plan, 0, n_items, L, cap=cap)
    np.testing.assert_array_equal(tp.idx.numpy(), np.asarray(jp.idx))
    np.testing.assert_array_equal(tp.mask.numpy(), np.asarray(jp.mask))
    data = np.random.default_rng(0).standard_normal((n_items, 3)).astype(
        np.float32)
    jb, jm = jpart.gather_partition(jnp.asarray(data), jp)
    tb, tm = partition.gather_partition(torch.from_numpy(data), tp)
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))


@pytest.mark.parametrize("N,L,cap", [(40, 3, 20), (40, 1, 25), (60, 2, 18)])
def test_repartition_rows_matches_jax(N, L, cap):
    r = np.random.default_rng(N + L)
    rows = r.standard_normal((N, 4)).astype(np.float32)
    mask = r.random(N) < 0.5
    mask[np.flatnonzero(mask)[L * cap:]] = False     # the driver's bound
    key = jax.random.PRNGKey(L)
    jb, jm = jpart.repartition_rows(jnp.asarray(rows), jnp.asarray(mask), key,
                                    L, cap)
    plan = ArrayPlan([np.zeros(0), np.asarray(
        jax.random.permutation(key, L * cap))])
    tb, tm = partition.repartition_rows(torch.from_numpy(rows),
                                        torch.from_numpy(mask), plan, 1, L,
                                        cap)
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))


def test_plans():
    plan = TorchPlan(3)
    p = plan.slot_permutation(2, 50)
    assert torch.equal(torch.sort(p).values, torch.arange(50))
    assert torch.equal(p, TorchPlan(3).slot_permutation(2, 50))
    assert not torch.equal(p, plan.slot_permutation(1, 50))
    arr = ArrayPlan([np.arange(5)])
    assert torch.equal(arr.slot_permutation(0, 5), torch.arange(5))
    with pytest.raises(ValueError, match="slots"):
        arr.slot_permutation(0, 6)
    with pytest.raises(IndexError):
        arr.slot_permutation(1, 5)


def test_run_round_with_dead_machines_matches_jax():
    M, cap, m, d, k = 4, 30, 15, 5, 6
    X, E, mask = make_inputs(M, cap, m, d, seed=5)
    mask[2] = False                                     # an empty machine
    dead = np.array([False, True, False, False])
    jres = jdist.run_round(JExemplar(jnp.asarray(E)), jnp.asarray(X),
                           jnp.asarray(mask),
                           jax.random.split(jax.random.PRNGKey(0), M), k=k,
                           dead_mask=jnp.asarray(dead))
    tres = distributed.run_round(objective_from_numpy(E, "cpu"),
                                 torch.from_numpy(X), torch.from_numpy(mask),
                                 k=k, dead_mask=torch.from_numpy(dead))
    np.testing.assert_array_equal(tres.sol_rows.numpy(),
                                  np.asarray(jres.sol_rows))
    np.testing.assert_array_equal(tres.sol_mask.numpy(),
                                  np.asarray(jres.sol_mask))
    np.testing.assert_array_equal(tres.oracle_calls.numpy(),
                                  np.asarray(jres.oracle_calls))
    np.testing.assert_array_equal(tres.depth.numpy(), np.asarray(jres.depth))
    assert np.array_equal(np.isinf(tres.values.numpy()),
                          np.isinf(np.asarray(jres.values)))
    live = ~np.isinf(np.asarray(jres.values))
    testing.assert_close(tres.values.numpy()[live],
                         np.asarray(jres.values)[live])


def test_package_imports_neither_jax_nor_repro():
    """Import every module of repro_torch in a fresh interpreter; neither
    jax nor any repro module may come along."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(n for n in sys.modules if n == 'jax' or n.startswith("
        "'jax.') or n == 'repro' or n.startswith('repro.'))\n"
        "assert not bad, bad\n"
        "print(len([n for n in sys.modules if n.startswith('repro_torch')]))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    n_modules = len(list(pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")))
    assert int(out.stdout.split()[-1]) >= n_modules


def test_entry_points_default_to_the_card():
    """With no card, the default device raises instead of running on the
    CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device runs there")
    X, E, _ = make_inputs(1, 30, 6, 3, seed=0)
    obj = objective_from_numpy(E, "cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        tree_maximize(obj, X[0], TreeConfig(k=2, capacity=5))
    with pytest.raises(RuntimeError, match="CUDA"):
        centralized_greedy(obj, X[0], 2)
    with pytest.raises(RuntimeError, match="CUDA"):
        objective_from_numpy(E)


def test_chip_smoke_prints_no_result_without_card_or_repo(tmp_path):
    """chip_smoke.py alone in a directory without the package fails and
    prints no ok line (on a machine without a card it fails earlier, at
    the card check)."""
    import shutil
    from pathlib import Path
    script = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    shutil.copy(script, tmp_path / "chip_smoke.py")
    out = subprocess.run([sys.executable, str(tmp_path / "chip_smoke.py")],
                         capture_output=True, text=True, timeout=120,
                         cwd=tmp_path, env={"PATH": "/usr/bin:/bin"})
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
