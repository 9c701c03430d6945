"""End-to-end parity of the port's resident TREE and centralized greedy
with the JAX package on the CPU, given the same round plan."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import ExemplarClustering as JExemplar
from repro.core import TreeConfig as JTreeConfig
from repro.core import centralized_greedy as jcentralized
from repro.core import tree_maximize as jtree
from repro.data import datasets as jdatasets
from repro_torch import testing
from repro_torch.convert import objective_from_numpy
from repro_torch.core import (TorchPlan, TreeConfig, centralized_greedy,
                              random_subset, tree_maximize)
from repro_torch.data import datasets

from _torch_parity import jax_tree_plan

CASES = {
    # n, d, k, μ, eval rows, failed machines → 3 rounds, machines [25, 3, 1]
    "csn3000": (3000, 17, 10, 120, 128, None),
    "csn3000-failures": (3000, 17, 10, 120, 128, {0: [0, 3], 1: [1]}),
    # the quickstart size: 9 rounds
    "csn10000": (10_000, 17, 20, 40, 512, None),
}


def _eval_rows(data, n_eval):
    r = np.random.default_rng(0)
    return data[r.choice(len(data), n_eval, replace=False)]


@pytest.mark.parametrize("case", sorted(CASES))
def test_tree_matches_jax(case):
    n, d, k, mu, n_eval, fail = CASES[case]
    data = datasets.csn(n=n, d=d)
    assert data.tobytes() == jdatasets.csn(n=n, d=d).tobytes()
    E = _eval_rows(data, n_eval)
    jres = jtree(JExemplar(jnp.asarray(E)), jnp.asarray(data),
                 JTreeConfig(k=k, capacity=mu, seed=0), fail_machines=fail)
    plan = jax_tree_plan(0, mu, jres.machines_per_round)
    cfg = TreeConfig(k=k, capacity=mu, seed=0)
    tres = tree_maximize(objective_from_numpy(E, "cpu"), data, cfg,
                         device="cpu", plan=plan, fail_machines=fail)
    np.testing.assert_array_equal(tres.sel_rows, np.asarray(jres.sel_rows))
    np.testing.assert_array_equal(tres.sel_mask, np.asarray(jres.sel_mask))
    assert tres.rounds == jres.rounds
    assert tres.machines_per_round == jres.machines_per_round
    assert tres.oracle_calls == jres.oracle_calls
    assert tres.depth_per_round == jres.depth_per_round
    assert tres.solve_depth == jres.solve_depth
    assert tres.rounds <= cfg.round_bound_exact(n)
    assert cfg.round_bound(n) == JTreeConfig(k=k, capacity=mu).round_bound(n)
    testing.assert_close(tres.value, jres.value)
    testing.assert_close(tres.round_values, jres.round_values)
    assert len(tres.round_walls) == tres.rounds


def test_centralized_greedy_matches_jax():
    data = datasets.csn(n=3000, d=17)
    E = _eval_rows(data, 128)
    jres = jcentralized(JExemplar(jnp.asarray(E)), jnp.asarray(data), 10)
    obj = objective_from_numpy(E, "cpu")
    tres = centralized_greedy(obj, data, 10, device="cpu")
    np.testing.assert_array_equal(tres.sel_rows.numpy(),
                                  np.asarray(jres.sel_rows))
    np.testing.assert_array_equal(tres.sel_mask.numpy(),
                                  np.asarray(jres.sel_mask))
    testing.assert_close(tres.value, jres.value)
    testing.assert_close(obj.evaluate(tres.sel_rows, tres.sel_mask),
                         tres.value)


def test_native_plan_runs_and_stays_near_centralized():
    """The default TorchPlan: deterministic per seed, within the paper's
    regime of the centralized score, and above a random subset."""
    data = datasets.webscope(n=4000, d=6)
    obj = objective_from_numpy(_eval_rows(data, 256), "cpu")
    cfg = TreeConfig(k=8, capacity=200, seed=3)
    a = tree_maximize(obj, data, cfg, device="cpu")
    b = tree_maximize(obj, data, cfg, device="cpu", plan=TorchPlan(3))
    np.testing.assert_array_equal(a.sel_rows, b.sel_rows)
    assert a.machines_per_round == [20, 1]
    cent = float(centralized_greedy(obj, data, 8, device="cpu").value)
    rand = float(random_subset(obj, data, 8,
                               torch.Generator().manual_seed(0)).value)
    assert a.value / cent > 0.9
    assert a.value > rand
