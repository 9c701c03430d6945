"""The port's other objectives against the JAX package on the CPU:
``ActiveSetSelection``, ``FacilityLocation``, ``WeightedCoverage`` and
``WeightedExemplarClustering`` — each oracle (with and without a machine
axis), the step-wise greedy, the fused greedy and threshold-batch where
there is one, the centralized greedy and the resident TREE on the JAX
package's replayed plan — and the weighted objective's unit-weight bit
identity with the unweighted one.

Tolerance: ``repro_torch.testing`` (rtol = atol = 1e-5) for values, gains
and state.  Picks: the exact-tie rule (``testing.picks_agree``) against the
JAX package's own gain trace, its counts printed; TREE rows, rounds,
machines per round, depth and oracle calls exactly.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import ActiveSetSelection as JActive
from repro.core import ExemplarClustering as JExemplar
from repro.core import FacilityLocation as JFacility
from repro.core import TreeConfig as JTreeConfig
from repro.core import WeightedCoverage as JCoverage
from repro.core import WeightedExemplarClustering as JWeighted
from repro.core import algorithms as jalg
from repro.core import centralized_greedy as jcentralized
from repro.core import constraints as jcons
from repro.core import tree_maximize as jtree
from repro_torch import testing
from repro_torch.convert import (constraint_from_jax, objective_from_jax,
                                 objective_from_numpy)
from repro_torch.core import (ActiveSetSelection, TreeConfig,
                              WeightedExemplarClustering, algorithms,
                              centralized_greedy, random_subset,
                              tree_maximize)
from repro_torch.core.algorithms import _where_state
from repro_torch.data import datasets

from _torch_parity import jax_gain_trace, jax_tree_plan, make_attrs

NAMES = ["active_set", "facility", "coverage", "weighted_exemplar"]
K = 8


def _case(name, n, seed=0):
    """(JAX objective, (n, d) fp32 rows) of one objective at a small size:
    the Parkinsons analog × 0.5 at the paper's h = 0.5, σ = 1 for the
    information gain; Webscope rows for facility location (h = 1.0) and the
    weighted exemplar clustering (weights U(0.5, 1.5), mean 1); binary
    incidence rows over 16 weighted elements for coverage."""
    r = np.random.default_rng(seed)
    if name == "active_set":
        return (JActive(k_max=K, h=0.5, sigma=1.0),
                (datasets.parkinsons(n=n) * 0.5).astype(np.float32))
    if name == "active_set_webscope":   # far rows keep r = 2.0 exactly
        return JActive(k_max=K), datasets.webscope(n=n, d=6)
    if name == "coverage":
        data = (r.random((n, 16)) < 0.25).astype(np.float32)
        return JCoverage(jnp.asarray(r.random(16).astype(np.float32))), data
    data = datasets.webscope(n=n, d=6)
    E = data[r.choice(n, min(n, 48), replace=False)]
    if name == "facility":
        return JFacility(jnp.asarray(E), h=1.0), data
    w = r.uniform(0.5, 1.5, len(E)).astype(np.float32)
    w = (w / w.mean()).astype(np.float32)
    return JWeighted(jnp.asarray(E), eval_weights=jnp.asarray(w)), data


def _state_close(ts, js, what):
    for key, v in js.items():
        testing.assert_close(ts[key], np.asarray(v), f"{what}: {key}")


@pytest.mark.parametrize("name", NAMES)
def test_oracle_matches_jax(name):
    jobj, data = _case(name, 120)
    tobj = objective_from_jax(jobj, "cpu")
    M, cap = 3, 40
    mask = np.random.default_rng(1).random((M, cap)) < 0.85
    T = data[:M * cap].reshape(M, cap, -1)
    Tt, mt = torch.from_numpy(T), torch.from_numpy(mask)
    ts = tobj.init_state(Tt, mt)
    picks = np.array([[7, 3, 20], [0, 39, 1], [12, 12, 5]])
    for i in range(M):                      # each machine against JAX
        js = jobj.init_state(jnp.asarray(T[i]), jnp.asarray(mask[i]))
        one = tobj.init_state(Tt[i], mt[i])
        _state_close({k_: v[i] for k_, v in ts.items()}, js, "init batched")
        _state_close(one, js, "init")
        for t, p in enumerate(picks[i]):
            g_j = jobj.gains(js, jnp.asarray(T[i]), jnp.asarray(mask[i]))
            testing.assert_close(tobj.gains(one, Tt[i], mt[i]), g_j,
                                 f"gains step {t}")
            js = jobj.update(js, jnp.asarray(T[i]), jnp.int32(p))
            one = tobj.update(one, Tt[i], torch.tensor(p))
            _state_close(one, js, f"update step {t}")
        testing.assert_close(tobj.value(one), jobj.value(js), "value")
    g = tobj.gains(ts, Tt, mt)
    for t in range(picks.shape[1]):         # every machine at once
        ts = tobj.update(ts, Tt, torch.from_numpy(picks[:, t]))
        g = tobj.gains(ts, Tt, mt)
    for i in range(M):
        js = jobj.init_state(jnp.asarray(T[i]), jnp.asarray(mask[i]))
        for p in picks[i]:
            js = jobj.update(js, jnp.asarray(T[i]), jnp.int32(p))
        _state_close({k_: v[i] for k_, v in ts.items()}, js, "batched")
        testing.assert_close(g[i], jobj.gains(js, jnp.asarray(T[i]),
                                              jnp.asarray(mask[i])),
                             "batched gains")
    smask = np.array([True] * 6 + [False] * 3)
    S = data[50:59]
    testing.assert_close(tobj.evaluate(torch.from_numpy(S),
                                       torch.from_numpy(smask)),
                         jobj.evaluate(jnp.asarray(S), jnp.asarray(smask)),
                         "evaluate")


def _greedy_pair(name, fused, M=3, cap=60, seed=2):
    """The port's greedy over M machines (the last one with four rows, so
    its later steps find no candidate) and JAX's per machine."""
    jobj, data = _case(name, M * cap, seed)
    tobj = objective_from_jax(jobj, "cpu")
    mask = np.random.default_rng(seed).random((M, cap)) < 0.85
    mask[-1] = False
    mask[-1, [5, 17, 30, 44]] = True
    T = data.reshape(M, cap, -1)
    tres = algorithms.greedy(tobj, torch.from_numpy(T),
                             torch.from_numpy(mask), K, fused=fused)
    jres = [jalg.greedy(jobj, jnp.asarray(T[i]), jnp.asarray(mask[i]), K,
                        fused=fused) for i in range(M)]
    return jobj, T, mask, tres, jres


@pytest.mark.parametrize("name,fused", [(n, False) for n in NAMES]
                         + [("active_set_webscope", False),
                            ("weighted_exemplar", True)])
def test_greedy_matches_jax(name, fused):
    jobj, T, mask, tres, jres = _greedy_pair(name, fused)
    sel_j = np.stack([np.asarray(r.sel_idx) for r in jres])
    gains = np.stack([jax_gain_trace(jobj, T[i], mask[i], sel_j[i])
                      for i in range(len(T))])
    ok, ties, excused = testing.picks_agree(tres.sel_idx, sel_j, gains)
    print(f"{name} greedy fused={fused}: exact-tie steps {ties}, excused "
          f"steps {excused}")
    assert ok
    np.testing.assert_array_equal(tres.sel_mask.numpy(), np.stack(
        [np.asarray(r.sel_mask) for r in jres]))
    np.testing.assert_array_equal(tres.oracle_calls.numpy(), [
        int(r.oracle_calls) for r in jres])
    np.testing.assert_array_equal(tres.depth.numpy(), [K] * len(T))
    testing.assert_close(tres.value, np.array([float(r.value) for r in jres]))
    if name.startswith("active_set"):
        assert ties >= len(T)      # step 0 of every machine is an exact tie


def test_active_set_masked_update_is_the_select_of_update():
    """The scan's in-place commit gives the bits of update + select."""
    jobj, T, mask, _, _ = _greedy_pair("active_set", False)
    tobj = objective_from_jax(jobj, "cpu")
    Tt = torch.from_numpy(T)
    st = tobj.init_state(Tt, torch.from_numpy(mask))
    for idx, ok in (([1, 2, 5], [True, False, True]),
                    ([9, 2, 17], [True, True, False])):
        idx, ok = torch.tensor(idx), torch.tensor(ok)
        want = _where_state(ok, tobj.update(st, Tt, idx), st)
        st = tobj.masked_update({k_: v.clone() for k_, v in st.items()}, Tt,
                                idx, ok)
        for key in want:
            assert torch.equal(st[key], want[key]), key
    assert st["step"].tolist() == [2, 1, 1]


TREE_CASES = [("active_set", "greedy"), ("active_set_webscope", "greedy"),
              ("facility", "greedy"),
              ("coverage", "greedy"), ("weighted_exemplar", "greedy"),
              ("weighted_exemplar", "threshold_batch")]


@pytest.mark.parametrize("name,alg", TREE_CASES)
def test_tree_matches_jax(name, alg):
    """n = 600, μ = 100: round 0 on 6 machines, then one."""
    n, mu = 600, 100
    jobj, data = _case(name, n, seed=3)
    jcfg = JTreeConfig(k=K, capacity=mu, seed=0, algorithm=alg, eps=0.5)
    jres = jtree(jobj, jnp.asarray(data), jcfg)
    plan = jax_tree_plan(0, mu, jres.machines_per_round)
    cfg = TreeConfig(k=K, capacity=mu, seed=0, algorithm=alg, eps=0.5)
    tobj = objective_from_jax(jobj, "cpu")
    tres = tree_maximize(tobj, data, cfg, device="cpu", plan=plan)
    np.testing.assert_array_equal(tres.sel_rows, np.asarray(jres.sel_rows))
    np.testing.assert_array_equal(tres.sel_mask, np.asarray(jres.sel_mask))
    assert tres.machines_per_round == jres.machines_per_round == [6, 1]
    assert tres.rounds == jres.rounds
    assert tres.oracle_calls == jres.oracle_calls
    assert tres.depth_per_round == jres.depth_per_round
    assert tres.solve_depth == jres.solve_depth
    testing.assert_close(tres.value, jres.value)
    testing.assert_close(tres.round_values, jres.round_values)
    testing.assert_close(tobj.evaluate(torch.from_numpy(tres.sel_rows),
                                       torch.from_numpy(tres.sel_mask)),
                         tres.value, "TREE value re-scored")


@pytest.mark.parametrize("name", NAMES)
def test_centralized_greedy_matches_jax(name):
    jobj, data = _case(name, 300, seed=4)
    jres = jcentralized(jobj, jnp.asarray(data), K)
    tobj = objective_from_jax(jobj, "cpu")
    tres = centralized_greedy(tobj, data, K, device="cpu")
    np.testing.assert_array_equal(tres.sel_rows.numpy(),
                                  np.asarray(jres.sel_rows))
    testing.assert_close(tres.value, jres.value)
    rand = random_subset(tobj, data, K, torch.Generator().manual_seed(0))
    assert float(rand.value) <= float(tres.value) + 1e-5


def test_active_set_knapsack_matches_jax():
    """The Parkinsons setting of ``examples/active_set_selection.py``:
    centralized greedy under a knapsack on costs U(0.5, 2.0)."""
    jobj, data = _case("active_set", 400, seed=5)
    costs = np.random.default_rng(0).uniform(0.5, 2.0, (400, 1)).astype(
        np.float32)
    jc = jcons.Knapsack(budget=6.0)
    jres = jcentralized(jobj, jnp.asarray(data), K, constraint=jc,
                        attrs=jnp.asarray(costs))
    tres = centralized_greedy(objective_from_jax(jobj, "cpu"), data, K,
                              constraint=constraint_from_jax(jc),
                              attrs=costs, device="cpu")
    np.testing.assert_array_equal(tres.sel_rows.numpy(),
                                  np.asarray(jres.sel_rows))
    testing.assert_close(tres.value, jres.value)
    assert float(tres.sel_attrs[tres.sel_mask].sum()) <= 6.0 + 1e-4


def test_weighted_exemplar_constrained_fused_matches_jax():
    """The weighted fused greedy under knapsack ∩ partition, against JAX's
    (its reference path) and against the port's own scan."""
    jobj, T, mask, _, _ = _greedy_pair("weighted_exemplar", True, M=1,
                                       cap=150)
    w, g = make_attrs(np.random.default_rng(6), (150,), 4)
    attrs = np.stack([w, g], axis=1)
    jc = jcons.Intersection((jcons.Knapsack(budget=3.0, col=0),
                             jcons.PartitionMatroid(caps=(2,) * 4, col=1)))
    jres = jalg.greedy(jobj, jnp.asarray(T[0]), jnp.asarray(mask[0]), K,
                       constraint=jc, attrs=jnp.asarray(attrs))
    tobj, tc = objective_from_jax(jobj, "cpu"), constraint_from_jax(jc)
    args = (tobj, torch.from_numpy(T[0]), torch.from_numpy(mask[0]), K)
    fused = algorithms.greedy(*args, constraint=tc,
                              attrs=torch.from_numpy(attrs))
    scan = algorithms.greedy(*args, constraint=tc,
                             attrs=torch.from_numpy(attrs), fused=False)
    np.testing.assert_array_equal(fused.sel_idx.numpy(),
                                  np.asarray(jres.sel_idx))
    assert torch.equal(fused.sel_idx, scan.sel_idx)
    assert int(fused.oracle_calls) == int(scan.oracle_calls) == int(
        jres.oracle_calls)
    assert fused.value.numpy().tobytes() == scan.value.numpy().tobytes()
    testing.assert_close(fused.value, jres.value)


def test_unit_weights_give_the_unweighted_bits():
    """w ≡ 1.0: every gain, value and selection of the weighted objective
    has the unweighted objective's bits — scan, fused greedy and the
    τ-ladder, over a machine axis."""
    _, T, mask, _, _ = _greedy_pair("weighted_exemplar", True)
    jobj, _ = _case("weighted_exemplar", 10)
    E = np.asarray(jobj.eval_set)
    plain = objective_from_numpy(E, "cpu")
    unit = WeightedExemplarClustering(
        plain.eval_set, eval_weights=torch.ones(E.shape[0]))
    Tt, mt = torch.from_numpy(T), torch.from_numpy(mask)
    s_p, s_u = plain.init_state(Tt, mt), unit.init_state(Tt, mt)
    assert torch.equal(s_p["base"], s_u["base"])
    assert torch.equal(plain.gains(s_p, Tt, mt), unit.gains(s_u, Tt, mt))
    for fused in (False, True):
        a = algorithms.greedy(plain, Tt, mt, K, fused=fused)
        b = algorithms.greedy(unit, Tt, mt, K, fused=fused)
        assert torch.equal(a.sel_idx, b.sel_idx)
        assert a.value.numpy().tobytes() == b.value.numpy().tobytes()
    a = algorithms.threshold_batch(plain, Tt, mt, K, eps=0.5)
    b = algorithms.threshold_batch(unit, Tt, mt, K, eps=0.5)
    assert torch.equal(a.sel_idx, b.sel_idx) and torch.equal(a.depth,
                                                             b.depth)
    assert a.value.numpy().tobytes() == b.value.numpy().tobytes()
    S, sm = Tt[0, :9], torch.ones(9, dtype=torch.bool)
    assert plain.evaluate(S, sm).numpy().tobytes() == \
        unit.evaluate(S, sm).numpy().tobytes()


def test_weighted_threshold_batch_matches_jax():
    jobj, T, mask, _, _ = _greedy_pair("weighted_exemplar", True, M=1,
                                       cap=300)
    jres = jalg.threshold_batch(jobj, jnp.asarray(T[0]), jnp.asarray(mask[0]),
                                K, eps=0.5)
    tres = algorithms.threshold_batch(objective_from_jax(jobj, "cpu"),
                                      torch.from_numpy(T[0]),
                                      torch.from_numpy(mask[0]), K, eps=0.5)
    np.testing.assert_array_equal(tres.sel_idx.numpy(),
                                  np.asarray(jres.sel_idx))
    assert int(tres.oracle_calls) == int(jres.oracle_calls)
    assert int(tres.depth) == int(jres.depth)
    testing.assert_close(tres.value, jres.value)


@pytest.mark.parametrize("name", ["active_set", "facility", "coverage"])
def test_threshold_batch_refuses_objectives_without_the_hook(name):
    jobj, data = _case(name, 40)
    tobj = objective_from_jax(jobj, "cpu")
    T, mask = torch.from_numpy(data), torch.ones(40, dtype=torch.bool)
    with pytest.raises(ValueError, match="fused_threshold_select"):
        algorithms.threshold_batch(tobj, T, mask, 4)
    with pytest.raises(ValueError, match="fused_threshold_select"):
        tree_maximize(tobj, data, TreeConfig(k=4, capacity=10,
                                             algorithm="threshold_batch"),
                      device="cpu")


def test_active_set_refuses_k_above_k_max():
    obj = ActiveSetSelection(k_max=3, device="cpu")
    data = (datasets.parkinsons(n=50) * 0.5).astype(np.float32)
    with pytest.raises(ValueError, match="k_max"):
        algorithms.greedy(obj, torch.from_numpy(data),
                          torch.ones(50, dtype=torch.bool), 4)
    with pytest.raises(ValueError, match="k_max"):
        tree_maximize(obj, data, TreeConfig(k=4, capacity=10), device="cpu")
    with pytest.raises(ValueError, match="k_max"):
        centralized_greedy(obj, data, 4, device="cpu")


def test_objective_from_jax_refuses_what_it_cannot_port():
    """``score_dtype`` is ported (ROADMAP queue 1 item 10) and carried
    across; a score dtype the JAX package has no path for is refused."""
    E = jnp.zeros((4, 3))
    assert objective_from_jax(JExemplar(E, score_dtype="bfloat16"),
                              "cpu").score_dtype == "bfloat16"
    with pytest.raises(ValueError, match="score_dtype"):
        objective_from_jax(JExemplar(E, score_dtype="float16"), "cpu")
    with pytest.raises(ValueError, match="no port of objective"):
        objective_from_jax(object(), "cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        if torch.cuda.is_available():
            raise RuntimeError("CUDA present: the default device is valid")
        ActiveSetSelection(k_max=3)
