"""The port's remaining selection algorithms against the JAX package on the
CPU: stochastic greedy on replayed draws, the threshold-greedy sweep,
RandGreedI on a replayed partition, TREE with either algorithm (resident,
streaming, constrained, narrow), the native draws of ``TorchPlan`` and the
NumPy reference oracles.

The threshold sweep's first level is the best gain itself, so a take there
turns on the last bit of one gain: the JAX package scores a row alone, the
port scores the block.  On inputs whose gains are exact in fp32 (small
integers, power-of-two counts) the two packages compute the same gains,
and the sweep is held exactly; on Gaussian inputs it is held under the
near-threshold rule (``testing.sweep_agree``), each excused parting
counted.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import ActiveSetSelection as JActive
from repro.core import ExemplarClustering as JExemplar
from repro.core import TreeConfig as JTreeConfig
from repro.core import algorithms as jalg
from repro.core import baselines as jbase
from repro.core import reference as jref
from repro.core import tree_maximize as jtree
from repro.core.constraints import Intersection as JIntersection
from repro.core.constraints import Knapsack as JKnapsack
from repro.core.constraints import PartitionMatroid as JPartition
from repro.core.sources import ChunkedSource as JChunkedSource
from repro.core.sources import QuantizedSource as JQuantizedSource
from repro.data import selection as jselection
from repro_torch import testing
from repro_torch.convert import (ArrayPlan, constraint_from_jax,
                                 objective_from_jax, objective_from_numpy)
from repro_torch.core import (ChunkedSource, QuantizedSource, TorchPlan,
                              TreeConfig, algorithms, randgreedi, reference,
                              tree_maximize)
from repro_torch.core.plan import _fmix32, _mul32, round_draws
from repro_torch.data.selection import SelectionConfig, select_coreset

from _torch_parity import (assert_same_tree, jax_stochastic_scores,
                           jax_tree_plan, make_attrs, make_inputs)

M, N, M_EVAL, D, K = 3, 160, 32, 5, 8


def _exact_inputs(seed, M=M, n=N, m=M_EVAL, d=D):
    """Small-integer rows and eval rows (every gain exact in fp32: squared
    distances are integers and the mean divides by a power of two)."""
    r = np.random.default_rng(seed)
    X = r.integers(-4, 5, (M, n, d)).astype(np.float32)
    E = r.integers(-4, 5, (m, d)).astype(np.float32)
    return X, E, r.random((M, n)) < 0.85


def _intersection(G=3):
    return JIntersection((JKnapsack(budget=2.5, col=0),
                          JPartition(caps=(2,) * G, col=1)))


def _exact_attrs(seed, shape, G=3):
    """Knapsack weights in eighths (exact sums) and group ids."""
    r = np.random.default_rng(seed)
    w = (r.integers(1, 9, shape) / 8).astype(np.float32)
    g = r.integers(0, G, shape).astype(np.float32)
    return np.stack([w, g], -1)


def _taus(d_max, eps, k):
    """The τ-levels of threshold_greedy, as it computes them."""
    n_levels = max(1, math.ceil(math.log(2.0 * k / eps) / eps))
    ratio = torch.tensor(1.0 - eps, dtype=torch.float32)
    return torch.stack([d_max * torch.pow(ratio, torch.tensor(float(lv)))
                        for lv in range(n_levels)], dim=-1)


# -- stochastic greedy --------------------------------------------------


@pytest.mark.parametrize("eps", [0.5, 0.2])
def test_stochastic_greedy_matches_jax_on_replayed_draws(eps):
    X, E, mask = make_inputs(M, N, M_EVAL, D, seed=4)
    jobj = JExemplar(jnp.asarray(E))
    obj = objective_from_numpy(E, "cpu")
    kalg = jax.random.PRNGKey(5)
    U = jax_stochastic_scores(kalg, M, K, N)
    keys = jax.random.split(kalg, M)
    draws = lambda j: torch.from_numpy(U[:, j])                  # noqa: E731
    res = algorithms.run_algorithm("stochastic_greedy", obj,
                                   torch.from_numpy(X), torch.from_numpy(mask),
                                   K, key=draws, eps=eps)
    jsel = []
    for i in range(M):
        jr = jalg.stochastic_greedy(jobj, jnp.asarray(X[i]),
                                    jnp.asarray(mask[i]), K, keys[i], eps=eps)
        jsel.append(np.asarray(jr.sel_idx))
        assert int(res.oracle_calls[i]) == int(jr.oracle_calls)
        assert int(res.depth[i]) == int(jr.depth) == K
        testing.assert_close(float(res.value[i]), float(jr.value))
    trace = testing.sample_gain_trace(obj, torch.from_numpy(X),
                                      torch.from_numpy(mask),
                                      torch.from_numpy(np.stack(jsel)), draws,
                                      eps)
    ok, ties, excused = testing.picks_agree(res.sel_idx, np.stack(jsel),
                                            trace)
    assert ok and excused == 0, (ties, excused)
    s = algorithms.sample_size(N, K, eps)
    assert s == min(N, max(1, math.ceil(N / K * math.log(1 / eps))))


def test_stochastic_greedy_full_block_objective_matches_jax():
    """ActiveSetSelection is not row-wise: the port scores the whole block
    and reads the sample, as the JAX package does."""
    X, _, mask = make_inputs(2, 60, 4, 3, seed=6)
    jobj = JActive(k_max=K)
    obj = objective_from_jax(jobj, "cpu")
    kalg = jax.random.PRNGKey(8)
    U = jax_stochastic_scores(kalg, 2, K, 60)
    keys = jax.random.split(kalg, 2)
    draws = lambda j: torch.from_numpy(U[:, j])                  # noqa: E731
    res = algorithms.stochastic_greedy(obj, torch.from_numpy(X),
                                       torch.from_numpy(mask), K, draws)
    jsel = [np.asarray(jalg.stochastic_greedy(
        jobj, jnp.asarray(X[i]), jnp.asarray(mask[i]), K, keys[i]).sel_idx)
        for i in range(2)]
    trace = testing.sample_gain_trace(obj, torch.from_numpy(X),
                                      torch.from_numpy(mask),
                                      torch.from_numpy(np.stack(jsel)), draws,
                                      0.5)
    ok, _, _ = testing.picks_agree(res.sel_idx, np.stack(jsel), trace)
    assert ok


def test_stochastic_greedy_constrained_matches_jax():
    X, E, mask = _exact_inputs(9)
    attrs = _exact_attrs(10, (M, N))
    jobj, jc = JExemplar(jnp.asarray(E)), _intersection()
    kalg = jax.random.PRNGKey(11)
    U = jax_stochastic_scores(kalg, M, K, N)
    keys = jax.random.split(kalg, M)
    res = algorithms.stochastic_greedy(
        objective_from_numpy(E, "cpu"), torch.from_numpy(X),
        torch.from_numpy(mask), K, lambda j: torch.from_numpy(U[:, j]),
        constraint=constraint_from_jax(jc), attrs=torch.from_numpy(attrs))
    for i in range(M):
        jr = jalg.stochastic_greedy(jobj, jnp.asarray(X[i]),
                                    jnp.asarray(mask[i]), K, keys[i],
                                    constraint=jc,
                                    attrs=jnp.asarray(attrs[i]))
        np.testing.assert_array_equal(res.sel_idx[i].numpy(),
                                      np.asarray(jr.sel_idx))
        assert int(res.oracle_calls[i]) == int(jr.oracle_calls)
        assert float(res.value[i]) == float(jr.value)


# -- threshold greedy ---------------------------------------------------


@pytest.mark.parametrize("constrained", [False, True],
                         ids=["unconstrained", "knapsack-and-partition"])
@pytest.mark.parametrize("eps", [0.1, 0.5])
def test_threshold_greedy_sweep_matches_jax(eps, constrained):
    X, E, mask = _exact_inputs(12)
    attrs = _exact_attrs(13, (M, N)) if constrained else None
    jc = _intersection() if constrained else None
    jobj, obj = JExemplar(jnp.asarray(E)), objective_from_numpy(E, "cpu")
    res = algorithms.run_algorithm(
        "threshold_greedy", obj, torch.from_numpy(X), torch.from_numpy(mask),
        K, eps=eps, constraint=constraint_from_jax(jc),
        attrs=None if attrs is None else torch.from_numpy(attrs))
    n_levels = max(1, math.ceil(math.log(2.0 * K / eps) / eps))
    gaps = []
    for i in range(M):
        jr = jalg.threshold_greedy(
            jobj, jnp.asarray(X[i]), jnp.asarray(mask[i]), K, eps=eps,
            constraint=jc, attrs=None if attrs is None
            else jnp.asarray(attrs[i]))
        np.testing.assert_array_equal(res.sel_idx[i].numpy(),
                                      np.asarray(jr.sel_idx))
        np.testing.assert_array_equal(res.sel_mask[i].numpy(),
                                      np.asarray(jr.sel_mask))
        assert int(res.oracle_calls[i]) == int(jr.oracle_calls)
        assert int(res.depth[i]) == int(jr.depth) == 1 + n_levels
        assert float(res.value[i]) == float(jr.value)
        # the gap to the nearest τ-level of each take's gain (reported)
        T, mk = torch.from_numpy(X[i]), torch.from_numpy(mask[i])
        trace = testing.gain_trace(obj, T, mk, res.sel_idx[i])
        taus = _taus(torch.amax(trace[0]), eps, K)
        for t, row in enumerate(res.sel_idx[i].tolist()):
            if row >= 0:
                gaps.append(float(torch.min(torch.abs(trace[t, row]
                                                      - taus))))
    print(f"threshold_greedy eps={eps}: {len(gaps)} takes, least gap of a "
          f"take's gain to a level {min(gaps)!r}")


def test_threshold_greedy_gaussian_under_near_threshold_rule():
    X, E, mask = make_inputs(4, N, M_EVAL, D, seed=14)
    jobj, obj = JExemplar(jnp.asarray(E)), objective_from_numpy(E, "cpu")
    Xt, mt = torch.from_numpy(X), torch.from_numpy(mask)
    res = algorithms.threshold_greedy(obj, Xt, mt, K, eps=0.5)
    jsel = np.stack([np.asarray(jalg.threshold_greedy(
        jobj, jnp.asarray(X[i]), jnp.asarray(mask[i]), K, eps=0.5).sel_idx)
        for i in range(4)])
    trace = testing.gain_trace(obj, Xt, mt,
                               torch.from_numpy(jsel.astype(np.int64)))
    taus = _taus(torch.amax(trace[..., 0, :], dim=-1), 0.5, K)
    ok, excused = testing.sweep_agree(res.sel_idx, jsel, trace, taus)
    print(f"threshold_greedy on Gaussian rows: {excused} of 4 machines part "
          f"at a near-threshold row")
    assert ok


def test_run_algorithm_defaults_and_draws_required():
    X, E, mask = _exact_inputs(15, M=1)
    obj = objective_from_numpy(E, "cpu")
    args = (obj, torch.from_numpy(X[0]), torch.from_numpy(mask[0]), K)
    res = algorithms.run_algorithm("threshold_greedy", *args)
    assert int(res.depth) == 1 + math.ceil(math.log(2 * K / 0.1) / 0.1)
    with pytest.raises(ValueError, match="needs its draws"):
        algorithms.run_algorithm("stochastic_greedy", *args)
    draws = round_draws(TorchPlan(1), 0, 0, 1, N, "cpu")
    a = algorithms.run_algorithm("stochastic_greedy", *args, key=draws)
    b = algorithms.stochastic_greedy(
        obj, torch.from_numpy(X[0]), torch.from_numpy(mask[0]), K,
        lambda j: draws(j)[0], eps=0.5)
    assert torch.equal(a.sel_idx, b.sel_idx)
    assert int(a.depth) == K and int(a.sel_mask.sum()) == K


# -- the native draws ---------------------------------------------------


def _hash_scores(seed, t, machines, j, cap):
    """TorchPlan's draw in plain Python integers (no tensor op)."""
    m32 = 0xFFFFFFFF

    def mul(x, c):
        return (x * c) & m32

    def fmix(x):
        x ^= x >> 16
        x = mul(x, 0x85EBCA6B)
        x ^= x >> 13
        x = mul(x, 0xC2B2AE35)
        return x ^ (x >> 16)

    key = fmix(fmix(fmix((seed & m32) ^ 0x5BD1E995) ^ (seed >> 32)) ^ t)
    key = fmix(key ^ mul(j + 1, 0x9E3779B1))
    out = np.zeros((len(machines), cap), np.float32)
    for a, mch in enumerate(machines):
        h = fmix(key ^ mul(mch, 0x27D4EB2F))
        for s in range(cap):
            out[a, s] = (fmix(h ^ mul(s, 0x165667B1)) >> 9) * 2.0 ** -23
    return out


@pytest.mark.parametrize("seed", [0, 7, 2 ** 40 + 3])
def test_torch_plan_draws_are_exact_integers_and_width_free(seed):
    """The draw is an integer function of (seed, t, machine, j, slot): the
    tensor evaluation equals the plain-integer one (so no device can give
    other bits), and a wave's rows equal the same machines' rows of the
    whole round (so no wave width can change a stochastic result)."""
    plan = TorchPlan(seed)
    whole = plan.stochastic_scores(2, 0, 12, 3, 50, "cpu")
    np.testing.assert_array_equal(whole.numpy(),
                                  _hash_scores(seed, 2, range(12), 3, 50))
    for w0, w1 in ((0, 1), (3, 7), (7, 12)):
        assert torch.equal(plan.stochastic_scores(2, w0, w1, 3, 50, "cpu"),
                           whole[w0:w1])
    u = whole.numpy()
    assert u.dtype == np.float32 and 0.0 <= u.min() and u.max() < 1.0
    assert np.all(u * 2 ** 23 == np.floor(u * 2 ** 23))
    assert not torch.equal(whole, plan.stochastic_scores(2, 0, 12, 4, 50,
                                                         "cpu"))
    for x in (0, 1, 0xFFFFFFFF, 123456789):
        assert _mul32(x, 0xC2B2AE35) == (x * 0xC2B2AE35) % 2 ** 32
        assert int(_fmix32(torch.tensor(x))) == _fmix32(x)


def test_array_plan_replays_and_checks_shapes():
    U = np.random.default_rng(0).random((4, K, 20)).astype(np.float32)
    plan = ArrayPlan([np.arange(80)], stochastic=[U])
    assert torch.equal(plan.stochastic_scores(0, 1, 3, 2, 20, "cpu"),
                       torch.from_numpy(U[1:3, 2]))
    with pytest.raises(ValueError):
        plan.stochastic_scores(0, 0, 4, 0, 21, "cpu")
    with pytest.raises(IndexError):
        plan.stochastic_scores(1, 0, 4, 0, 20, "cpu")


# -- TREE with the new algorithms ---------------------------------------


def _tree_pair(alg, data, E, k, mu, seed, constraint=None, attrs=None,
               engine="sync", **port_kw):
    jcfg = JTreeConfig(k=k, capacity=mu, seed=seed, algorithm=alg)
    jres = jtree(JExemplar(jnp.asarray(E)), jnp.asarray(data), jcfg,
                 constraint=constraint, attrs=attrs)
    plan = jax_tree_plan(seed, mu, jres.machines_per_round, k=k)
    cfg = TreeConfig(k=k, capacity=mu, seed=seed, algorithm=alg,
                     engine=engine)
    tres = tree_maximize(objective_from_numpy(E, "cpu"),
                         port_kw.pop("source", data), cfg, device="cpu",
                         plan=plan, constraint=constraint_from_jax(constraint),
                         attrs=attrs, **port_kw)
    return jres, tres


@pytest.mark.parametrize("alg", ["stochastic_greedy", "threshold_greedy"])
@pytest.mark.parametrize("path", ["resident", "waves", "schedule"])
def test_tree_matches_jax(alg, path):
    X, E, _ = _exact_inputs(16, M=1, n=700, d=4)
    data = X[0]
    kw = {"resident": {}, "waves": {"wave_machines": 3},
          "schedule": {"source": ChunkedSource.from_array(data, 97),
                       "wave_schedule": [1, 4, 2, 8]}}[path]
    jres, tres = _tree_pair(alg, data, E, 6, 50, 3, **kw)
    assert_same_tree(tres, jres)


@pytest.mark.parametrize("alg", ["stochastic_greedy", "threshold_greedy"])
def test_tree_constrained_matches_jax(alg):
    X, E, _ = _exact_inputs(17, M=1, n=600, d=4)
    attrs = _exact_attrs(18, (600,))
    jres, tres = _tree_pair(alg, X[0], E, 6, 50, 4,
                            constraint=_intersection(), attrs=attrs,
                            engine="pipelined")
    assert_same_tree(tres, jres)
    np.testing.assert_array_equal(tres.sel_attrs, np.asarray(jres.sel_attrs))


@pytest.mark.parametrize("alg", ["stochastic_greedy", "threshold_greedy"])
@pytest.mark.parametrize("store", ["bf16", "int8"])
def test_tree_narrow_waves_match_jax_resident(alg, store):
    """A narrow source streams its storage dtype: the result is the JAX
    resident TREE's on the dequantized rows, for one plan."""
    X, E, _ = _exact_inputs(19, M=1, n=600, d=4)
    attrs = _exact_attrs(20, (600,))
    jq = JQuantizedSource(JChunkedSource.from_array(X[0], 128, attrs=attrs),
                          store_dtype=store, q_block_rows=64)
    rows = np.asarray(jq.dequantized(), np.float32)
    jres, _ = _tree_pair(alg, rows, E, 6, 50, 5, constraint=_intersection(),
                         attrs=attrs)
    q = QuantizedSource(ChunkedSource.from_array(X[0], 128, attrs=attrs),
                        store, 64)
    plan = jax_tree_plan(5, 50, jres.machines_per_round, k=6)
    tres = tree_maximize(
        objective_from_numpy(E, "cpu"), q,
        TreeConfig(k=6, capacity=50, seed=5, algorithm=alg), device="cpu",
        plan=plan, constraint=constraint_from_jax(_intersection()),
        wave_machines=4)
    assert_same_tree(tres, jres)


def test_select_coreset_stochastic_matches_jax():
    X, _, _ = _exact_inputs(21, M=1, n=800, d=4)
    data = X[0]
    scfg = jselection.SelectionConfig(k=6, capacity=60, n_eval=32, seed=2,
                                      algorithm="stochastic_greedy")
    jidx, jres = jselection.select_coreset(jnp.asarray(data), scfg)
    ev = np.asarray(jax.random.choice(jax.random.PRNGKey(2), 800, (32,),
                                      replace=False))
    plan = jax_tree_plan(2, 60, jres.machines_per_round, k=6)
    plan = ArrayPlan(plan.perms, eval_idx=ev, stochastic=plan.stochastic)
    idx, res = select_coreset(data, SelectionConfig(
        k=6, capacity=60, n_eval=32, seed=2, algorithm="stochastic_greedy"),
        device="cpu", plan=plan)
    np.testing.assert_array_equal(idx, np.asarray(jidx))
    np.testing.assert_array_equal(res.sel_rows, np.asarray(jres.sel_rows))
    assert res.oracle_calls == int(jres.oracle_calls)


# -- RandGreedI ---------------------------------------------------------


@pytest.mark.parametrize("constrained", [False, True],
                         ids=["unconstrained", "knapsack-and-partition"])
def test_randgreedi_matches_jax_and_source_equals_array(constrained):
    X, E, _ = make_inputs(1, 901, M_EVAL, D, seed=22)
    data = X[0]
    r = np.random.default_rng(23)
    attrs = (np.stack(make_attrs(r, (901,), 3), 1) if constrained else None)
    jc = (JIntersection((JKnapsack(budget=3.0, col=0),
                         JPartition(caps=(3, 3, 3), col=1)))
          if constrained else None)
    m, k = 7, 8
    key = jax.random.PRNGKey(24)
    jr = jbase.randgreedi(JExemplar(jnp.asarray(E)), jnp.asarray(data), k,
                          m, key, constraint=jc, attrs=attrs)
    plan = ArrayPlan([np.asarray(jax.random.permutation(
        key, m * math.ceil(901 / m)))])
    obj, c = objective_from_numpy(E, "cpu"), constraint_from_jax(jc)
    res = randgreedi(obj, data, k, m, plan, constraint=c, attrs=attrs,
                     device="cpu")
    np.testing.assert_array_equal(res.sel_rows.numpy(),
                                  np.asarray(jr.sel_rows))
    np.testing.assert_array_equal(res.sel_mask.numpy(),
                                  np.asarray(jr.sel_mask))
    testing.assert_close(float(res.value), float(jr.value))
    src = ChunkedSource.from_array(data, 128)
    for chunk in (None, 3):
        sres = randgreedi(obj, src, k, m, plan, constraint=c, attrs=attrs,
                          machine_chunk=chunk, device="cpu")
        assert torch.equal(sres.sel_rows, res.sel_rows)
        assert torch.equal(sres.sel_mask, res.sel_mask)
        assert float(sres.value) == float(res.value)
    if constrained:
        np.testing.assert_array_equal(res.sel_attrs.numpy(),
                                      np.asarray(jr.sel_attrs))


@pytest.mark.parametrize("constrained", [False, True],
                         ids=["unconstrained", "knapsack-and-partition"])
@pytest.mark.parametrize("store", ["bf16", "int8"])
def test_randgreedi_narrow_source_equals_array_on_dequantized(store,
                                                              constrained):
    """A narrow source ships its storage dtype and dequant parameters to
    the machine solves: the result is the array path's on the rows the
    solve sees, whatever the chunk."""
    X, E, _ = make_inputs(1, 901, M_EVAL, D, seed=27)
    r = np.random.default_rng(28)
    attrs = (np.stack(make_attrs(r, (901,), 3), 1) if constrained else None)
    c = (constraint_from_jax(JIntersection((
        JKnapsack(budget=3.0, col=0), JPartition(caps=(3, 3, 3), col=1))))
        if constrained else None)
    q = QuantizedSource(ChunkedSource.from_array(X[0], 128, attrs=attrs),
                        store, 64)
    obj, m, k = objective_from_numpy(E, "cpu"), 7, 8
    ref = randgreedi(obj, q.dequantized(), k, m, TorchPlan(29),
                     constraint=c, attrs=attrs, device="cpu")
    # the raw codes are not the rows: a solve on them would part
    assert store == "bf16" or not np.array_equal(
        q.gather(np.arange(901)).astype(np.float32), q.dequantized())
    for chunk in (None, 3):
        got = randgreedi(obj, q, k, m, TorchPlan(29), constraint=c,
                         machine_chunk=chunk, device="cpu")
        assert torch.equal(got.sel_rows, ref.sel_rows)
        assert torch.equal(got.sel_mask, ref.sel_mask)
        assert float(got.value) == float(ref.value)
        if constrained:
            assert torch.equal(got.sel_attrs, ref.sel_attrs)


def test_randgreedi_native_plan_runs_near_centralized():
    X, E, _ = make_inputs(1, 1200, M_EVAL, D, seed=25)
    obj = objective_from_numpy(E, "cpu")
    a = randgreedi(obj, X[0], 8, 6, TorchPlan(3), device="cpu")
    b = randgreedi(obj, X[0], 8, 6, TorchPlan(3), device="cpu")
    assert torch.equal(a.sel_rows, b.sel_rows)
    cent = algorithms.greedy(obj, torch.from_numpy(X[0]),
                             torch.ones(1200, dtype=torch.bool), 8)
    assert float(a.value) >= 0.9 * float(cent.value)


# -- the NumPy reference ------------------------------------------------


def test_reference_lazy_greedy_agrees_with_port_greedy():
    X, E, _ = make_inputs(1, 300, M_EVAL, D, seed=26)
    data = X[0]
    idx = np.arange(300)
    lazy = reference.lazy_greedy(reference.ExemplarOracle(data, E), idx, K)
    plain = reference.plain_greedy(reference.ExemplarOracle(data, E), idx, K)
    jlazy = jref.lazy_greedy(jref.ExemplarOracle(data, E), idx, K)
    np.testing.assert_array_equal(lazy.sel_idx, jlazy.sel_idx)
    assert lazy.oracle_calls == jlazy.oracle_calls and lazy.value == jlazy.value
    np.testing.assert_array_equal(lazy.sel_idx, plain.sel_idx)
    assert lazy.oracle_calls < plain.oracle_calls
    obj = objective_from_numpy(E, "cpu")
    T, mk = torch.from_numpy(data), torch.ones(300, dtype=torch.bool)
    res = algorithms.greedy(obj, T, mk, K, fused=False)
    trace = testing.gain_trace(obj, T, mk, torch.from_numpy(lazy.sel_idx))
    ok, _, _ = testing.picks_agree(res.sel_idx, lazy.sel_idx, trace)
    assert ok
    testing.assert_close(float(res.value), lazy.value)


def test_reference_logdet_oracle_agrees_with_active_set():
    X, _, _ = make_inputs(1, 80, 4, 3, seed=27)
    data = X[0]
    idx = np.arange(80)
    lazy = reference.lazy_greedy(reference.LogDetOracle(data, h=0.5), idx, 6)
    jlazy = jref.lazy_greedy(jref.LogDetOracle(data, h=0.5), idx, 6)
    np.testing.assert_array_equal(lazy.sel_idx, jlazy.sel_idx)
    obj = objective_from_jax(JActive(k_max=6), "cpu")
    T, mk = torch.from_numpy(data), torch.ones(80, dtype=torch.bool)
    res = algorithms.greedy(obj, T, mk, 6)
    trace = testing.gain_trace(obj, T, mk, torch.from_numpy(lazy.sel_idx))
    ok, _, _ = testing.picks_agree(res.sel_idx, lazy.sel_idx, trace)
    assert ok
    testing.assert_close(float(res.value), lazy.value)
