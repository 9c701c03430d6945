"""The port's constraints against the JAX package on the CPU: the NumPy
checker, spec parsing and attribute widths, the batched feasibility test
and update, the constrained plain greedy, the constrained scan against the
fused path, centralized greedy under constraints, and the constrained
``greedy_select`` kernel against its plain version on a card."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import ExemplarClustering as JExemplar
from repro.core import algorithms as jalg
from repro.core import centralized_greedy as jcentralized
from repro.core import constraints as jcons
from repro.kernels import ref as jref
from repro_torch import testing
from repro_torch.convert import constraint_from_jax, objective_from_numpy
from repro_torch.core import algorithms, centralized_greedy
from repro_torch.core import constraints as cons
from repro_torch.kernels import ops, ref

from _torch_parity import cuda, make_attrs, make_inputs  # noqa: F401

SPECS = ["knapsack:budget=2.5", "knapsack:budget=1.5:col=1",
         "partition:caps=1,2,1,3:col=1", "partition:caps=2,2",
         "intersection:knapsack:budget=3.0+partition:caps=1,2,1,3:col=1",
         "none"]
CAPS = (2, 1, 3, 2)


def _attrs(n, seed, n_groups=4):
    w, g = make_attrs(np.random.default_rng(seed), (n,), n_groups)
    return np.stack([w, g], axis=1)


@pytest.mark.parametrize("spec", SPECS)
def test_spec_checker_and_attr_dim_match_jax(spec):
    jc, tc = jcons.from_spec(spec), cons.constraint_from_spec(spec)
    assert tc == constraint_from_jax(jc)
    assert cons.attr_dim(tc) == jcons.attr_dim(jc)
    r = np.random.default_rng(len(spec))
    for trial in range(20):
        attrs = _attrs(6, trial, n_groups=5)     # group 4 is out of range
        mask = r.random(6) < 0.7
        assert cons.check_feasible(tc, attrs, mask) == \
            jcons.check_feasible(jc, attrs, mask)
    bad = cons.check_feasible(tc, np.zeros((3, 2)), np.ones(4, bool))
    assert bad == jcons.check_feasible(jc, np.zeros((3, 2)), np.ones(4, bool))


def test_from_spec_rejects_unknown_and_dynamic_classes():
    """Unknown specs raise; the JAX ``Dynamic*`` classes (not spec-parsed:
    the serve layer builds them) map to the port's, parameters on the
    device asked for."""
    with pytest.raises(ValueError, match="unknown constraint spec"):
        cons.from_spec("matroid:rank=3")
    kn = constraint_from_jax(jcons.DynamicKnapsack(jnp.float32(1.5), col=1),
                             "cpu")
    assert isinstance(kn, cons.DynamicKnapsack) and kn.col == 1
    assert kn.budget.dtype == torch.float32 and float(kn.budget) == 1.5
    pm = constraint_from_jax(jcons.DynamicPartitionMatroid(
        jnp.asarray([2, 1, 3], jnp.int32), col=0), "cpu")
    assert isinstance(pm, cons.DynamicPartitionMatroid)
    assert pm.caps.dtype == torch.int32 and pm.caps.tolist() == [2, 1, 3]
    with pytest.raises(ValueError, match="no port of constraint class"):
        constraint_from_jax(type("Matroid", (), {})())


@pytest.mark.parametrize("spec", SPECS[:5])
def test_batched_feasible_and_update_match_jax(spec):
    """The port's constraint state carries the machine axis that JAX's
    vmap adds; each machine's feasibility and update match JAX's."""
    jc, tc = jcons.from_spec(spec), cons.from_spec(spec)
    M, n = 3, 12
    attrs = np.stack([_attrs(n, i) for i in range(M)])
    idx = np.array([[0, 5, 7], [2, 2, 9], [11, 1, 3]])
    ts = tc.init_state((M,), "cpu")
    js = [jc.init_state() for _ in range(M)]
    at = torch.from_numpy(attrs)
    for t in range(3):
        feas = tc.feasible(ts, at).numpy()
        for i in range(M):
            np.testing.assert_array_equal(
                feas[i], np.asarray(jc.feasible(js[i], jnp.asarray(attrs[i]))))
        ts = tc.update(ts, at, torch.from_numpy(idx[:, t]))
        js = [jc.update(js[i], jnp.asarray(attrs[i]), int(idx[i, t]))
              for i in range(M)]


def _kwargs(kind, w, g, k):
    kw = {}
    if kind in ("knapsack", "both"):
        kw.update(weights=w, budget=0.35 * k)
    if kind in ("partition", "both"):
        kw.update(group_ids=g, caps=CAPS)
    return kw


@pytest.mark.parametrize("kind", ["knapsack", "partition", "both"])
@pytest.mark.parametrize("M,n,m,d,k", [(3, 61, 29, 17, 7), (2, 45, 70, 3, 20)])
def test_greedy_select_constrained_matches_jax(kind, M, n, m, d, k):
    """Indices exact and cur_min within the tolerance; the budgets bind
    (k = 20 runs out of feasible rows: the −1 tail)."""
    X, E, mask = make_inputs(M, n, m, d, seed=n + k + len(kind))
    w = np.stack([_attrs(n, i)[:, 0] for i in range(M)])
    g = np.stack([_attrs(n, i)[:, 1] for i in range(M)])
    kw = _kwargs(kind, w, g, k)
    cm0 = np.sum(E * E, axis=-1)
    sel, cm = ops.greedy_select(
        torch.from_numpy(X), torch.from_numpy(E), torch.from_numpy(cm0),
        torch.from_numpy(mask), k,
        **{key: (torch.from_numpy(v) if isinstance(v, np.ndarray) else v)
           for key, v in kw.items()})
    for i in range(M):
        jkw = {key: (jnp.asarray(v[i]) if isinstance(v, np.ndarray) else v)
               for key, v in kw.items()}
        jsel, jcm = jref.greedy_select(jnp.asarray(X[i]), jnp.asarray(E),
                                       jnp.asarray(cm0), jnp.asarray(mask[i]),
                                       k, **jkw)
        np.testing.assert_array_equal(sel[i].numpy(), np.asarray(jsel))
        testing.assert_close(cm[i], jcm, f"machine {i}")
    if k == 20:
        assert bool(torch.any(sel < 0))


@pytest.mark.parametrize("spec", SPECS[:5])
def test_constrained_scan_equals_fused(spec):
    """Port scan == port fused (indices, value bits, calls) on a batch of
    machines, and both == the JAX scan per machine."""
    M, n, m, d, k = 3, 40, 15, 5, 8
    X, E, mask = make_inputs(M, n, m, d, seed=len(spec))
    attrs = np.stack([_attrs(n, 10 + i) for i in range(M)])
    jc = jcons.from_spec(spec)
    tc = constraint_from_jax(jc)
    obj = objective_from_numpy(E, "cpu")
    Xt, mt, at = map(torch.from_numpy, (X, mask, attrs))
    scan = algorithms.greedy(obj, Xt, mt, k, constraint=tc, attrs=at,
                             fused=False)
    fused = algorithms.greedy(obj, Xt, mt, k, constraint=tc, attrs=at)
    assert algorithms._fusable(obj, tc, at)
    assert torch.equal(scan.sel_idx, fused.sel_idx)
    assert torch.equal(scan.sel_mask, fused.sel_mask)
    assert scan.value.numpy().tobytes() == fused.value.numpy().tobytes()
    assert torch.equal(scan.oracle_calls, fused.oracle_calls)
    jobj = JExemplar(jnp.asarray(E))
    for i in range(M):
        jres = jalg.greedy(jobj, jnp.asarray(X[i]), jnp.asarray(mask[i]), k,
                           constraint=jc, attrs=jnp.asarray(attrs[i]),
                           fused=False)
        np.testing.assert_array_equal(scan.sel_idx[i].numpy(),
                                      np.asarray(jres.sel_idx))
        assert int(scan.oracle_calls[i]) == int(jres.oracle_calls)
        testing.assert_close(scan.value[i], jres.value)
        ok, detail = cons.check_feasible(
            tc, attrs[i][np.maximum(scan.sel_idx[i].numpy(), 0)],
            scan.sel_mask[i].numpy())
        assert ok, detail


def test_unfusable_constraint_takes_the_scan():
    """Two knapsacks have no fused encoding: the scan runs, as in JAX."""
    X, E, mask = make_inputs(1, 30, 9, 4, seed=2)
    attrs = _attrs(30, 4)
    jc = jcons.Intersection((jcons.Knapsack(2.0, col=0),
                             jcons.Knapsack(3.0, col=1)))
    tc = constraint_from_jax(jc)
    obj = objective_from_numpy(E, "cpu")
    assert not algorithms._fusable(obj, tc, torch.from_numpy(attrs))
    tres = algorithms.greedy(obj, torch.from_numpy(X[0]),
                             torch.from_numpy(mask[0]), 6, constraint=tc,
                             attrs=torch.from_numpy(attrs))
    jres = jalg.greedy(JExemplar(jnp.asarray(E)), jnp.asarray(X[0]),
                       jnp.asarray(mask[0]), 6, constraint=jc,
                       attrs=jnp.asarray(attrs))
    np.testing.assert_array_equal(tres.sel_idx.numpy(),
                                  np.asarray(jres.sel_idx))
    assert int(tres.oracle_calls) == int(jres.oracle_calls)


@pytest.mark.parametrize("spec", SPECS[:5])
def test_centralized_greedy_constrained_matches_jax(spec):
    data, E, _ = make_inputs(1, 400, 32, 6, seed=3)
    data = data[0]
    attrs = _attrs(400, 8)
    jc = jcons.from_spec(spec)
    jres = jcentralized(JExemplar(jnp.asarray(E)), jnp.asarray(data), 10,
                        constraint=jc, attrs=attrs)
    tres = centralized_greedy(objective_from_numpy(E, "cpu"), data, 10,
                              constraint=constraint_from_jax(jc), attrs=attrs,
                              device="cpu")
    np.testing.assert_array_equal(tres.sel_rows.numpy(),
                                  np.asarray(jres.sel_rows))
    np.testing.assert_array_equal(tres.sel_attrs.numpy(),
                                  np.asarray(jres.sel_attrs))
    testing.assert_close(tres.value, jres.value)


def test_out_of_range_group_ids_are_never_selected():
    """The port's choice for ids outside [0, G): no open group."""
    X, E, mask = make_inputs(1, 20, 6, 3, seed=1)
    mask[:] = True
    g = np.full((20,), 7.0, np.float32)
    g[[3, 11]] = [0.0, 1.0]
    g[5] = -1.0
    sel, _ = ops.greedy_select(torch.from_numpy(X[0]), torch.from_numpy(E),
                               torch.ones(6), torch.from_numpy(mask[0]), 5,
                               group_ids=torch.from_numpy(g), caps=(1, 1))
    assert sorted(sel[sel >= 0].tolist()) == [3, 11]
    acc, _ = ops.threshold_select(torch.from_numpy(X[0]), torch.from_numpy(E),
                                  torch.ones(6), torch.from_numpy(mask[0]),
                                  0.0, 5, group_ids=torch.from_numpy(g),
                                  caps=(1, 1))
    assert sorted(torch.nonzero(acc).flatten().tolist()) == [3, 11]


def test_knapsack_limit_is_one_fp32_constant():
    for budget in (2.5, 17.5, 0.1, 22.5):
        lim = ref.knapsack_limit(budget)
        assert lim == float(np.float32(budget + cons.KNAPSACK_TOL))
        assert np.float32(lim) == lim


@pytest.mark.parametrize("M,n,m,d", [(1, 1000, 300, 6), (7, 777, 130, 17)])
@pytest.mark.parametrize("kind", ["knapsack", "partition", "both"])
def test_constrained_greedy_kernel_matches_plain_on_card(cuda, M, n, m, d,  # noqa: F811
                                                         kind):
    X, E, mask = make_inputs(M, n, m, d, seed=M + n)
    X /= np.sqrt(d)
    E /= np.sqrt(d)
    w = np.stack([_attrs(n, i)[:, 0] for i in range(M)])
    g = np.stack([_attrs(n, i, n_groups=4)[:, 1] for i in range(M)])
    kw = {key: (torch.as_tensor(v, device=cuda) if isinstance(v, np.ndarray)
                else v) for key, v in _kwargs(kind, w, g, 12).items()}
    Xt, Et, mt = (torch.as_tensor(a, device=cuda) for a in (X, E, mask))
    e0 = torch.sum(Et * Et, dim=-1)
    sel, cm = ops.greedy_select(Xt, Et, e0, mt, 12, **kw)
    sel_p, cm_p, gap, best = ref.greedy_select_trace(Xt, Et, e0, mt, 12,
                                                     **kw)
    ok, _ = testing.selections_agree(sel, sel_p, gap, best)
    assert ok
    same = torch.all(sel == sel_p, dim=1)
    testing.assert_close(cm[same], cm_p[same])
