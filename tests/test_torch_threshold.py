"""The port's threshold-batch tier against the JAX package on the CPU: the
plain ``threshold_select`` at several block sizes with mid-ladder state and
every constraint encoding, the τ-ladder, the near-threshold rule,
and the CUDA kernel against its plain version on a card."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import ExemplarClustering as JExemplar
from repro.core import algorithms as jalg
from repro.kernels import ref as jref
from repro_torch import testing
from repro_torch.convert import objective_from_numpy
from repro_torch.core import algorithms
from repro_torch.kernels import ops, ref

from _torch_parity import cuda, make_attrs, make_inputs  # noqa: F401

G = 4
CAPS = (3, 2, 4, 1)


def _encoding(kind, w, g, k):
    """(JAX kwargs, port kwargs) of one constraint encoding."""
    kw = {}
    if kind in ("knapsack", "both"):
        kw.update(weights=w, budget=0.3 * k)
    if kind in ("partition", "both"):
        kw.update(group_ids=g, caps=CAPS)
    return kw


def _mid_ladder(r, M, k, kind):
    """Non-zero running state: count, used, per-group counts."""
    count = r.integers(0, k // 2, M).astype(np.int32)
    used = (r.random(M) * 0.1 * k).astype(np.float32)
    if kind in ("none", "knapsack"):
        counts = np.zeros((M, 1), np.int32)
    else:
        counts = np.minimum(r.integers(0, 2, (M, G)),
                            np.asarray(CAPS) - 1).astype(np.int32)
    return count, used, counts


@pytest.mark.parametrize("bn", [16, 32, 256])
@pytest.mark.parametrize("kind", ["none", "knapsack", "partition", "both"])
def test_threshold_select_matches_jax(bn, kind):
    M, n, m, d, k = 3, 300, 37, 5, 12
    X, E, mask = make_inputs(M, n, m, d, seed=bn + len(kind))
    r = np.random.default_rng(bn)
    w, g = make_attrs(r, (M, n), G)
    cm = np.sum(E * E, axis=-1) * (0.6 + 0.4 * r.random((M, m)))
    cm = cm.astype(np.float32)
    count, used, counts = _mid_ladder(r, M, k, kind)
    g0 = np.stack([np.asarray(jref.exemplar_gains(
        jnp.asarray(X[i]), jnp.asarray(E), jnp.asarray(cm[i])))
        for i in range(M)])
    tau = (np.max(g0, axis=1) * 0.3).astype(np.float32)
    kw = _encoding(kind, w, g, k)
    tkw = {key: (torch.from_numpy(v) if isinstance(v, np.ndarray) else v)
           for key, v in kw.items()}
    acc, cm_out = ops.threshold_select(
        torch.from_numpy(X), torch.from_numpy(E), torch.from_numpy(cm),
        torch.from_numpy(mask), torch.from_numpy(tau), k,
        used=torch.from_numpy(used), count=torch.from_numpy(count),
        counts=torch.from_numpy(counts), bn=bn, **tkw)
    n_acc = 0
    for i in range(M):
        jkw = {key: (jnp.asarray(v[i]) if isinstance(v, np.ndarray) else v)
               for key, v in kw.items()}
        jacc, jcm = jref.threshold_select(
            jnp.asarray(X[i]), jnp.asarray(E), jnp.asarray(cm[i]),
            jnp.asarray(mask[i]), jnp.float32(tau[i]), jnp.float32(used[i]),
            jnp.asarray(counts[i]), jnp.int32(count[i]), k=k, bn=bn, **jkw)
        np.testing.assert_array_equal(acc[i].numpy(), np.asarray(jacc))
        testing.assert_close(cm_out[i], jcm, f"machine {i}")
        n_acc += int(np.asarray(jacc).sum())
    assert n_acc > 0                  # the level accepted something


def test_threshold_select_stops_at_first_violation():
    """k = count + 1: the first qualifying row fills k, the second stops the
    launch, and no later block accepts (bn = 8, many blocks)."""
    X, E, mask = make_inputs(1, 200, 9, 3, seed=5)
    mask[:] = True
    Xt, Et = torch.from_numpy(X), torch.from_numpy(E)
    e0 = torch.sum(Et * Et, dim=-1)
    tau = 0.5 * ref.exemplar_gains(Xt, Et, e0).max()
    acc, _ = ops.threshold_select(Xt, Et, e0, torch.from_numpy(mask), tau, 4,
                                  count=torch.tensor([3]), bn=8)
    assert int(acc.sum()) == 1
    jacc, _ = jref.threshold_select(
        jnp.asarray(X[0]), jnp.asarray(E), jnp.asarray(e0.numpy()),
        jnp.asarray(mask[0]), jnp.float32(tau), jnp.float32(0.0),
        jnp.zeros((1,), jnp.int32), jnp.int32(3), k=4, bn=8)
    np.testing.assert_array_equal(acc[0].numpy(), np.asarray(jacc))


def test_inactive_machines_are_left_alone():
    X, E, mask = make_inputs(3, 50, 7, 4, seed=9)
    Xt, Et, mt = map(torch.from_numpy, (X, E, mask))
    e0 = torch.sum(Et * Et, dim=-1)
    active = torch.tensor([True, False, True])
    acc, cm = ops.threshold_select(Xt, Et, e0, mt, 0.0, 5, active=active)
    acc_all, cm_all = ops.threshold_select(Xt, Et, e0, mt, 0.0, 5)
    assert not bool(acc[1].any()) and torch.equal(cm[1], e0)
    assert torch.equal(acc[active], acc_all[active])
    assert torch.equal(cm[active], cm_all[active])


@pytest.mark.parametrize("op", ["threshold_select", "greedy_select"])
@pytest.mark.parametrize("kind", ["knapsack", "partition", "both"])
def test_prebuilt_encoding_matches_raw_operands(op, kind):
    """An Encoding built once (the τ-ladder's) gives what the raw
    constraint operands give; passing both is refused."""
    M, n, m, d, k = 3, 120, 17, 4, 8
    X, E, mask = make_inputs(M, n, m, d, seed=len(kind))
    w, g = make_attrs(np.random.default_rng(3), (M, n), G)
    kw = {key: (torch.from_numpy(v) if isinstance(v, np.ndarray) else v)
          for key, v in _encoding(kind, w, g, k).items()}
    Xt, Et, mt = map(torch.from_numpy, (X, E, mask))
    e0 = torch.sum(Et * Et, dim=-1)
    args = ((Xt, Et, e0, mt, 0.3 * ref.exemplar_gains(Xt, Et, e0).amax(1), k)
            if op == "threshold_select" else (Xt, Et, e0, mt, k))
    fn = getattr(ops, op)
    enc = ref.Encoding(M, n, Xt.device, **kw)
    raw, built = fn(*args, **kw), fn(*args, enc=enc)
    assert int(raw[0].sum()) != 0
    for a, b in zip(raw, built):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="not both"):
        fn(*args, enc=enc, **kw)


@pytest.mark.parametrize("eps", [0.3, 0.5])
def test_tau_ladder_matches_jax(eps, record_property):
    """τ_l = d_max·(1−ε)^l in fp32 on both sides; the largest difference
    from the JAX τ over every level is recorded (and must stay below the
    one tolerance)."""
    d_max = np.random.default_rng(1).random(64).astype(np.float32) + 0.01
    worst = 0.0
    for level in range(40):
        jt = np.asarray(jnp.asarray(d_max) * (1.0 - eps)
                        ** jnp.float32(level))
        tt = torch.from_numpy(d_max) * torch.pow(
            torch.tensor(1.0 - eps, dtype=torch.float32),
            torch.full((64,), float(level)))
        worst = max(worst, testing.max_abs_err(tt, jt))
        testing.assert_close(tt, jt, f"level {level}")
    record_property("tau_max_abs_diff", worst)


def _pair(E):
    return JExemplar(jnp.asarray(E)), objective_from_numpy(E, "cpu")


@pytest.mark.parametrize("kind", ["none", "knapsack", "partition", "both"])
@pytest.mark.parametrize("eps", [0.3, 0.5])
def test_fused_threshold_select_matches_jax(kind, eps):
    """The ladder over a batch of machines against the JAX ladder per
    machine: sel_idx, calls and launches exact, the value within the
    tolerance; an empty machine stops at once."""
    M, n, m, d, k = 3, 333, 24, 6, 10
    X, E, mask = make_inputs(M, n, m, d, seed=int(eps * 10) + len(kind))
    mask[2] = False
    w, g = make_attrs(np.random.default_rng(7), (M, n), G)
    kw = _encoding(kind, w, g, k)
    jobj, tobj = _pair(E)
    tkw = {key: (torch.from_numpy(v) if isinstance(v, np.ndarray) else v)
           for key, v in kw.items()}
    sel, smask, value, calls, launches = tobj.fused_threshold_select(
        torch.from_numpy(X), torch.from_numpy(mask), k, eps=eps, **tkw)
    for i in range(M):
        jkw = {key: (jnp.asarray(v[i]) if isinstance(v, np.ndarray) else v)
               for key, v in kw.items()}
        js, jm, jv, jc, jl = jobj.fused_threshold_select(
            jnp.asarray(X[i]), jnp.asarray(mask[i]), k, eps=eps, **jkw)
        np.testing.assert_array_equal(sel[i].numpy(), np.asarray(js))
        np.testing.assert_array_equal(smask[i].numpy(), np.asarray(jm))
        assert int(calls[i]) == int(jc) and int(launches[i]) == int(jl)
        testing.assert_close(value[i], jv, f"machine {i}")
    assert int(launches[2]) == 0


@pytest.mark.parametrize("kind", ["none", "knapsack", "both"])
def test_threshold_batch_matches_jax_through_run_algorithm(kind):
    X, E, mask = make_inputs(1, 300, 20, 5, seed=31)
    w, g = make_attrs(np.random.default_rng(3), (300,), G)
    attrs = np.stack([w, g], axis=1)
    from repro.core import constraints as jcons
    from repro_torch.convert import constraint_from_jax
    jc = {"none": None, "knapsack": jcons.Knapsack(budget=2.5, col=0),
          "both": jcons.Intersection((jcons.Knapsack(budget=3.0, col=0),
                                      jcons.PartitionMatroid(CAPS, col=1)))
          }[kind]
    jobj, tobj = _pair(E)
    a = None if jc is None else attrs
    jres = jalg.run_algorithm("threshold_batch", jobj, jnp.asarray(X[0]),
                              jnp.asarray(mask[0]), 9, eps=0.4, constraint=jc,
                              attrs=None if a is None else jnp.asarray(a))
    tres = algorithms.run_algorithm(
        "threshold_batch", tobj, torch.from_numpy(X[0]),
        torch.from_numpy(mask[0]), 9, eps=0.4,
        constraint=constraint_from_jax(jc),
        attrs=None if a is None else torch.from_numpy(a))
    np.testing.assert_array_equal(tres.sel_idx.numpy(),
                                  np.asarray(jres.sel_idx))
    assert int(tres.oracle_calls) == int(jres.oracle_calls)
    assert int(tres.depth) == int(jres.depth)
    testing.assert_close(tres.value, jres.value)


def test_near_threshold_rule():
    """Accept sets must agree up to the first near-threshold or near-budget
    row; machines that agree everywhere count as compared in full."""
    ref_acc = np.array([[1, 0, 1, 0], [0, 1, 0, 0]], bool)
    gains = np.array([[5.0, 1.0, 3.0, 0.5], [1.0, 2.0 + 1e-9, 1.0, 0.1]])
    tau = np.array([2.0, 2.0])
    ok, full, n_near = testing.accepts_agree(ref_acc, ref_acc, gains, tau)
    assert (ok, full, n_near) == (True, 2, 1)
    part = np.array([[1, 0, 1, 0], [0, 0, 1, 0]], bool)
    assert testing.accepts_agree(part, ref_acc, gains, tau)[:2] == (True, 1)
    early = np.array([[0, 0, 1, 0], [0, 1, 0, 0]], bool)
    assert not testing.accepts_agree(early, ref_acc, gains, tau)[0]
    load = np.array([[0.5, 0.5, 1.0 - 1e-9, 1.0], [0.1, 0.2, 0.2, 0.2]])
    late = np.array([[1, 0, 0, 0], [0, 1, 0, 0]], bool)
    assert not testing.accepts_agree(late, ref_acc, gains, tau)[0]
    assert testing.accepts_agree(late, ref_acc, gains, tau, load=load,
                                 limit=1.0)[:2] == (True, 1)


@pytest.mark.parametrize("M,n,m,d,bn", [(1, 300, 70, 6, 256), (7, 333, 130, 17, 16),
                                        (3, 200, 64, 6, 256),
                                        (1, 30_000, 100, 6, 256)])
@pytest.mark.parametrize("kind", ["none", "both"])
def test_threshold_kernel_matches_plain_on_card(cuda, M, n, m, d, bn,  # noqa: F811
                                                kind):
    X, E, mask = make_inputs(M, n, m, d, seed=M + n)
    X /= np.sqrt(d)
    E /= np.sqrt(d)
    w, g = make_attrs(np.random.default_rng(n), (M, n), G)
    kw = {key: (torch.as_tensor(v, device=cuda) if isinstance(v, np.ndarray)
                else v) for key, v in _encoding(kind, w, g, 12).items()}
    Xt, Et, mt = (torch.as_tensor(a, device=cuda) for a in (X, E, mask))
    e0 = torch.sum(Et * Et, dim=-1)
    tau = 0.4 * ops.exemplar_gains(Xt, Et, e0).amax(dim=-1)
    acc, cm = ops.threshold_select(Xt, Et, e0, mt, tau, 12, bn=bn, **kw)
    acc_p, cm_p, gains, load = ref.threshold_select_trace(
        Xt, Et, e0, mt, tau, 12, bn=bn, **kw)
    limit = ref.knapsack_limit(kw["budget"]) if "budget" in kw else None
    ok, full, _ = testing.accepts_agree(acc, acc_p, gains, tau, load=load,
                                        limit=limit)
    assert ok
    same = torch.all(acc == acc_p, dim=1)
    testing.assert_close(cm[same], cm_p[same])
