"""The port's streaming round 0 against the JAX package's *resident* TREE
on the CPU, for one plan: fp32, bf16 and int8 sources (the JAX side on the
source's dequantized rows), GREEDY and THRESHOLD-BATCH, unconstrained and
under knapsack ∩ partition, dense and Feistel slots; the wave width from
``wave_machines`` or a byte budget; the streaming centralized greedy,
``fp32_recheck``, ``score_dtype`` and ``select_coreset``.  The JAX
streaming path itself is not the reference: two of its tests fail on this
JAX (ROADMAP queue 3)."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import ExemplarClustering as JExemplar
from repro.core import Intersection as JIntersection
from repro.core import Knapsack as JKnapsack
from repro.core import PartitionMatroid as JPartition
from repro.core import TreeConfig as JTreeConfig
from repro.core import centralized_greedy as jcentralized
from repro.core import sources as jsrc
from repro.core import tree_maximize as jtree
from repro.data import selection as jselection
from repro_torch import testing
from repro_torch.convert import (ArrayPlan, constraint_from_jax,
                                 objective_from_jax, objective_from_numpy)
from repro_torch.core import (ArraySource, ChunkedSource, QuantizedSource,
                              TreeConfig, centralized_greedy,
                              streaming_centralized_greedy, tree_maximize)
from repro_torch.core import algorithms
from repro_torch.core.tree import _wave_row_bytes
from repro_torch.data import datasets
from repro_torch.data.pipeline import DataConfig
from repro_torch.data.selection import (SelectionConfig, fp32_recheck,
                                        mean_pool_embeddings, select_coreset)
from repro_torch.data.sources import ShardedSource, lm_embedding_source

from _torch_parity import jax_tree_plan

N, D, K, MU, N_EVAL = 2000, 6, 6, 90, 64
JCONS = JIntersection((JKnapsack(budget=0.45 * K, col=0),
                       JPartition(caps=(2,) * 4, col=1)))


@functools.lru_cache(maxsize=None)
def _data():
    data = datasets.webscope(n=N, d=D)
    E = data[np.random.default_rng(0).choice(N, N_EVAL, replace=False)]
    r = np.random.default_rng(1)
    attrs = np.stack([r.uniform(0.2, 1.0, N), r.integers(0, 4, N)],
                     axis=1).astype(np.float32)
    return data, E, attrs


def _sources(store):
    data = _data()[0]
    return (jsrc.QuantizedSource(jsrc.ArraySource(data), store, 500),
            QuantizedSource(ArraySource(data), store, 500))


@functools.lru_cache(maxsize=None)
def _jax_resident(store, alg, constrained, permutation="dense"):
    """The JAX resident TREE on the rows a ``store`` source dequantizes to,
    and the plan that replays its partitions."""
    data, E, attrs = _data()
    rows = _sources(store)[0].dequantized()
    res = jtree(JExemplar(jnp.asarray(E)), jnp.asarray(rows),
                JTreeConfig(k=K, capacity=MU, algorithm=alg,
                            permutation=permutation),
                constraint=JCONS if constrained else None,
                attrs=attrs if constrained else None)
    return res, jax_tree_plan(0, MU, res.machines_per_round)


def _assert_same(res, jres, exact_value=False):
    np.testing.assert_array_equal(res.sel_rows, np.asarray(jres.sel_rows))
    np.testing.assert_array_equal(res.sel_mask, np.asarray(jres.sel_mask))
    assert res.rounds == jres.rounds
    assert res.machines_per_round == list(jres.machines_per_round)
    assert res.oracle_calls == int(jres.oracle_calls) < 2 ** 31
    assert res.depth_per_round == list(jres.depth_per_round)
    if exact_value:
        assert res.value == jres.value
        assert res.round_values == jres.round_values
    else:
        testing.assert_close(res.value, jres.value)


@pytest.mark.parametrize("constrained", [False, True])
@pytest.mark.parametrize("alg", ["greedy", "threshold_batch"])
@pytest.mark.parametrize("store", ["fp32", "bf16", "int8"])
def test_streaming_tree_matches_jax_resident(store, alg, constrained):
    """Waves under a byte budget of 7 fp32 machines: the narrow sources fit
    proportionally more machines a wave, with attributes and dequant
    parameters in the fp32 meta columns."""
    data, E, attrs = _data()
    jres, plan = _jax_resident(store, alg, constrained)
    budget = _wave_row_bytes(MU, D + 2) * 7
    cfg = TreeConfig(k=K, capacity=MU, algorithm=alg, capacity_bytes=budget)
    cons = constraint_from_jax(JCONS) if constrained else None
    obj = objective_from_numpy(E, "cpu")
    src = _sources(store)[1]
    res = tree_maximize(obj, src, cfg, device="cpu", plan=plan,
                        constraint=cons, attrs=attrs if constrained else None)
    _assert_same(res, jres)
    st = res.ingest
    assert st.peak_wave_bytes <= budget and st.waves > 1
    assert st.total_machines == jres.machines_per_round[0]
    assert sum(t.machines for t in st.traces) == st.total_machines
    assert st.total_bytes == sum(st.wave_bytes)
    # the port's own resident run on the dequantized rows: the same bits
    resident = tree_maximize(
        obj, src.dequantized(), TreeConfig(k=K, capacity=MU, algorithm=alg),
        device="cpu", plan=plan, constraint=cons,
        attrs=attrs if constrained else None)
    _assert_same(res, resident, exact_value=True)
    if constrained:
        assert res.sel_attrs is not None and res.sel_attrs.shape == (K, 2)


@pytest.mark.parametrize("alg", ["greedy", "threshold_batch"])
def test_feistel_streaming_matches_jax_resident(alg):
    data, E, _ = _data()
    jres, plan = _jax_resident("fp32", alg, False, "feistel")
    key = jax.random.PRNGKey(0)
    _, kpart, _ = jax.random.split(key, 3)
    keys = [int(v) for v in np.asarray(jax.random.randint(
        kpart, (4,), 0, np.iinfo(np.int32).max, dtype=np.int32))]
    plan = ArrayPlan(plan.perms, feistel=[keys])
    obj = objective_from_numpy(E, "cpu")
    cfg = TreeConfig(k=K, capacity=MU, algorithm=alg, permutation="feistel")
    streamed = tree_maximize(obj, ArraySource(data), cfg, device="cpu",
                             plan=plan, wave_machines=3)
    resident = tree_maximize(obj, data, cfg, device="cpu", plan=plan)
    _assert_same(streamed, jres)
    _assert_same(streamed, resident, exact_value=True)
    with pytest.raises(IndexError, match="Feistel"):
        tree_maximize(obj, data, cfg, device="cpu",
                      plan=ArrayPlan(plan.perms))


@pytest.mark.parametrize("wave", [1, 3, None])
@pytest.mark.parametrize("n", [N, 70])
def test_wave_widths_and_a_single_machine_stream_as_resident(wave, n):
    """``wave_machines`` ∈ {1, 3, all}; n = 70 ≤ μ is one machine."""
    data, E, _ = _data()
    data = data[:n]
    obj = objective_from_numpy(E, "cpu")
    cfg = TreeConfig(k=K, capacity=MU, seed=4)
    resident = tree_maximize(obj, data, cfg, device="cpu")
    L = resident.machines_per_round[0]
    W = L if wave is None else wave
    streamed = tree_maximize(obj, ArraySource(data), cfg, device="cpu",
                             wave_machines=W)
    _assert_same(streamed, resident, exact_value=True)
    st = streamed.ingest
    assert st.wave_machines == min(W, L) and st.waves == -(-L // min(W, L))
    assert st.peak_wave_rows == min(W, L) * MU
    assert [t.wave for t in st.traces] == list(range(st.waves))
    assert all(t.gather_s >= 0 and t.h2d_s >= 0 and t.solve_s >= 0
               for t in st.traces)
    assert resident.ingest is None
    if n <= MU:
        assert streamed.machines_per_round == [1] and streamed.rounds == 1


@pytest.mark.parametrize("waves", [1, 2, 5])
@pytest.mark.parametrize("store", ["fp32", "int8"])
def test_capacity_bytes_admit_the_waves_they_say(store, waves):
    data, E, _ = _data()
    src = _sources(store)[1]
    obj = objective_from_numpy(E, "cpu")
    L = -(-N // MU)
    row = _wave_row_bytes(MU, D, 1, 2) if store == "int8" else \
        _wave_row_bytes(MU, D)
    budget = -(-L // waves) * row + row // 2       # rounds down to W
    cfg = TreeConfig(k=K, capacity=MU, capacity_bytes=budget)
    res = tree_maximize(obj, src, cfg, device="cpu")
    assert res.ingest.waves == waves
    assert res.ingest.peak_wave_bytes <= budget
    assert res.ingest.wave_machines == -(-L // waves)
    with pytest.raises(ValueError, match="cannot fit one wave"):
        tree_maximize(obj, src, TreeConfig(k=K, capacity=MU,
                                           capacity_bytes=row - 1),
                      device="cpu")
    with pytest.raises(ValueError, match="over capacity_bytes"):
        tree_maximize(obj, src, TreeConfig(k=K, capacity=MU,
                                           capacity_bytes=row),
                      device="cpu", wave_machines=2)


@pytest.mark.parametrize("kind", ["chunked", "sharded", "quantized-chunked"])
def test_source_kinds_stream_as_the_array(kind):
    data, E, _ = _data()
    obj = objective_from_numpy(E, "cpu")
    cfg = TreeConfig(k=K, capacity=MU, seed=2, algorithm="threshold_batch")
    if kind == "sharded":
        src = ShardedSource.from_arrays([data[s:s + 450]
                                         for s in range(0, N, 450)])
        ref = ArraySource(data)
    else:
        src, ref = ChunkedSource.from_array(data, 333), ArraySource(data)
        if kind.startswith("quantized"):
            src, ref = (QuantizedSource(src, "int8", 300),
                        QuantizedSource(ref, "int8", 300))
    _assert_same(tree_maximize(obj, src, cfg, device="cpu", wave_machines=4),
                 tree_maximize(obj, ref, cfg, device="cpu", wave_machines=9),
                 exact_value=True)


@pytest.mark.parametrize("constrained", [False, True])
def test_streaming_centralized_matches_resident_and_jax(constrained):
    data, E, attrs = _data()
    obj = objective_from_numpy(E, "cpu")
    cons = constraint_from_jax(JCONS) if constrained else None
    a = attrs if constrained else None
    resident = centralized_greedy(obj, data, K, device="cpu",
                                  constraint=cons, attrs=a)
    streamed = streaming_centralized_greedy(
        obj, ArraySource(data, attrs=a), K, constraint=cons, device="cpu",
        chunk_rows=333, prefetch_depth=3)
    via = centralized_greedy(obj, ChunkedSource.from_array(data, 250), K,
                             device="cpu", constraint=cons, attrs=a)
    for got in (streamed, via):
        assert torch.equal(got.sel_rows, resident.sel_rows)
        assert torch.equal(got.sel_mask, resident.sel_mask)
        assert float(got.value) == float(resident.value)
    if constrained:
        assert torch.equal(streamed.sel_attrs, resident.sel_attrs)
    jres = jcentralized(JExemplar(jnp.asarray(E)), jnp.asarray(data), K,
                        constraint=JCONS if constrained else None, attrs=a)
    np.testing.assert_array_equal(streamed.sel_rows.numpy(),
                                  np.asarray(jres.sel_rows))
    testing.assert_close(streamed.value, jres.value)


@pytest.mark.parametrize("constrained", [False, True])
@pytest.mark.parametrize("store", ["bf16", "int8"])
def test_streaming_centralized_narrow_source_matches_dequantized(store,
                                                                 constrained):
    """A narrow source's chunks are scored as the rows they dequantize to
    (int8 codes with their per-row parameters), not as raw codes."""
    data, E, attrs = _data()
    obj = objective_from_numpy(E, "cpu")
    cons = constraint_from_jax(JCONS) if constrained else None
    a = attrs if constrained else None
    q = _sources(store)[1]
    resident = centralized_greedy(obj, q.dequantized(), K, device="cpu",
                                  constraint=cons, attrs=a)
    streamed = streaming_centralized_greedy(
        obj, q, K, constraint=cons, attrs=a, device="cpu", chunk_rows=333)
    assert torch.equal(streamed.sel_rows, resident.sel_rows)
    assert torch.equal(streamed.sel_mask, resident.sel_mask)
    assert float(streamed.value) == float(resident.value)


@pytest.mark.parametrize("store", ["fp32", "bf16", "int8"])
def test_fp32_recheck_matches_jax(store):
    data, E, _ = _data()
    jres, plan = _jax_resident(store, "greedy", False)
    jq, tq = _sources(store)
    jre = jselection.fp32_recheck(JExemplar(jnp.asarray(E)), jq,
                                  np.asarray(jres.sel_rows),
                                  np.asarray(jres.sel_mask))
    tre = fp32_recheck(objective_from_numpy(E, "cpu"), tq,
                       np.asarray(jres.sel_rows), np.asarray(jres.sel_mask))
    np.testing.assert_array_equal(tre.indices, jre.indices)
    np.testing.assert_array_equal(tre.rows_fp32, jre.rows_fp32)
    testing.assert_close(tre.value, jre.value)
    np.testing.assert_array_equal(tre.rows_fp32, data[tre.indices])


def test_score_dtype_carries_across_and_matches_jax():
    data, E, _ = _data()
    jobj = JExemplar(jnp.asarray(E), score_dtype="bfloat16")
    obj = objective_from_jax(jobj, "cpu")
    assert obj.score_dtype == "bfloat16"
    jres = jtree(jobj, jnp.asarray(data), JTreeConfig(k=K, capacity=MU))
    plan = jax_tree_plan(0, MU, jres.machines_per_round)
    res = tree_maximize(obj, ArraySource(data), TreeConfig(k=K, capacity=MU),
                        device="cpu", plan=plan, wave_machines=5)
    _assert_same(res, jres)
    # the fused and the step-wise paths contract alike
    T = torch.from_numpy(data[:MU])
    mask = torch.ones((MU,), dtype=torch.bool)
    fused = algorithms.greedy(obj, T, mask, K, fused=True)
    scan = algorithms.greedy(obj, T, mask, K, fused=False)
    assert torch.equal(fused.sel_idx, scan.sel_idx)
    assert float(fused.value) == float(scan.value)
    with pytest.raises(ValueError, match="score_dtype"):
        objective_from_numpy(E, "cpu", score_dtype="float16")


def test_select_coreset_matches_jax():
    data, _, _ = _data()
    scfg = jselection.SelectionConfig(k=K, capacity=MU, n_eval=N_EVAL, seed=3)
    jidx, jres = jselection.select_coreset(jnp.asarray(data), scfg)
    ev = np.asarray(jax.random.choice(jax.random.PRNGKey(3), N, (N_EVAL,),
                                      replace=False))
    plan = jax_tree_plan(3, MU, jres.machines_per_round)
    plan = ArrayPlan(plan.perms, eval_idx=ev)
    idx, res = select_coreset(ArraySource(data), SelectionConfig(
        k=K, capacity=MU, n_eval=N_EVAL, seed=3), device="cpu", plan=plan)
    np.testing.assert_array_equal(idx, np.asarray(jidx))
    np.testing.assert_array_equal(res.sel_rows, np.asarray(jres.sel_rows))
    assert res.ingest is not None


def test_lm_embedding_source_pools_the_synthetic_batches():
    dcfg = DataConfig(vocab_size=50, seq_len=7, global_batch=4, d_model=8)
    params = {"emb": torch.from_numpy(np.random.default_rng(0).standard_normal(
        (50, 8)).astype(np.float32))}
    src = lm_embedding_source(params, dcfg, n_batches=3)
    assert (src.n, src.d) == (12, 8)
    from repro_torch.data.pipeline import SyntheticLM
    tokens = SyntheticLM(dcfg, device="cpu").batch(1)["tokens"]
    np.testing.assert_array_equal(src.gather(np.arange(4, 8)),
                                  mean_pool_embeddings(params, tokens).numpy())
