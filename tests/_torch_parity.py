"""Shared helpers of the parity tests between ``repro`` and ``repro_torch``.

Inputs are made with NumPy from a seed and handed to both packages; the
round plan of a JAX tree run is replayed from its threefry key chain.
"""
import contextlib
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as JL
from repro_torch import testing
from repro_torch.convert import ArrayPlan
from repro_torch.models import layers as TL


def make_inputs(M, n, m, d, seed, frac_valid=0.85):
    """(M, n, d) candidates, (m, d) eval rows, (M, n) availability."""
    r = np.random.default_rng(seed)
    X = r.standard_normal((M, n, d)).astype(np.float32)
    E = r.standard_normal((m, d)).astype(np.float32)
    mask = r.random((M, n)) < frac_valid
    return X, E, mask


def make_attrs(r, shape, n_groups):
    """Knapsack weights ~ U(0.2, 1.0) and group ids uniform over
    ``n_groups``, both fp32 (the attribute columns of the benchmarks)."""
    w = r.uniform(0.2, 1.0, shape).astype(np.float32)
    g = r.integers(0, n_groups, shape).astype(np.float32)
    return w, g


def jax_tree_plan(seed: int, mu: int, machines_per_round,
                  k: int | None = None) -> ArrayPlan:
    """The slot permutations ``repro.core.tree.tree_maximize`` draws: per
    round ``key, kpart, kalg = split(key, 3)`` and ``permutation(kpart,
    L·μ)``.  With ``k``, also stochastic_greedy's scores: machine i of the
    round draws ``uniform(key_j, (μ,))`` for the k keys ``split(split(kalg,
    L)[i], k)``."""
    key = jax.random.PRNGKey(seed)
    perms, scores = [], []
    for L in machines_per_round:
        key, kpart, kalg = jax.random.split(key, 3)
        perms.append(np.asarray(jax.random.permutation(kpart, L * mu)))
        if k is not None:
            scores.append(jax_stochastic_scores(kalg, L, k, mu))
    return ArrayPlan(perms, stochastic=scores if k is not None else None)


def jax_serve_plan(seed: int, request_seed: int, ladder, mu: int
                   ) -> ArrayPlan:
    """The slot permutations ``repro.serve`` draws for one request: round 0
    from ``kpart`` of ``key1, kpart, kalg = split(PRNGKey(seed), 3)`` (the
    tree's round 0, the session's blocks), rounds ≥ 1 from ``chain =
    fold_in(key1, request_seed)`` split by 3 a round as ``jax_tree_plan``
    splits the tree's key; ``permutation(kpart_t, m_t·μ)`` for the machine
    counts ``ladder``."""
    key1, kpart, _kalg = jax.random.split(jax.random.PRNGKey(seed), 3)
    perms = [np.asarray(jax.random.permutation(kpart, ladder[0] * mu))]
    chain = jax.random.fold_in(key1, request_seed)
    for m in ladder[1:]:
        chain, kpart, _kalg = jax.random.split(chain, 3)
        perms.append(np.asarray(jax.random.permutation(kpart, m * mu)))
    return ArrayPlan(perms)


def jax_stochastic_scores(kalg, machines: int, k: int, cap: int
                          ) -> np.ndarray:
    """``(machines, k, cap)``: the uniform scores
    ``repro.core.algorithms.stochastic_greedy`` draws on machine i of a
    round whose algorithm key is ``kalg``."""
    keys = jax.random.split(kalg, machines)
    draw = jax.vmap(lambda kk: jax.vmap(
        lambda kj: jax.random.uniform(kj, (cap,)))(jax.random.split(kk, k)))
    return np.array(draw(keys))


@pytest.fixture
def cuda():
    """The card, or a skip with the reason (decided when the test runs)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernels run only "
                    "there (python3 chip_smoke.py drives them)")
    return torch.device("cuda")


def jax_gain_trace(jobj, T, mask, sel) -> np.ndarray:
    """The JAX objective's gains at each step of its own selections ``sel``
    ``(k,)`` over one block, replayed through its oracle: ``(k, cap)``,
    −1e30 where a row is no longer a candidate — what
    ``repro_torch.testing.picks_agree`` holds the port's picks against."""
    import jax.numpy as jnp
    state = jobj.init_state(jnp.asarray(T), jnp.asarray(mask))
    avail = np.asarray(mask, bool).copy()
    out = []
    for s in np.asarray(sel):
        out.append(np.asarray(jobj.gains(state, jnp.asarray(T),
                                         jnp.asarray(avail))))
        if s >= 0:
            state = jobj.update(state, jnp.asarray(T), jnp.int32(s))
            avail[s] = False
    return np.stack(out)


def tree_inputs(n=601, d=8, ne=128, seed=0):
    """Seeded ``(n, d)`` rows and ``ne`` eval rows drawn from them, the
    inputs of the JAX package's engine tests."""
    r = np.random.default_rng(seed)
    data = r.standard_normal((n, d)).astype(np.float32)
    return data, data[r.choice(n, ne, replace=False)]


def assert_same_tree(a, b, work=True):
    """Two TREE results agree bit for bit; ``work=False`` leaves out the
    oracle calls and depth (a dropped wave's machines did no work)."""
    np.testing.assert_array_equal(a.sel_rows, np.asarray(b.sel_rows))
    np.testing.assert_array_equal(a.sel_mask, np.asarray(b.sel_mask))
    assert a.value == b.value
    assert a.rounds == b.rounds
    assert list(a.machines_per_round) == list(b.machines_per_round)
    assert list(a.round_values) == list(b.round_values)
    if work:
        assert a.oracle_calls == int(b.oracle_calls)
        assert list(a.depth_per_round) == list(b.depth_per_round)


@contextlib.contextmanager
def followed_routes():
    """The JAX package's router input and top-K experts, one record per MoE
    call in call order, through an ordered debug callback in a wrapped
    ``layers.moe`` (read at trace time); the port's router is held on the
    same input and then dispatches the JAX package's experts
    (``testing.follow_routes``); the input is recorded in the port's
    compute dtype, which the JAX package's matches.  Yields (the JAX
    records, the port's
    flips on the same input, its own routes' flips): the port's i-th MoE
    call follows the JAX package's i-th."""
    jrecs, flips, own = [], [], []
    jmoe = JL.moe

    def jax_moe(p, x, cfg):
        h = JL.cast(JL.rms_norm(x, p["ln"], cfg.norm_eps))
        logits = (h @ JL.cast(p["router"])).astype(jnp.float32)
        _, top_e = jax.lax.top_k(jax.nn.softmax(logits, axis=-1),
                                 cfg.experts_per_token)
        jax.debug.callback(
            lambda hc, e: jrecs.append((
                torch.from_numpy(np.asarray(hc, np.float32)).to(
                    TL.COMPUTE_DTYPE),
                torch.from_numpy(np.asarray(e)).long())),
            h, top_e, ordered=True)
        return jmoe(p, x, cfg)

    JL.moe = jax_moe
    try:
        with TL.route_hook(testing.follow_routes(jrecs, flips, own)):
            yield jrecs, flips, own
    finally:
        JL.moe = jmoe


def route_summary(flips, own) -> str:
    """One line of a run's route flips (``followed_routes``' lists)."""
    def n(fl):
        return sum(int(rf["flipped"].sum()) for rf in fl)
    return (f"{n(flips)} route flips of "
            f"{sum(rf['flipped'].size for rf in flips)} on the same input "
            f"(largest margin {max(rf['max_flip_ulps'] for rf in flips)!r} "
            f"bf16 ulps), smallest top-K margin "
            f"{min(rf['min_margin'] for rf in flips)!r}; on the port's own "
            f"input {n(own)} (largest margin "
            f"{max(rf['max_flip_ulps'] for rf in own)!r} ulps)")


@contextlib.contextmanager
def compute_dtype(mode: str):
    """Both packages' ``COMPUTE_DTYPE`` (read at call time) set to ``mode``
    (``"fp32"`` or ``"bf16"``) for the duration."""
    saved = JL.COMPUTE_DTYPE, TL.COMPUTE_DTYPE
    if mode == "fp32":
        JL.COMPUTE_DTYPE, TL.COMPUTE_DTYPE = jnp.float32, torch.float32
    try:
        yield
    finally:
        JL.COMPUTE_DTYPE, TL.COMPUTE_DTYPE = saved


#: the train-step parity runs: batch, sequence, steps, optimizer settings
TRAIN_B, TRAIN_S, TRAIN_STEPS = 4, 16, 2
TRAIN_OPT = dict(lr=1e-3, warmup_steps=2, total_steps=10)


@functools.lru_cache(maxsize=None)
def jax_train_init(arch: str):
    """The JAX ``init_train_state`` of ``arch``'s ``reduced()`` config
    (jitted; eager init of the hybrid takes seconds)."""
    from repro.configs import get_config as jax_config
    from repro.train import optimizer as jopt
    from repro.train import train_step as jts
    cfg = jax_config(arch).reduced()
    return jax.jit(jts.init_train_state, static_argnums=(0, 1))(
        cfg, jopt.OptConfig(**TRAIN_OPT), jax.random.PRNGKey(0))


def step_parity(arch: str, n_micro: int, mode: str) -> list[dict]:
    """``TRAIN_STEPS`` train steps of ``arch`` at ``reduced()`` with
    ``n_micro`` microbatches, in both packages from the JAX initial state
    (``convert.train_state_from_jax``) on the same SyntheticLM batches,
    COMPUTE_DTYPE ``mode`` in both; each step's loss, grad_norm, lr,
    parameter update, mu and nu held to ``testing.TRAIN_STEP_TOL``.
    Returns the measured distances, one dict a step."""
    import dataclasses

    from repro.configs import get_config as jax_config
    from repro.data import pipeline as jpipe
    from repro.train import optimizer as jopt
    from repro.train import train_step as jts
    from repro_torch import testing
    from repro_torch.configs import get_config
    from repro_torch.convert import train_state_from_jax
    from repro_torch.data import pipeline as tpipe
    from repro_torch.train import optimizer as topt
    from repro_torch.train import train_step as tts
    jcfg = dataclasses.replace(jax_config(arch).reduced(),
                               microbatches=n_micro)
    tcfg = dataclasses.replace(get_config(arch).reduced(),
                               microbatches=n_micro)
    js = jax_train_init(arch)
    ts = train_state_from_jax(js, tcfg, "cpu")
    jstep = jax.jit(jts.make_train_step(jcfg, jopt.OptConfig(**TRAIN_OPT)))
    tstep = tts.make_train_step(tcfg, topt.OptConfig(**TRAIN_OPT))
    dc = dict(vocab_size=jcfg.vocab_size, seq_len=TRAIN_S,
              global_batch=TRAIN_B, seed=0, frontend=jcfg.frontend,
              frontend_tokens=jcfg.frontend_tokens, d_model=jcfg.d_model)
    jdata = jpipe.SyntheticLM(jpipe.DataConfig(**dc))
    tdata = tpipe.SyntheticLM(tpipe.DataConfig(**dc), "cpu")
    tol = testing.TRAIN_STEP_TOL[torch.float32 if mode == "fp32"
                                 else torch.bfloat16]
    out = []
    with compute_dtype(mode):
        for step in range(TRAIN_STEPS):
            before = [np.array(x) for x in
                      jax.tree_util.tree_leaves(js["params"])]
            js, jm = jstep(js, jdata.batch(step))
            ts, tm = tstep(ts, tdata.batch(step))
            got = {key: abs(float(tm[key]) - float(jm[key]))
                   / abs(float(jm[key])) for key in ("loss", "grad_norm",
                                                     "lr")}
            jp = jax.tree_util.tree_leaves(js["params"])
            tp = topt.tree_leaves(ts["params"])
            assert len(jp) == len(tp)
            for a, b in zip(tp, jp):
                assert tuple(a.shape) == tuple(b.shape)
                assert a.dtype == torch.float32
            got["update"] = testing.rel_norm(
                [testing._np(a) - p0 for a, p0 in zip(tp, before)],
                [testing._np(a) - p0 for a, p0 in zip(jp, before)])
            for name in ("mu", "nu"):
                got[name] = testing.rel_norm(
                    topt.tree_leaves(ts["opt"][name]),
                    jax.tree_util.tree_leaves(js["opt"][name]))
            assert int(ts["opt"]["step"]) == int(js["opt"]["step"]) == step + 1
            bad = {k: v for k, v in got.items() if not v <= tol[k]}
            assert not bad, (f"{arch} n_micro={n_micro} {mode} step {step}: "
                             f"{bad} past {tol}")
            out.append(got)
    return out
