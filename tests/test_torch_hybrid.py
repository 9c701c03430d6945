"""The port's hybrid family (jamba-1.5-large-398b) and its recurrent pieces
against the JAX package on the CPU.

The pieces: ``layers.conv1d_causal`` with and without a cache, to the bit;
``layers.gla_step`` against the JAX step; the port's ``gla_chunked`` (the
recurrence through ``ops.wkv6`` with u = 0) against the JAX
``gla_chunked`` where the decay is slow (a = 0.9, 0.99), and against the
JAX recurrence (``gla_step`` iterated) at a = 0.5, Jamba's decay at init,
where the JAX chunked form parts from the recurrence from step 44 of each
64-step chunk by nearly |y| itself (its factorisation clipped at exp(±30):
``src/repro/models/layers.py:399``, ROADMAP queue 3) — that gap is shown
too.

The model at ``reduced()`` size (16 layers = 4 periods of 3 Mamba layers
and 1 attention layer, d_model 64, 8 experts top-2 at capacity factor 4.0,
so nothing drops) on ``convert.params_from_jax`` weights: one Mamba layer
(prompt and decode step); ``forward`` (bf16 and, with ``COMPUTE_DTYPE``
fp32 in both packages, fp32), ``prefill`` (logits, the attention K/V,
conv and state caches, ``pos``) and every ``decode_step`` at S = 16 and
32; at S = 128 the port's ``prefill`` (logits and final caches) against
the JAX model fed token by token through ``decode_step``, since the JAX
prefill itself runs the clipped chunked form; the port's own
decode-vs-forward consistency; the converted and drawn parameter trees.
Routes: the port's router is held on the JAX package's router input and
then dispatches its experts (``testing.follow_routes``, as
``tests/test_torch_moe.py``).

Tolerance: ``repro_torch.testing.RWKV_ATOL`` — the Mamba layers keep y in
fp32 at decode and in bf16 at prefill, as RWKV-6 (the JAX package's two
paths round apart), and the bf16 drift of the frameworks' matmuls grows
through 16 layers as through RWKV-6's: bf16 logits and caches within 0.5,
the fp32 states within 5% of their largest value (measured: forward
0.19140625); fp32 within 1e-4 (measured 1.24e-5).  One Mamba layer's
output within ``LM_ATOL``; the recurrent pieces within ``testing.RTOL`` /
``ATOL``.
"""
import contextlib
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import followed_routes, route_summary
from repro.configs import get_config as jax_config
from repro.models import hybrid as JH
from repro.models import layers as JL
from repro.serve import serve_step as JS
from repro_torch import testing
from repro_torch.configs import HYBRID_ARCH_IDS, get_config
from repro_torch.convert import params_from_jax
from repro_torch.models import get_model
from repro_torch.models import hybrid as TH
from repro_torch.models import layers as TL
from repro_torch.serve import make_serve_fns

ARCH = "jamba-1.5-large-398b"
B, N_NEW, LONG = 2, 4, 128
SEQS = (16, 32)
LOGIT_TOL, STATE_SHARE = testing.RWKV_ATOL[torch.bfloat16]


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _close(mine, theirs, what, atol=LOGIT_TOL):
    np.testing.assert_allclose(_np(mine), _np(theirs), rtol=0, atol=atol,
                               err_msg=what)


def _state_close(mine, theirs, what):
    scale = float(np.abs(_np(theirs)).max())
    np.testing.assert_allclose(_np(mine), _np(theirs), rtol=0,
                               atol=STATE_SHARE * scale, err_msg=what)


# -- the recurrent pieces ------------------------------------------------


@pytest.mark.parametrize("weights", ["bf16", "fp32"])
@pytest.mark.parametrize("cached", [False, True])
def test_conv1d_causal_matches_jax_to_the_bit(cached, weights):
    """bf16 activations, taps in bf16 (the model's, after cast_stacks) or
    fp32; the JAX function run as it is written (no jit)."""
    r = np.random.default_rng(10)
    x = r.standard_normal((2, 9, 32)).astype(np.float32)
    w = (0.1 * r.standard_normal((4, 32))).astype(np.float32)
    c = r.standard_normal((2, 3, 32)).astype(np.float32)
    jx = jnp.asarray(x).astype(jnp.bfloat16)
    tx = torch.from_numpy(x).bfloat16()
    jw, tw = jnp.asarray(w), torch.from_numpy(w)
    if weights == "bf16":
        jw, tw = jw.astype(jnp.bfloat16), tw.bfloat16()
    jc = jnp.asarray(c).astype(jnp.bfloat16) if cached else None
    tc = torch.from_numpy(c).bfloat16() if cached else None
    jo, jn = JL.conv1d_causal(jx, jw, jc)
    to, tn = TL.conv1d_causal(tx, tw, tc)
    assert to.dtype == (torch.bfloat16 if weights == "bf16"
                        else torch.float32)
    np.testing.assert_array_equal(_np(to), _np(jo))
    if cached:
        np.testing.assert_array_equal(_np(tn), _np(jn))
        assert tn.shape == (2, 3, 32)
    else:
        assert tn is None and jn is None


def _gla_inputs(seed, a, T=LONG, H=2, Dk=16, Dv=16, dtype=np.float32):
    r = np.random.default_rng(seed)
    rr, kk = (r.standard_normal((1, H, T, Dk)).astype(dtype)
              for _ in range(2))
    vv = r.standard_normal((1, H, T, Dv)).astype(dtype)
    if a is None:          # the data-dependent decay of RWKV-6's tests
        wl = -np.exp(r.standard_normal((1, H, T, Dk)) - 1.0)
    else:
        wl = np.full((1, H, T, Dk), np.log(a))
    return rr, kk, vv, wl.astype(np.float32)


def _jax_recurrence(rr, kk, vv, wl, u=None):
    """The JAX decode step iterated over T: (y (B, H, T, Dv), state)."""
    step = jax.jit(JL.gla_step)
    S = jnp.zeros(rr.shape[:2] + (rr.shape[3], vv.shape[3]), jnp.float32)
    ys = []
    for t in range(rr.shape[2]):
        y, S = step(*(jnp.asarray(x[:, :, t]) for x in (rr, kk, vv)),
                    jnp.exp(jnp.asarray(wl[:, :, t])),
                    None if u is None else jnp.asarray(u), S)
        ys.append(np.asarray(y))
    return np.stack(ys, 2), np.asarray(S)


@pytest.mark.parametrize("bonus", [False, True])
def test_gla_step_matches_jax(bonus):
    rr, kk, vv, wl = _gla_inputs(11, None, T=1, H=3, Dk=16, Dv=32)
    r = np.random.default_rng(12)
    u = (0.1 * r.standard_normal((3, 16))).astype(np.float32) if bonus \
        else None
    s0 = r.standard_normal((1, 3, 16, 32)).astype(np.float32)
    args = [x[:, :, 0] for x in (rr, kk, vv)] + [np.exp(wl[:, :, 0])]
    jy, js = JL.gla_step(*(jnp.asarray(x) for x in args),
                         None if u is None else jnp.asarray(u),
                         jnp.asarray(s0))
    state = torch.from_numpy(s0.copy())
    ty, ts = TL.gla_step(*(torch.from_numpy(x) for x in args),
                         None if u is None else torch.from_numpy(u), state,
                         state_out=state)
    assert ts is state and ty.dtype == torch.float32 and ty.shape == (1, 3,
                                                                      32)
    testing.assert_close(ty, jy, "gla_step y")
    testing.assert_close(ts, js, "gla_step state")


@pytest.mark.parametrize("a", [0.9, 0.99])
def test_gla_chunked_matches_jax_at_slow_decay(a):
    """Two 64-step chunks, bf16 r/k/v as the model passes them: the same
    y (in r's type) and fp32 state as the JAX chunked form."""
    rr, kk, vv, wl = _gla_inputs(13, a)
    jargs = [jnp.asarray(x).astype(jnp.bfloat16) for x in (rr, kk, vv)]
    targs = [torch.from_numpy(x).bfloat16() for x in (rr, kk, vv)]
    jy, js = JL.gla_chunked(*jargs, jnp.asarray(wl), None)
    ty, ts = TL.gla_chunked(*targs, torch.from_numpy(wl))
    assert ty.dtype == torch.bfloat16 and ts.dtype == torch.float32
    testing.assert_attention_close(ty, jy, True, f"gla_chunked y at a={a}")
    testing.assert_close(ts, js, f"gla_chunked state at a={a}")


def test_gla_chunked_follows_the_recurrence_where_jax_clips():
    """a = 0.5 (Jamba's decay at init, dt ≈ 0.7 a step): the port equals
    the JAX recurrence; the JAX chunked form parts from it from step 44 of
    each chunk by up to nearly |y| (its clip), and not before."""
    rr, kk, vv, wl = _gla_inputs(14, 0.5)
    yr, sr = _jax_recurrence(rr, kk, vv, wl)
    ty, ts = TL.gla_chunked(*(torch.from_numpy(x) for x in (rr, kk, vv, wl)))
    testing.assert_close(ty, yr, "port vs JAX recurrence: y")
    testing.assert_close(ts, sr, "port vs JAX recurrence: state")
    jy, _ = JL.gla_chunked(*(jnp.asarray(x) for x in (rr, kk, vv, wl)), None)
    gap = np.abs(np.asarray(jy) - yr).max(axis=(0, 1, 3))       # per step
    by_chunk = gap.reshape(-1, 64)
    assert np.all(by_chunk[:, :40] < 1e-4), by_chunk[:, :40].max()
    assert np.all(by_chunk[:, 44:].max(axis=1) > 0.5 * np.abs(yr).max())


# -- one Mamba layer --------------------------------------------------------


def _jax_init(cfg):
    """The JAX ``init_params(cfg, PRNGKey(0))``, traced once (its vmapped
    draws take seconds op by op)."""
    return jax.jit(lambda key: JH.init_params(cfg, key))(
        jax.random.PRNGKey(0))


@functools.lru_cache(maxsize=None)
def weights():
    cfg = jax_config(ARCH).reduced()
    jp = _jax_init(cfg)
    return cfg, jp, params_from_jax(jp, cfg, "cpu")


def test_mamba_layer_matches_jax():
    """Layer 0 of period 0 (the JAX package's cast_stacks slice): a prompt
    from a zero state through the conv cache, then one decode step from
    the prompt's conv tail and state."""
    cfg, jp, tp = weights()
    jm = jax.tree_util.tree_map(lambda a: a[0, 0],
                                JL.cast_stacks(jp["periods"]["mamba"]))
    tm = TL.tree_map(lambda a: a[0, 0], tp["periods"]["mamba"])
    d_in, H, ds = TH._dims(cfg)
    r = np.random.default_rng(15)
    x = r.standard_normal((B, 20, cfg.d_model)).astype(np.float32)
    x1 = r.standard_normal((B, 1, cfg.d_model)).astype(np.float32)
    conv0 = np.zeros((B, TH.CONV_W - 1, d_in), np.float32)
    jmamba = jax.jit(lambda p, x, c, s: JH._mamba(p, cfg, x, conv_cache=c,
                                                  state=s))
    jo, jconv, jst = jmamba(jm, jnp.asarray(x).astype(jnp.bfloat16),
                            jnp.asarray(conv0).astype(jnp.bfloat16), None)
    st = torch.zeros((B, H, ds, cfg.hd))
    to, tconv, tst = TH._mamba(tm, cfg, torch.from_numpy(x).bfloat16(),
                               conv_cache=torch.from_numpy(conv0).bfloat16(),
                               state_out=st)
    assert tst is st and to.dtype == torch.bfloat16
    _close(to, jo, "prompt", atol=testing.LM_ATOL[torch.bfloat16])
    _close(tconv, jconv, "conv tail", atol=testing.LM_ATOL[torch.bfloat16])
    _state_close(tst, jst, "state")
    jo, _, jst = jmamba(jm, jnp.asarray(x1).astype(jnp.bfloat16), jconv,
                        jst)
    to, _, tst = TH._mamba(tm, cfg, torch.from_numpy(x1).bfloat16(),
                           conv_cache=tconv, state=st, state_out=st)
    _close(to, jo, "decode step", atol=testing.LM_ATOL[torch.bfloat16])
    _state_close(tst, jst, "state after the decode step")


# -- the model -------------------------------------------------------------


@contextlib.contextmanager
def fp32_compute():
    saved = (JL.COMPUTE_DTYPE, TL.COMPUTE_DTYPE)
    JL.COMPUTE_DTYPE, TL.COMPUTE_DTYPE = jnp.float32, torch.float32
    try:
        yield
    finally:
        JL.COMPUTE_DTYPE, TL.COMPUTE_DTYPE = saved


def _tokens(cfg, S):
    return np.random.default_rng(S).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)


def _clone(cache):
    return {key: (val.clone() if isinstance(val, torch.Tensor) else val)
            for key, val in cache.items()}


@functools.lru_cache(maxsize=None)
def run(S):
    """forward, prefill and N_NEW − 1 decode steps of both packages on the
    same weights and tokens (the port fed the JAX package's greedy
    tokens), the port following the JAX package's routes."""
    cfg, jp, tp = weights()
    tok = _tokens(cfg, S)
    jtok, ttok = jnp.asarray(tok), torch.from_numpy(tok)
    out = {"decode": []}
    with followed_routes() as (jrecs, flips, own):
        jl = jax.jit(lambda p, t: JH.forward(p, cfg, t))(jp, jtok)
        jax.effects_barrier()
        out["forward"] = (jl, TH.forward(tp, cfg, ttok),
                          route_summary(flips, own))
        jrecs.clear(), flips.clear(), own.clear()
        jpf, jdf = JS.make_serve_fns(cfg, S + N_NEW)
        tpf, tdf = make_serve_fns(cfg, S + N_NEW)
        jl, jc = jpf(jp, jtok)
        jax.effects_barrier()
        tl, tc = tpf(tp, ttok)
        out["prefill"] = (jl, tl, route_summary(flips, own), dict(jc),
                          _clone(tc))
        for _ in range(N_NEW - 1):
            nxt = np.asarray(jnp.argmax(jl[:, -1], -1)).astype(
                np.int32)[:, None]
            jl, jc = jdf(jp, jc, jnp.asarray(nxt))
            jax.effects_barrier()
            tl, tc = tdf(tp, tc, torch.from_numpy(nxt))
            out["decode"].append((jl, tl, route_summary(flips[-8:], own[-8:]),
                                  dict(jc), _clone(tc)))
    return out


def _caches_close(tc, jc, what):
    assert tc["pos"] == int(jc["pos"]), what
    for name in ("k", "v", "conv"):
        assert tuple(tc[name].shape) == jc[name].shape, (what, name)
        _close(tc[name], jc[name], f"{what}: {name}")
    assert tc["state"].dtype == torch.float32
    _state_close(tc["state"], jc["state"], f"{what}: state")


@pytest.mark.parametrize("S", SEQS)
def test_forward_logits_match_jax(S):
    j, t, flips = run(S)["forward"]
    cfg = weights()[0]
    assert t.shape == (B, S, cfg.padded_vocab) and t.dtype == torch.bfloat16
    print(f"forward S={S}: {flips}")
    _close(t, j, "forward logits")


def test_forward_logits_match_jax_in_fp32():
    """COMPUTE_DTYPE fp32 in both packages: only the order of the sums
    differs (the recurrence against the chunked form included)."""
    cfg, jp, _ = weights()
    with fp32_compute():
        tp = params_from_jax(jp, cfg, "cpu")
        tok = _tokens(cfg, SEQS[-1])
        with followed_routes():
            j = jax.jit(lambda p, t: JH.forward(p, cfg, t))(
                jp, jnp.asarray(tok))
            jax.effects_barrier()
            t = TH.forward(tp, cfg, torch.from_numpy(tok))
    assert t.dtype == torch.float32
    _close(t, j, "fp32 forward", atol=testing.RWKV_ATOL[torch.float32][0])


@pytest.mark.parametrize("S", SEQS)
def test_prefill_logits_and_caches_match_jax(S):
    out = run(S)
    cfg = weights()[0]
    j, t, flips, jc, tc = out["prefill"]
    assert t.shape == (B, 1, cfg.padded_vocab)
    print(f"prefill S={S}: {flips}")
    _close(t, j, "prefill logits")
    assert tc["pos"] == S
    assert tc["state"].shape == (4, 3, B, 8, 16, 16)
    _caches_close(tc, jc, "prefill")
    assert not torch.any(tc["k"][:, :, :, S:])


@pytest.mark.parametrize("S", SEQS)
def test_decode_steps_match_jax(S):
    """Every decode step (the Mamba states from the decode kernel's
    recurrence, y in fp32), both fed the same tokens."""
    for t, (j, mine, flips, jc, tc) in enumerate(run(S)["decode"]):
        print(f"decode step {t} S={S}: {flips}")
        _close(mine, j, f"decode step {t}")
        _caches_close(tc, jc, f"after decode step {t}")
        assert tc["pos"] == S + t + 1


def test_long_prefill_matches_jax_token_by_token():
    """S = 128 (two 64-step chunks, past the JAX chunked form's clip at
    this decay): the port's prefill against the JAX model fed one token at
    a time through decode_step — the last logits and every final cache."""
    cfg, jp, tp = weights()
    tok = _tokens(cfg, LONG)
    n_moe = cfg.n_layers // cfg.moe_period
    with followed_routes() as (jrecs, flips, own):
        jc = JH.init_cache(cfg, B, LONG)
        jdec = jax.jit(lambda p, c, t: JH.decode_step(p, cfg, c, t))
        for t in range(LONG):
            jl, jc = jdec(jp, jc, jnp.asarray(tok[:, t:t + 1]))
        jax.effects_barrier()
        # the port's l-th MoE call follows the JAX package's l-th layer
        # over all 128 steps
        steps = list(jrecs)
        jrecs[:] = [tuple(torch.cat([steps[t * n_moe + l][j]
                                     for t in range(LONG)], 1)
                          for j in (0, 1)) for l in range(n_moe)]
        tc = TH.init_cache(cfg, B, LONG, device="cpu")
        tl, tc = TH.prefill(tp, cfg, torch.from_numpy(tok), tc)
        print(f"prefill S={LONG} vs token by token: "
              f"{route_summary(flips, own)}")
    assert len(flips) == n_moe
    _close(tl[:, -1], jl[:, -1], "last logits")
    _caches_close(tc, jc, "final caches")


@pytest.mark.parametrize("S", SEQS)
def test_decode_matches_forward(S):
    """The port's own serve path: prefill + one decode step give the full
    forward's last logits (the 0.25 gate of tests/test_models.py, where
    the JAX package's own jamba case is an expected failure: its chunked
    prefill against its recurrent decode, and router flips).  As the MoE
    serving check on the card: forward's router is held on the served
    run's router input and dispatches the served experts, since bf16
    router logits tie and the two paths' hidden states round apart."""
    cfg, _, tp = weights()
    tok = torch.from_numpy(_tokens(cfg, S))
    nxt = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (B, 1)).astype(np.int32))
    served, flips = [], []
    with TL.route_hook(testing.record_routes(served)):
        cache = TH.init_cache(cfg, B, S + 1, device="cpu")
        _, cache = TH.prefill(tp, cfg, tok, cache)
        ld, cache = TH.decode_step(tp, cfg, cache, nxt)
    assert cache["pos"] == S + 1
    n_moe = len(served) // 2
    targets = [tuple(torch.cat([served[l][j], served[n_moe + l][j]], 1)
                     for j in (0, 1)) for l in range(n_moe)]
    with TL.route_hook(testing.follow_routes(targets, flips)):
        full = TH.forward(tp, cfg, torch.cat([tok, nxt], 1))
    assert len(flips) == n_moe
    err = float(torch.max(torch.abs(ld[:, -1].float() - full[:, -1].float())))
    assert err < 0.25, f"decode/forward mismatch {err}"


@pytest.mark.parametrize("arch", HYBRID_ARCH_IDS)
def test_params_follow_the_jax_tree(arch):
    """The hybrid tree (``periods`` stacks of (P, n, ...)): converted and
    drawn, every ``periods`` leaf in bf16 (the JAX package's cast_stacks of
    the stacked tree), emb and head bf16, final_ln fp32, the converted
    values the JAX masters cast; the registry serves the family."""
    cfg, jp, conv = weights()
    assert get_model(get_config(arch)) is TH
    mine = TH.init_params(get_config(arch).reduced(), device="cpu", seed=2)
    jflat = dict(jax.tree_util.tree_flatten_with_path(jp)[0])
    for tree in (conv, mine):
        flat = dict(jax.tree_util.tree_flatten_with_path(tree)[0])
        assert flat.keys() == jflat.keys()
        for path, t in flat.items():
            assert tuple(t.shape) == jflat[path].shape, path
            low = path[0].key in ("periods", "emb", "head")
            assert t.dtype == (torch.bfloat16 if low else torch.float32), path
    for name in ("ln", "D", "conv_w"):
        assert torch.equal(conv["periods"]["mamba"][name].float(),
                           torch.tensor(np.asarray(
                               jp["periods"]["mamba"][name])).to(
                                   torch.bfloat16).float()), name
    assert float(mine["periods"]["mamba"]["D"].float().min()) == 1.0
    with pytest.raises(ValueError, match="whole periods"):
        TH.init_params(dataclasses.replace(cfg, n_layers=6), device="cpu")
