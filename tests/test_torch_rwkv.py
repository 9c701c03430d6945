"""The port's RWKV-6 and its LM serving against the JAX package on the CPU,
rwkv6-1.6b at ``reduced()`` size (4 layers, d_model 64, 4 heads × 16):
weights from the JAX ``init_params(cfg, PRNGKey(0))`` through
``convert.params_from_jax``, tokens drawn with NumPy; ``forward`` logits,
``prefill`` logits with the WKV state and both shift caches,
``decode_step`` logits and state at every step, and ``greedy_generate``
tokens (under the near-tie rule), at S = 16 (one padded chunk of the JAX
package's chunked form) and S = 80 (two, the second ragged), in the model's
bf16 and, with ``COMPUTE_DTYPE`` set to fp32 in both packages (fp32 shift
caches), in fp32; the port's own decode-vs-forward consistency (as
``tests/test_models.py``); the converted and the drawn parameters' dtypes;
and the registry.

The JAX package runs prefill through ``layers.gla_chunked`` and decode
through ``layers.gla_step``; the port runs both through ``ops.wkv6``.

Tolerance: ``repro_torch.testing.RWKV_ATOL`` — bf16 logits within 0.5 and
the fp32 WKV state within 5% of its largest value (the two frameworks'
bf16 matmuls round at other places, and this model amplifies it more than
the dense family: measured ≤ 0.2421875 and ≤ 1.63%), fp32 logits within
1e-4 and the state within 1e-5 of its largest value (measured ≤ 9.9e-6
and ≤ 8.2e-7).  Greedy tokens: ``testing.tokens_agree`` with the logit
bound.
"""
import contextlib
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models import layers as JL
from repro.models import rwkv as JR
from repro.serve import serve_step as JS
from repro_torch import testing
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax
from repro_torch.models import get_model
from repro_torch.models import layers as TL
from repro_torch.models import rwkv as TR
from repro_torch.serve import greedy_generate, make_serve_fns

ARCH = "rwkv6-1.6b"
B, N_NEW = 2, 6
SEQS = (16, 80)
MODES = {"bf16": (torch.bfloat16, jnp.bfloat16),
         "fp32": (torch.float32, jnp.float32)}
CASES = [(s, m) for s in SEQS for m in MODES]


@contextlib.contextmanager
def compute_dtype(mode):
    """Both packages' COMPUTE_DTYPE and shift-cache dtype for the duration
    (read at call time)."""
    tdt, jdt = MODES[mode]
    saved = (JL.COMPUTE_DTYPE, TL.COMPUTE_DTYPE, JR.init_cache,
             TR.init_cache)
    TL.COMPUTE_DTYPE, JL.COMPUTE_DTYPE = tdt, jdt
    JR.init_cache = functools.partial(saved[2], dtype=jdt)
    TR.init_cache = functools.partial(saved[3], dtype=tdt)
    try:
        yield
    finally:
        (JL.COMPUTE_DTYPE, TL.COMPUTE_DTYPE, JR.init_cache,
         TR.init_cache) = saved


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _logits_close(mine, theirs, mode, what):
    np.testing.assert_allclose(_np(mine), _np(theirs), rtol=0,
                               atol=testing.RWKV_ATOL[MODES[mode][0]][0],
                               err_msg=what)


def _state_close(mine, theirs, mode, what):
    scale = float(np.abs(_np(theirs)).max())
    np.testing.assert_allclose(
        _np(mine), _np(theirs), rtol=0,
        atol=testing.RWKV_ATOL[MODES[mode][0]][1] * scale, err_msg=what)


@functools.lru_cache(maxsize=None)
def run(S, mode):
    """Every output both packages give for one prompt length and mode: the
    forward logits, and the greedy loop through each package's serve fns
    (prefill logits and cache, then each decode step's logits and state,
    the port fed the JAX package's tokens), and the port's
    greedy_generate."""
    cfg = jax_config(ARCH).reduced()
    out = {"cfg": cfg}
    with compute_dtype(mode):
        jp = JR.init_params(cfg, jax.random.PRNGKey(0))
        tp = params_from_jax(jp, cfg, "cpu")
        tok = np.random.default_rng(S).integers(
            0, cfg.vocab_size, (B, S)).astype(np.int32)
        jtok, ttok = jnp.asarray(tok), torch.from_numpy(tok)
        # a fresh closure, so no trace of the other mode is reused
        jfwd = jax.jit(lambda p, t: JR.forward(p, cfg, t))
        out["forward"] = (jfwd(jp, jtok), TR.forward(tp, cfg, ttok))
        jpf, jdf = JS.make_serve_fns(cfg, S + N_NEW)
        tpf, tdf = make_serve_fns(cfg, S + N_NEW)
        jl, jc = jpf(jp, jtok)
        tl, tc = tpf(tp, ttok)
        out["prefill"] = (jl, tl)
        out["cache"] = ({key: val for key, val in jc.items()},
                        {key: (val.clone() if key != "pos" else val)
                         for key, val in tc.items()})
        steps, toks = [_np(jl[:, -1])], [np.asarray(jnp.argmax(jl[:, -1], -1))]
        decode = []
        for _ in range(N_NEW - 1):
            nxt = toks[-1].astype(np.int32)[:, None]
            jl, jc = jdf(jp, jc, jnp.asarray(nxt))
            tl, tc = tdf(tp, tc, torch.tensor(nxt))
            decode.append((_np(jl), _np(tl), np.asarray(jc["state"]),
                           tc["state"].clone()))
            steps.append(_np(jl[:, -1]))
            toks.append(np.asarray(jnp.argmax(jl[:, -1], -1)))
        out["decode"] = decode
        out["greedy"] = (np.stack(toks, 1), np.stack(steps, 1),
                         greedy_generate(cfg, tp, ttok, N_NEW))
        out["params"] = (jp, tp)
        out["tokens"] = (ttok, torch.tensor(toks[0][:, None]))
    return out


@pytest.mark.parametrize("S,mode", CASES)
def test_forward_logits_match_jax(S, mode):
    out = run(S, mode)
    j, t = out["forward"]
    assert t.shape == (B, S, out["cfg"].padded_vocab)
    assert t.dtype == MODES[mode][0]
    _logits_close(t, j, mode, "forward logits")


@pytest.mark.parametrize("S,mode", CASES)
def test_prefill_logits_and_cache_match_jax(S, mode):
    out = run(S, mode)
    cfg = out["cfg"]
    j, t = out["prefill"]
    assert t.shape == (B, 1, cfg.padded_vocab)
    _logits_close(t, j, mode, "prefill logits")
    jc, tc = out["cache"]
    assert tc["pos"] == int(jc["pos"]) == S
    assert tc["state"].shape == (cfg.n_layers, B, cfg.n_heads,
                                 cfg.rwkv_head_dim, cfg.rwkv_head_dim)
    assert tc["state"].dtype == torch.float32
    _state_close(tc["state"], jc["state"], mode, "WKV state")
    for key in ("shift_t", "shift_c"):
        assert tc[key].shape == (cfg.n_layers, B, 1, cfg.d_model)
        assert tc[key].dtype == MODES[mode][0]
        _logits_close(tc[key], jc[key], mode, key)


@pytest.mark.parametrize("S,mode", CASES)
def test_decode_step_logits_and_state_match_jax(S, mode):
    """Every decode step of the greedy loop, both fed the same tokens."""
    for t, (j, mine, jst, tst) in enumerate(run(S, mode)["decode"]):
        _logits_close(mine, j, mode, f"decode step {t}")
        _state_close(tst, jst, mode, f"WKV state after decode step {t}")


@pytest.mark.parametrize("S,mode", CASES)
def test_greedy_generate_matches_jax(S, mode):
    jtok, jlogits, ttok = run(S, mode)["greedy"]
    assert ttok.shape == (B, N_NEW) and ttok.dtype == torch.int32
    ok, _ = testing.tokens_agree(ttok, jtok, jlogits,
                                 testing.RWKV_ATOL[MODES[mode][0]][0])
    assert ok, (ttok, jtok)


@pytest.mark.parametrize("S", SEQS)
def test_decode_matches_forward(S):
    """The port's own serve path: prefill + one decode step give the full
    forward's last logits (the 0.25 gate of tests/test_models.py)."""
    out = run(S, "bf16")
    cfg, (_, tp) = out["cfg"], out["params"]
    tok, nxt = out["tokens"]
    cache = TR.init_cache(cfg, B, S + 1, device="cpu")
    _, cache = TR.prefill(tp, cfg, tok, cache)
    ld, cache = TR.decode_step(tp, cfg, cache, nxt)
    assert cache["pos"] == S + 1
    full = TR.forward(tp, cfg, torch.cat([tok, nxt], 1))
    err = float(torch.max(torch.abs(ld[:, -1].float() - full[:, -1].float())))
    assert err < 0.25, f"decode/forward mismatch {err}"


def test_converted_leaves_are_cast_as_cast_stacks_casts():
    """Every leaf of params_from_jax: the stacks of ndim ≥ 3 (mu, mu_c, u,
    the projections, w_decay_a/b) in bf16 with the bits of a bf16 cast,
    emb and head in bf16, ln1 / ln2 / w0 / wkv_ln / final_ln in fp32."""
    jp, tp = run(16, "bf16")["params"]
    flat = {(g, key): val for g, sub in tp.items()
            for key, val in (sub.items() if isinstance(sub, dict)
                             else [("", sub)])}
    jflat = {(g, key): val for g, sub in jp.items()
             for key, val in (sub.items() if isinstance(sub, dict)
                              else [("", sub)])}
    assert flat.keys() == jflat.keys()
    fp32 = {("blocks", "ln1"), ("blocks", "ln2"), ("blocks", "w0"),
            ("blocks", "wkv_ln"), ("final_ln", "")}
    for name, t in flat.items():
        jx = np.asarray(jflat[name])
        assert tuple(t.shape) == jx.shape, name
        assert t.dtype == (torch.float32 if name in fp32
                           else torch.bfloat16), name
        assert (jx.ndim >= 3 or name[0] in ("emb", "head")) == (
            name not in fp32), name
        assert torch.equal(t, torch.from_numpy(jx.copy()).to(t.dtype)), name


def test_serving_params_are_cast_once():
    """The port's own init_params: the JAX tree's shapes and dtypes after
    the cast, the constant leaves' values, the same draw for the same
    seed."""
    cfg = get_config(ARCH).reduced()
    p = TR.init_params(cfg, device="cpu", seed=3)
    _, conv = run(16, "bf16")["params"]
    for g, sub in conv.items():
        mine = p[g]
        if isinstance(sub, dict):
            assert mine.keys() == sub.keys()
            for key, val in sub.items():
                assert mine[key].shape == val.shape, key
                assert mine[key].dtype == val.dtype, key
        else:
            assert mine.shape == sub.shape and mine.dtype == sub.dtype
    blocks = p["blocks"]
    assert torch.all(blocks["w0"] == -6.0) and torch.all(blocks["mu"] == 0.5)
    assert torch.all(blocks["u"] == torch.tensor(0.1).to(torch.bfloat16))
    again = TR.init_params(cfg, device="cpu", seed=3)
    assert all(torch.equal(again["blocks"][key], val)
               for key, val in blocks.items())


def test_registry_and_serve_fns_run_rwkv():
    out = run(16, "bf16")
    cfg, (_, tp) = out["cfg"], out["params"]
    assert get_model(cfg) is TR
    tok, _ = out["tokens"]
    pf, df = make_serve_fns(cfg, 16 + 2)
    lg, cache = pf(tp, tok)
    assert cache["state"].device.type == "cpu" and cache["pos"] == 16
    st = cache["state"]
    _, cache = df(tp, cache, torch.argmax(lg[:, -1], -1).int()[:, None])
    assert cache["pos"] == 17 and cache["state"] is st    # in place


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs there")
    cfg = get_config(ARCH).reduced()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TR.init_params(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TR.init_cache(cfg, 1, 8)
