"""The port's dense transformer and LM serving against the JAX package on
the CPU, for the four dense configurations at ``reduced()`` size: weights
from the JAX ``init_params(cfg, PRNGKey(0))`` through
``convert.params_from_jax``, tokens drawn with NumPy; ``forward`` logits,
``prefill`` logits and the filled cache, ``decode_step`` logits and
``greedy_generate`` tokens (under the near-tie rule), in the model's bf16
and, with ``COMPUTE_DTYPE`` set to fp32 in both packages (fp32 caches),
in fp32; the port's own decode-vs-forward consistency (as
``tests/test_models.py``); the configuration copies (RWKV-6's too), the
synthetic data, the serving parameters, and what is not ported yet (the
MoE members are held in ``tests/test_torch_moe.py``).

Tolerance: ``repro_torch.testing.LM_ATOL`` — bf16 logits and caches
within 0.125 (the frameworks' bf16 matmuls round at different places;
measured ≤ 0.0625), fp32 within 1e-4 (sums in another order; measured
≤ 4.2e-6).  Greedy tokens: ``testing.tokens_agree`` with the same bound.
"""
import contextlib
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.data import pipeline as jpipe
from repro.models import layers as JL
from repro.models import transformer as JT
from repro.serve import serve_step as JS
from repro_torch import testing
from repro_torch.configs import (ARCH_IDS, DENSE_ARCH_IDS, PORTED_ARCH_IDS,
                                  get_config)
from repro_torch.configs.base import SHAPES, ShapeConfig
from repro_torch.convert import params_from_jax
from repro_torch.data import pipeline as tpipe
from repro_torch.models import get_model
from repro_torch.models import layers as TL
from repro_torch.models import transformer as TT
from repro_torch.serve import greedy_generate, make_serve_fns

B, S, N_NEW = 2, 16, 6
MODES = {"bf16": (torch.bfloat16, jnp.bfloat16),
         "fp32": (torch.float32, jnp.float32)}


@contextlib.contextmanager
def compute_dtype(mode):
    """Both packages' COMPUTE_DTYPE and cache dtype for the duration (read
    at call time)."""
    tdt, jdt = MODES[mode]
    saved = (JL.COMPUTE_DTYPE, TL.COMPUTE_DTYPE, JT.init_cache,
             TT.init_cache)
    TL.COMPUTE_DTYPE, JL.COMPUTE_DTYPE = tdt, jdt
    JT.init_cache = functools.partial(saved[2], dtype=jdt)
    TT.init_cache = functools.partial(saved[3], dtype=tdt)
    try:
        yield
    finally:
        (JL.COMPUTE_DTYPE, TL.COMPUTE_DTYPE, JT.init_cache,
         TT.init_cache) = saved


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


@functools.lru_cache(maxsize=None)
def run(arch, mode):
    """Every output both packages give for one configuration and mode: the
    forward logits, and the greedy loop through each package's serve fns
    (prefill logits and cache, then each decode step's logits, the port
    fed the JAX package's tokens), and the port's greedy_generate."""
    cfg = jax_config(arch).reduced()
    out = {"cfg": cfg}
    with compute_dtype(mode):
        jp = JT.init_params(cfg, jax.random.PRNGKey(0))
        tp = params_from_jax(jp, cfg, "cpu")
        tok = np.random.default_rng(1).integers(
            0, cfg.vocab_size, (B, S)).astype(np.int32)
        jtok, ttok = jnp.asarray(tok), torch.from_numpy(tok)
        # a fresh closure, so no trace of the other mode is reused
        jfwd = jax.jit(lambda p, t: JT.forward(p, cfg, t))
        out["forward"] = (jfwd(jp, jtok), TT.forward(tp, cfg, ttok))
        jpf, jdf = JS.make_serve_fns(cfg, S + N_NEW)
        tpf, tdf = make_serve_fns(cfg, S + N_NEW)
        jl, jc = jpf(jp, jtok)
        tl, tc = tpf(tp, ttok)
        out["prefill"] = (jl, tl)
        out["cache"] = ((jc["k"], jc["v"], int(jc["pos"])),
                        (tc["k"].clone(), tc["v"].clone(), tc["pos"]))
        steps, toks = [_np(jl[:, -1])], [np.asarray(jnp.argmax(jl[:, -1], -1))]
        decode = []
        for _ in range(N_NEW - 1):
            nxt = toks[-1].astype(np.int32)[:, None]
            jl, jc = jdf(jp, jc, jnp.asarray(nxt))
            tl, tc = tdf(tp, tc, torch.tensor(nxt))
            decode.append((_np(jl), _np(tl)))
            steps.append(_np(jl[:, -1]))
            toks.append(np.asarray(jnp.argmax(jl[:, -1], -1)))
        out["decode"] = decode
        out["greedy"] = (np.stack(toks, 1), np.stack(steps, 1),
                         greedy_generate(cfg, tp, ttok, N_NEW))
        out["params"] = tp
        out["tokens"] = (ttok, torch.tensor(toks[0][:, None]))
    return out


CASES = [(a, m) for a in DENSE_ARCH_IDS for m in MODES]


@pytest.mark.parametrize("arch,mode", CASES)
def test_forward_logits_match_jax(arch, mode):
    j, t = run(arch, mode)["forward"]
    cfg = run(arch, mode)["cfg"]
    assert t.shape == (B, S, cfg.padded_vocab) and t.dtype == MODES[mode][0]
    np.testing.assert_allclose(t.float().numpy(), _np(j), rtol=0,
                               atol=testing.LM_ATOL[MODES[mode][0]])


@pytest.mark.parametrize("arch,mode", CASES)
def test_prefill_logits_and_cache_match_jax(arch, mode):
    out = run(arch, mode)
    tol = testing.LM_ATOL[MODES[mode][0]]
    j, t = out["prefill"]
    assert t.shape == (B, 1, out["cfg"].padded_vocab)
    np.testing.assert_allclose(t.float().numpy(), _np(j), rtol=0, atol=tol)
    (jk, jv, jpos), (tk, tv, tpos) = out["cache"]
    assert tpos == jpos == S and tk.shape == jk.shape == (
        out["cfg"].n_layers, B, out["cfg"].n_kv_heads, S + N_NEW,
        out["cfg"].hd)
    np.testing.assert_allclose(tk.float().numpy(), _np(jk), rtol=0, atol=tol)
    np.testing.assert_allclose(tv.float().numpy(), _np(jv), rtol=0, atol=tol)
    assert not torch.any(tk[:, :, :, S:]) and not torch.any(tv[:, :, :, S:])


@pytest.mark.parametrize("arch,mode", CASES)
def test_decode_step_logits_match_jax(arch, mode):
    """Every decode step of the greedy loop, both fed the same tokens."""
    for t, (j, mine) in enumerate(run(arch, mode)["decode"]):
        np.testing.assert_allclose(mine, j, rtol=0,
                                   atol=testing.LM_ATOL[MODES[mode][0]],
                                   err_msg=f"decode step {t}")


@pytest.mark.parametrize("arch,mode", CASES)
def test_greedy_generate_matches_jax(arch, mode):
    out = run(arch, mode)
    jtok, jlogits, ttok = out["greedy"]
    assert ttok.shape == (B, N_NEW) and ttok.dtype == torch.int32
    ok, _ = testing.tokens_agree(ttok, jtok, jlogits,
                                 testing.LM_ATOL[MODES[mode][0]])
    assert ok, (ttok, jtok)


@pytest.mark.parametrize("arch", DENSE_ARCH_IDS)
def test_decode_matches_forward(arch):
    """The port's own serve path: prefill + one decode step give the full
    forward's last logits (the 0.25 gate of tests/test_models.py)."""
    out = run(arch, "bf16")
    cfg, tp = out["cfg"], out["params"]
    tok, nxt = out["tokens"]
    cache = TT.init_cache(cfg, B, S + 1, device="cpu")
    _, cache = TT.prefill(tp, cfg, tok, cache)
    ld, cache = TT.decode_step(tp, cfg, cache, nxt)
    assert cache["pos"] == S + 1
    full = TT.forward(tp, cfg, torch.cat([tok, nxt], 1))
    err = float(torch.max(torch.abs(ld[:, -1].float() - full[:, -1].float())))
    assert err < 0.25, f"{arch}: decode/forward mismatch {err}"


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_config_copies_match_jax(arch):
    if arch not in PORTED_ARCH_IDS:
        with pytest.raises(NotImplementedError, match="queue 1 item 14"):
            get_config(arch)
        return
    mine, theirs = get_config(arch), jax_config(arch)
    assert dataclasses.asdict(mine) == dataclasses.asdict(theirs)
    assert dataclasses.asdict(mine.reduced()) == dataclasses.asdict(
        theirs.reduced())
    assert (mine.param_count(), mine.padded_vocab, mine.hd) == (
        theirs.param_count(), theirs.padded_vocab, theirs.hd)


def test_unknown_arch_is_a_key_error():
    with pytest.raises(KeyError):
        get_config("no-such-arch")


def test_unported_families_and_modes_raise():
    cfg = get_config("qwen3-8b").reduced()
    for fam in ("vlm", "hybrid", "encdec"):
        with pytest.raises(NotImplementedError, match="queue 1 item 14"):
            get_model(dataclasses.replace(cfg, family=fam))
    p = TT.init_params(cfg, device="cpu")
    pl = {key: val[0] for key, val in p["attn"].items()}
    x = torch.zeros((1, 3, cfg.d_model), dtype=torch.bfloat16)
    with pytest.raises(NotImplementedError, match="encoder-decoder"):
        TL.attention(pl, x, cfg, mode="cross_decode")
    with pytest.raises(NotImplementedError, match="encoder-decoder"):
        TL.attention(pl, x, cfg, kv_src=x)
    with pytest.raises(NotImplementedError, match="VLM"):
        TT.forward(p, cfg, torch.zeros((1, 3), dtype=torch.int32),
                   embeds=torch.zeros((1, 2, cfg.d_model)))


def test_serving_params_are_cast_once():
    """The port's own init_params: the JAX tree's shapes, stacks / emb /
    head in bf16, norm scales fp32, the same draw for the same seed."""
    cfg = get_config("gemma-2b").reduced()
    p = TT.init_params(cfg, device="cpu", seed=3)
    jp = JT.init_params(cfg, jax.random.PRNGKey(0))
    flat = {(g, key): val for g, sub in p.items()
            for key, val in (sub.items() if isinstance(sub, dict)
                             else [("", sub)])}
    jflat = {(g, key): val for g, sub in jp.items()
             for key, val in (sub.items() if isinstance(sub, dict)
                              else [("", sub)])}
    assert flat.keys() == jflat.keys()
    for name, t in flat.items():
        assert tuple(t.shape) == jflat[name].shape, name
        low = t.dim() >= 3 or name[0] in ("emb", "head")
        assert t.dtype == (torch.bfloat16 if low else torch.float32), name
    again = TT.init_params(cfg, device="cpu", seed=3)
    assert all(torch.equal(again["attn"][key], val)
               for key, val in p["attn"].items())
    conv = params_from_jax(jp, cfg, "cpu")
    assert conv["mlp"]["w_up"].dtype == torch.bfloat16
    assert torch.equal(conv["mlp"]["w_up"].float(), torch.tensor(
        np.asarray(jp["mlp"]["w_up"])).to(torch.bfloat16).float())
    assert conv["final_ln"].dtype == torch.float32


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs there")
    cfg = get_config("qwen3-8b").reduced()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TT.init_params(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TT.init_cache(cfg, 1, 8)


def test_serve_fns_run_on_the_params_device():
    out = run("qwen3-8b", "bf16")
    cfg, tp = out["cfg"], out["params"]
    tok, _ = out["tokens"]
    pf, df = make_serve_fns(cfg, S + 2)
    lg, cache = pf(tp, tok)
    assert cache["k"].device.type == "cpu" and cache["pos"] == S
    assert cache["k"].shape == (cfg.n_layers, B, cfg.n_kv_heads, S + 2,
                                cfg.hd)
    _, cache = df(tp, cache, torch.argmax(lg[:, -1], -1).int()[:, None])
    assert cache["pos"] == S + 1


@pytest.mark.parametrize("seq_len,batch,seed,step", [(37, 3, 0, 0),
                                                     (64, 2, 5, 7)])
def test_synthetic_lm_matches_jax(seq_len, batch, seed, step):
    dc = dict(vocab_size=1000, seq_len=seq_len, global_batch=batch,
              seed=seed)
    mine = tpipe.SyntheticLM(tpipe.DataConfig(**dc), "cpu").batch(step)
    theirs = jpipe.SyntheticLM(jpipe.DataConfig(**dc)).batch(step)
    assert mine["tokens"].dtype == torch.int32
    np.testing.assert_array_equal(mine["tokens"].numpy(),
                                  np.asarray(theirs["tokens"]))
    cfg = get_config("qwen3-8b")
    shape = ShapeConfig("cell", seq_len, batch, "prefill")
    np.testing.assert_array_equal(
        tpipe.batch_for(cfg, shape, seed, step, "cpu")["tokens"].numpy(),
        np.asarray(jpipe.batch_for(jax_config("qwen3-8b"), shape, seed,
                                   step)["tokens"]))
    assert SHAPES["prefill_32k"].seq_len == 32_768
