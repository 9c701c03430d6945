"""The port's VLM frontend against the JAX package on the CPU:
internvl2-76b at ``reduced()`` size (4 layers, d_model 64, 8 patch
embeddings prepended): weights from the JAX ``init_params(cfg,
PRNGKey(0))`` through ``convert.params_from_jax``, tokens and patch
embeddings drawn with NumPy; ``forward`` logits over patches and tokens,
``prefill`` logits and the filled cache (``frontend_tokens`` more slots,
``pos`` = patches + prompt), every ``decode_step``'s logits (rope positions
counting the patches) and ``greedy_generate(embeds=)`` tokens under the
near-tie rule; the port's own decode-vs-forward consistency (as
``tests/test_models.py``).

Tolerance: ``repro_torch.testing.LM_ATOL`` — bf16 logits and caches
within 0.125 (the dense family's bound: the VLM is that transformer).
Greedy tokens: ``testing.tokens_agree`` with the same bound.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models import transformer as JT
from repro.serve import serve_step as JS
from repro_torch import testing
from repro_torch.configs import VLM_ARCH_IDS, get_config
from repro_torch.convert import params_from_jax
from repro_torch.models import get_model
from repro_torch.models import transformer as TT
from repro_torch.serve import greedy_generate, make_serve_fns

B, S, N_NEW = 2, 16, 6
TOL = testing.LM_ATOL[torch.bfloat16]


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


@functools.lru_cache(maxsize=None)
def run(arch):
    """forward, the greedy loop through each package's serve fns (the port
    fed the JAX package's tokens) and the port's greedy_generate, on the
    same weights, tokens and patch embeddings."""
    cfg = jax_config(arch).reduced()
    F = cfg.frontend_tokens
    jp = JT.init_params(cfg, jax.random.PRNGKey(0))
    tp = params_from_jax(jp, cfg, "cpu")
    r = np.random.default_rng(4)
    tok = r.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    emb = (0.02 * r.standard_normal((B, F, cfg.d_model))).astype(np.float32)
    jtok, ttok = jnp.asarray(tok), torch.from_numpy(tok)
    jemb, temb = jnp.asarray(emb), torch.from_numpy(emb)
    out = {"cfg": cfg, "params": tp, "inputs": (ttok, temb)}
    out["forward"] = (
        jax.jit(lambda p, t, e: JT.forward(p, cfg, t, embeds=e))(
            jp, jtok, jemb),
        TT.forward(tp, cfg, ttok, embeds=temb))
    jpf, jdf = JS.make_serve_fns(cfg, S + N_NEW)
    tpf, tdf = make_serve_fns(cfg, S + N_NEW)
    jl, jc = jpf(jp, jtok, jemb)
    tl, tc = tpf(tp, ttok, temb)
    out["prefill"] = (jl, tl)
    out["cache"] = ((jc["k"], jc["v"], int(jc["pos"])),
                    (tc["k"].clone(), tc["v"].clone(), tc["pos"]))
    steps, toks, decode = [_np(jl[:, -1])], [np.asarray(
        jnp.argmax(jl[:, -1], -1))], []
    for _ in range(N_NEW - 1):
        nxt = toks[-1].astype(np.int32)[:, None]
        jl, jc = jdf(jp, jc, jnp.asarray(nxt))
        tl, tc = tdf(tp, tc, torch.tensor(nxt))
        decode.append((_np(jl), _np(tl), int(jc["pos"]), tc["pos"]))
        steps.append(_np(jl[:, -1]))
        toks.append(np.asarray(jnp.argmax(jl[:, -1], -1)))
    out["decode"] = decode
    out["greedy"] = (np.stack(toks, 1), np.stack(steps, 1),
                     greedy_generate(cfg, tp, ttok, N_NEW, embeds=temb))
    return out


@pytest.mark.parametrize("arch", VLM_ARCH_IDS)
def test_forward_logits_match_jax(arch):
    j, t = run(arch)["forward"]
    cfg = run(arch)["cfg"]
    assert cfg.frontend_tokens == 8
    assert t.shape == (B, cfg.frontend_tokens + S, cfg.padded_vocab)
    assert t.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(t), _np(j), rtol=0, atol=TOL)


@pytest.mark.parametrize("arch", VLM_ARCH_IDS)
def test_prefill_logits_and_cache_match_jax(arch):
    out = run(arch)
    cfg, F = out["cfg"], out["cfg"].frontend_tokens
    j, t = out["prefill"]
    assert t.shape == (B, 1, cfg.padded_vocab)
    np.testing.assert_allclose(_np(t), _np(j), rtol=0, atol=TOL)
    (jk, jv, jpos), (tk, tv, tpos) = out["cache"]
    assert tpos == jpos == F + S
    assert tk.shape == jk.shape == (cfg.n_layers, B, cfg.n_kv_heads,
                                    F + S + N_NEW, cfg.hd)
    np.testing.assert_allclose(_np(tk), _np(jk), rtol=0, atol=TOL)
    np.testing.assert_allclose(_np(tv), _np(jv), rtol=0, atol=TOL)
    assert not torch.any(tk[:, :, :, F + S:]) and not torch.any(
        tv[:, :, :, F + S:])


@pytest.mark.parametrize("arch", VLM_ARCH_IDS)
def test_decode_step_logits_match_jax(arch):
    """Every decode step of the greedy loop, both fed the same tokens, at
    positions after the patches."""
    F = run(arch)["cfg"].frontend_tokens
    for t, (j, mine, jpos, tpos) in enumerate(run(arch)["decode"]):
        assert tpos == jpos == F + S + t + 1
        np.testing.assert_allclose(mine, j, rtol=0, atol=TOL,
                                   err_msg=f"decode step {t}")


@pytest.mark.parametrize("arch", VLM_ARCH_IDS)
def test_greedy_generate_with_embeds_matches_jax(arch):
    jtok, jlogits, ttok = run(arch)["greedy"]
    assert ttok.shape == (B, N_NEW) and ttok.dtype == torch.int32
    ok, _ = testing.tokens_agree(ttok, jtok, jlogits, TOL)
    assert ok, (ttok, jtok)


@pytest.mark.parametrize("arch", VLM_ARCH_IDS)
def test_decode_matches_forward(arch):
    """The port's own serve path: prefill over patches and prompt + one
    decode step give the full forward's last logits (the 0.25 gate of
    tests/test_models.py); the registry serves the family."""
    out = run(arch)
    cfg, tp = out["cfg"], out["params"]
    assert get_model(cfg) is TT and get_config(arch).family == "vlm"
    tok, emb = out["inputs"]
    nxt = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (B, 1)).astype(np.int32))
    cache = TT.init_cache(cfg, B, cfg.frontend_tokens + S + 1, device="cpu")
    _, cache = TT.prefill(tp, cfg, tok, cache, embeds=emb)
    ld, cache = TT.decode_step(tp, cfg, cache, nxt)
    assert cache["pos"] == cfg.frontend_tokens + S + 1
    full = TT.forward(tp, cfg, torch.cat([tok, nxt], 1), embeds=emb)
    err = float(torch.max(torch.abs(ld[:, -1].float() - full[:, -1].float())))
    assert err < 0.25, f"{arch}: decode/forward mismatch {err}"
