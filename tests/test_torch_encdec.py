"""The port's encoder-decoder family and the attention modes it needs,
against the JAX package on the CPU.

Attention alone (``layers.attention``, one layer of JAX weights): the
non-causal encoder self-attention, self-attention without rope, the
cross-attention prefill from a ``kv_src`` into a longer cache (its first
S_src slots written, the rest left zero) and ``cross_decode`` under a
``kv_valid_len`` below the cache's length; the cross block's parameters
have no q/k norms.  The model: whisper-tiny at ``reduced()`` size (2
encoder and 4 decoder layers, d_model 64) on ``convert.params_from_jax``
weights, 40 frame embeddings and 8 tokens drawn with NumPy: ``encode``,
``forward``, ``prefill`` (the self and cross caches, ``enc_len`` and
``pos`` exact) with a cache of 48 slots, longer than the frames, every
``decode_step`` and ``greedy_generate(embeds=)`` under the near-tie rule;
the encoder's position table tiled past its 8,192 rows (the encoder with
no layers, so the table alone); too many frames for the cross cache
raise.

Tolerance: ``repro_torch.testing.LM_ATOL`` — bf16 logits, encoder
outputs and caches within 0.125; attention outputs alone within
``testing.BF16_RTOL`` / ``ATOL`` (one bf16 ulp beyond the fp32 checks).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models import encdec as JE
from repro.models import layers as JL
from repro.serve import serve_step as JS
from repro_torch import testing
from repro_torch.configs import ENCDEC_ARCH_IDS, get_config
from repro_torch.convert import params_from_jax
from repro_torch.models import encdec as TE
from repro_torch.models import get_model
from repro_torch.models import layers as TL
from repro_torch.serve import greedy_generate, make_serve_fns

ARCH = "whisper-tiny"
B, S, FRAMES, CACHE, N_NEW = 2, 8, 40, 48, 6
TOL = testing.LM_ATOL[torch.bfloat16]


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _bf16(a):
    return jnp.asarray(a).astype(jnp.bfloat16), torch.from_numpy(a).bfloat16()


# -- the attention modes alone -------------------------------------------


def _layer(cfg, cross: bool, seed: int):
    """One attention layer's weights for both packages."""
    stack = JL.attention_params(jax.random.PRNGKey(seed), cfg, 1,
                                cross=cross)
    jl = jax.tree_util.tree_map(lambda a: a[0], JL.cast_stacks(stack))
    tl = {key: val[0] for key, val in
          params_from_jax({"attn": stack}, cfg, "cpu")["attn"].items()}
    return jl, tl


def _close(mine, theirs, what):
    testing.assert_attention_close(mine, theirs, True, what)


@pytest.mark.parametrize("causal,use_rope", [(False, True), (True, False),
                                             (False, False)])
def test_self_attention_modes_match_jax(causal, use_rope):
    cfg = jax_config(ARCH).reduced()
    jl, tl = _layer(cfg, False, 1)
    jx, tx = _bf16(np.random.default_rng(5).standard_normal(
        (B, 24, cfg.d_model)).astype(np.float32))
    j, _ = JL.attention(jl, jx, cfg, mode="train", causal=causal,
                        use_rope=use_rope)
    t, _ = TL.attention(tl, tx, cfg, mode="train", causal=causal,
                        use_rope=use_rope)
    _close(t, j, f"causal={causal} use_rope={use_rope}")


def test_cross_prefill_writes_the_cache_and_matches_jax():
    cfg = jax_config(ARCH).reduced()
    jl, tl = _layer(cfg, True, 2)
    r = np.random.default_rng(6)
    jx, tx = _bf16(r.standard_normal((B, 5, cfg.d_model)).astype(np.float32))
    js, ts = _bf16(r.standard_normal((B, 30, cfg.d_model)).astype(np.float32))
    shape = (B, cfg.n_kv_heads, 36, cfg.hd)
    jc = {"k": jnp.zeros(shape, jnp.bfloat16),
          "v": jnp.zeros(shape, jnp.bfloat16)}
    tc = {"k": torch.zeros(shape, dtype=torch.bfloat16),
          "v": torch.zeros(shape, dtype=torch.bfloat16)}
    j, jc = JL.attention(jl, jx, cfg, mode="prefill", kv_src=js, cache=jc,
                         cache_pos=0)
    t, tc2 = TL.attention(tl, tx, cfg, mode="prefill", kv_src=ts, cache=tc,
                          cache_pos=0)
    assert tc2 is tc                                       # in place
    _close(t, j, "cross prefill")
    for name in ("k", "v"):
        np.testing.assert_allclose(_np(tc[name]), _np(jc[name]), rtol=0,
                                   atol=TOL, err_msg=name)
        assert not torch.any(tc[name][:, :, 30:])


def test_cross_decode_masks_past_kv_valid_len():
    cfg = jax_config(ARCH).reduced()
    jl, tl = _layer(cfg, True, 3)
    r = np.random.default_rng(7)
    jx, tx = _bf16(r.standard_normal((B, 1, cfg.d_model)).astype(np.float32))
    jk, tk = _bf16(r.standard_normal((B, cfg.n_kv_heads, 12, cfg.hd)
                                     ).astype(np.float32))
    jv, tv = _bf16(r.standard_normal((B, cfg.n_kv_heads, 12, cfg.hd)
                                     ).astype(np.float32))
    j, _ = JL.attention(jl, jx, cfg, mode="cross_decode",
                        cache={"k": jk, "v": jv}, kv_valid_len=jnp.int32(5))
    t, _ = TL.attention(tl, tx, cfg, mode="cross_decode",
                        cache={"k": tk, "v": tv}, kv_valid_len=5)
    _close(t, j, "cross decode")
    # the keys at and past kv_valid_len take no part
    tk[:, :, 5:] = 100.0
    t2, _ = TL.attention(tl, tx, cfg, mode="cross_decode",
                         cache={"k": tk, "v": tv}, kv_valid_len=5)
    assert torch.equal(t2, t)


def test_cross_params_have_no_qk_norm():
    cfg = get_config("qwen3-8b").reduced()
    assert cfg.qk_norm
    gen = torch.Generator().manual_seed(0)
    mine = TL.attention_params(gen, cfg, 2, cross=True, device="cpu")
    theirs = JL.attention_params(jax.random.PRNGKey(0), cfg, 2, cross=True)
    assert mine.keys() == theirs.keys() and "q_norm" not in mine
    assert "q_norm" in TL.attention_params(gen, cfg, 2, device="cpu")


# -- the model ------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def run():
    """Both packages on the same weights, frames and tokens: encode,
    forward, the greedy loop through each package's serve fns (the port
    fed the JAX package's tokens) and the port's greedy_generate."""
    cfg = jax_config(ARCH).reduced()
    jp = JE.init_params(cfg, jax.random.PRNGKey(0))
    tp = params_from_jax(jp, cfg, "cpu")
    r = np.random.default_rng(8)
    tok = r.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    fr = r.standard_normal((B, FRAMES, cfg.d_model)).astype(np.float32)
    jtok, ttok = jnp.asarray(tok), torch.from_numpy(tok)
    jfr, tfr = jnp.asarray(fr), torch.from_numpy(fr)
    out = {"cfg": cfg, "params": tp, "inputs": (ttok, tfr)}
    out["encode"] = (jax.jit(lambda p, f: JE.encode(p, cfg, f))(jp, jfr),
                     TE.encode(tp, cfg, tfr))
    out["forward"] = (
        jax.jit(lambda p, t, f: JE.forward(p, cfg, t, embeds=f))(
            jp, jtok, jfr),
        TE.forward(tp, cfg, ttok, embeds=tfr))
    jpf, jdf = JS.make_serve_fns(cfg, CACHE)
    tpf, tdf = make_serve_fns(cfg, CACHE)
    jl, jc = jpf(jp, jtok, jfr)
    tl, tc = tpf(tp, ttok, tfr)
    out["prefill"] = (jl, tl)
    out["cache"] = ({key: val for key, val in jc.items()},
                    {key: (val.clone() if isinstance(val, torch.Tensor)
                           else val) for key, val in tc.items()})
    steps, toks, decode = [_np(jl[:, -1])], [np.asarray(
        jnp.argmax(jl[:, -1], -1))], []
    for _ in range(N_NEW - 1):
        nxt = toks[-1].astype(np.int32)[:, None]
        jl, jc = jdf(jp, jc, jnp.asarray(nxt))
        tl, tc = tdf(tp, tc, torch.tensor(nxt))
        decode.append((_np(jl), _np(tl), (int(jc["pos"]),
                                          int(jc["enc_len"])),
                       (tc["pos"], tc["enc_len"])))
        steps.append(_np(jl[:, -1]))
        toks.append(np.asarray(jnp.argmax(jl[:, -1], -1)))
    out["decode"] = decode
    out["greedy"] = (np.stack(toks, 1), np.stack(steps, 1),
                     greedy_generate(cfg, tp, ttok, N_NEW, cache_len=CACHE,
                                     embeds=tfr))
    return out


def test_encode_matches_jax():
    j, t = run()["encode"]
    assert t.shape == (B, FRAMES, run()["cfg"].d_model)
    assert t.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(t), _np(j), rtol=0, atol=TOL)


@pytest.mark.parametrize("arch", ENCDEC_ARCH_IDS)
def test_forward_logits_match_jax(arch):
    j, t = run()["forward"]
    cfg = run()["cfg"]
    assert get_model(get_config(arch)) is TE
    assert t.shape == (B, S, cfg.padded_vocab) and t.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(t), _np(j), rtol=0, atol=TOL)
    with pytest.raises(ValueError, match="frame embeddings"):
        TE.forward(run()["params"], cfg, run()["inputs"][0])


def test_prefill_logits_and_caches_match_jax():
    out = run()
    cfg = out["cfg"]
    j, t = out["prefill"]
    assert t.shape == (B, 1, cfg.padded_vocab)
    np.testing.assert_allclose(_np(t), _np(j), rtol=0, atol=TOL)
    jc, tc = out["cache"]
    assert tc["pos"] == int(jc["pos"]) == S
    assert tc["enc_len"] == int(jc["enc_len"]) == FRAMES
    for name, used in (("k", S), ("v", S), ("xk", FRAMES), ("xv", FRAMES)):
        assert tc[name].shape == jc[name].shape == (
            cfg.n_layers, B, cfg.n_kv_heads, CACHE, cfg.hd), name
        np.testing.assert_allclose(_np(tc[name]), _np(jc[name]), rtol=0,
                                   atol=TOL, err_msg=name)
        assert not torch.any(tc[name][:, :, :, used:]), name


def test_decode_step_logits_match_jax():
    """Every decode step, both fed the same tokens: self-attention over the
    cache, cross-attention over the first enc_len of its 48 slots."""
    for t, (j, mine, jint, tint) in enumerate(run()["decode"]):
        assert tint == jint == (S + t + 1, FRAMES)
        np.testing.assert_allclose(mine, j, rtol=0, atol=TOL,
                                   err_msg=f"decode step {t}")


def test_greedy_generate_with_frames_matches_jax():
    jtok, jlogits, ttok = run()["greedy"]
    assert ttok.shape == (B, N_NEW) and ttok.dtype == torch.int32
    ok, _ = testing.tokens_agree(ttok, jtok, jlogits, TOL)
    assert ok, (ttok, jtok)


def test_decode_matches_forward():
    """The port's own serve path: prefill + one decode step give the full
    forward's last logits (the 0.25 gate of tests/test_models.py)."""
    out = run()
    cfg, tp = out["cfg"], out["params"]
    tok, fr = out["inputs"]
    nxt = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (B, 1)).astype(np.int32))
    cache = TE.init_cache(cfg, B, S + 1, device="cpu", enc_len=FRAMES)
    _, cache = TE.prefill(tp, cfg, tok, cache, embeds=fr)
    ld, cache = TE.decode_step(tp, cfg, cache, nxt)
    full = TE.forward(tp, cfg, torch.cat([tok, nxt], 1), embeds=fr)
    err = float(torch.max(torch.abs(ld[:, -1].float() - full[:, -1].float())))
    assert err < 0.25, f"decode/forward mismatch {err}"


def test_frames_past_the_cross_cache_raise():
    out = run()
    cfg, tp = out["cfg"], out["params"]
    tok, fr = out["inputs"]
    pf, _ = make_serve_fns(cfg, FRAMES - 1)
    with pytest.raises(ValueError, match="at least the frame count"):
        pf(tp, tok, fr)


def test_enc_pos_tiles_past_its_table():
    """The encoder with no layers: its output is the normalised position
    rows alone, 8,200 of them, the last 8 the table's first 8 again."""
    cfg = dataclasses.replace(jax_config(ARCH).reduced(), encoder_layers=0)
    jp = JE.init_params(cfg, jax.random.PRNGKey(9))
    tp = params_from_jax(jp, cfg, "cpu")
    n = TE.ENC_POS + 8
    frames = np.zeros((1, n, cfg.d_model), np.float32)
    j = jax.jit(lambda p, f: JE.encode(p, cfg, f))(jp, jnp.asarray(frames))
    t = TE.encode(tp, cfg, torch.from_numpy(frames))
    assert t.shape == (1, n, cfg.d_model)
    np.testing.assert_allclose(_np(t), _np(j), rtol=testing.BF16_RTOL,
                               atol=testing.ATOL)
    pos = TE.enc_positions(tp, n)
    assert torch.equal(pos[TE.ENC_POS:], tp["enc_pos"][:8])
    assert torch.equal(t[0, TE.ENC_POS:], t[0, :8])


def test_params_from_jax_and_init_params_follow_the_jax_tree():
    """The encdec tree (``encoder``, ``decoder`` with ``cross``): stacks,
    emb and head in bf16, norm scales and ``enc_pos`` fp32, the converted
    values the JAX masters cast; the port's own init_params has the same
    keys, shapes and dtypes."""
    cfg = jax_config(ARCH).reduced()
    jp = JE.init_params(cfg, jax.random.PRNGKey(0))
    conv = run()["params"]
    mine = TE.init_params(get_config(ARCH).reduced(), device="cpu", seed=2)
    jflat = dict(jax.tree_util.tree_flatten_with_path(jp)[0])
    for tree in (conv, mine):
        flat = dict(jax.tree_util.tree_flatten_with_path(tree)[0])
        assert flat.keys() == jflat.keys()
        for path, t in flat.items():
            assert tuple(t.shape) == jflat[path].shape, path
            low = t.dim() >= 3 or path[0].key in ("emb", "head")
            assert t.dtype == (torch.bfloat16 if low else torch.float32), path
    assert "q_norm" not in conv["decoder"]["cross"]
    assert torch.equal(conv["decoder"]["cross"]["wk"].float(), torch.tensor(
        np.asarray(jp["decoder"]["cross"]["wk"])).to(torch.bfloat16).float())
    assert torch.equal(conv["enc_pos"],
                       torch.tensor(np.asarray(jp["enc_pos"])))
