"""The port's MoE layers and the MoE transformer against the JAX package
on the CPU: the GShard one-hot masks and the sort dispatch exactly (keep,
slot, masks) at a capacity factor that drops assignments (1.25) and one
that does not (4.0); the top-k tie rule; ``layers.moe`` in both
implementations within ``testing.LM_ATOL``; ``forward``, ``prefill`` and
``decode_step`` of deepseek-moe-16b and olmoe-1b-7b at ``reduced()`` size
on ``convert.params_from_jax`` weights; the port's own decode-vs-forward
gate (``tests/test_models.py``).

Routes: bf16 router logits tie often, and the two frameworks' bf16
products round at other places, so a token's K experts can differ between
the packages.  The port's router is held on the JAX package's own router
input at every MoE call: where its top K of that input differs from the
JAX package's, its K-th and (K+1)-th logits must lie within one bf16 ulp
(``testing.route_flips``); the test records each flip's margin and the
smallest margin of the run.  The port then dispatches the JAX package's
experts (``testing.follow_routes``), so its hidden states, which drift
from the JAX package's by bf16 rounding, do not carry the two packages
apart through a flip, and every sequence's logits are held.  No seed is
chosen to avoid ties.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models import layers as JL
from repro.models import transformer as JT
from _torch_parity import followed_routes, route_summary
from repro_torch import testing
from repro_torch.configs import MOE_ARCH_IDS, get_config
from repro_torch.convert import params_from_jax
from repro_torch.models import get_model
from repro_torch.models import layers as TL
from repro_torch.models import transformer as TT

B, S, N_NEW = 4, 16, 3
TOL = testing.LM_ATOL[torch.bfloat16]


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _assignments(seed, G, g, E, K):
    """(G, g, K) distinct experts per token (uniform, so some experts are
    over-subscribed) and their renormalised weights."""
    r = np.random.default_rng(seed)
    top_e = np.argsort(r.random((G, g, E)), -1)[..., :K].astype(np.int32)
    w = r.random((G, g, K)).astype(np.float32)
    return w / w.sum(-1, keepdims=True), top_e


SHAPES = [(8, 2, 16), (64, 6, 64)]          # (E, K, tokens a group)


@pytest.mark.parametrize("cf", [1.25, 4.0])
@pytest.mark.parametrize("E,K,g", SHAPES)
def test_onehot_masks_match_jax(E, K, g, cf):
    cfg = dataclasses.replace(get_config("deepseek-moe-16b"), n_experts=E,
                              experts_per_token=K, moe_capacity_factor=cf)
    C = TL.capacity(cfg, g)
    top_w, top_e = _assignments(3, 3, g, E, K)
    jd, jc = jax.vmap(functools.partial(JL._onehot_masks, E=E, K=K, C=C))(
        jnp.asarray(top_w), jnp.asarray(top_e))
    td, tc = TL._onehot_masks(torch.from_numpy(top_w),
                              torch.from_numpy(top_e).long(), E, K, C)
    assert td.dtype == tc.dtype == torch.bfloat16
    np.testing.assert_array_equal(_np(td), _np(jd))
    np.testing.assert_array_equal(_np(tc), _np(jc))
    kept = int(_np(td).sum())
    if cf == 1.25 and E == 64:
        assert kept < 3 * g * K, "the case must drop assignments"
    if cf == 4.0:
        assert kept == 3 * g * K


@pytest.mark.parametrize("cf", [1.25, 4.0])
@pytest.mark.parametrize("E,K,g", SHAPES)
def test_dispatch_group_matches_jax(E, K, g, cf):
    cfg = dataclasses.replace(get_config("deepseek-moe-16b"), n_experts=E,
                              experts_per_token=K, moe_capacity_factor=cf)
    C = TL.capacity(cfg, g)
    top_w, top_e = _assignments(4, 1, g, E, K)
    top_w, top_e = top_w[0], top_e[0]
    hf = np.random.default_rng(5).standard_normal((g, 24)).astype(np.float32)
    jh = jnp.asarray(hf).astype(jnp.bfloat16)
    th = torch.from_numpy(hf).bfloat16()
    jout = JL._dispatch_group(jh, jnp.asarray(top_w), jnp.asarray(top_e),
                              E, K, C)
    tout = TL._dispatch_group(th, torch.from_numpy(top_w),
                              torch.from_numpy(top_e).long(), E, K, C)
    for name, j, t in zip(("buf", "ts", "ws", "keep", "slot"), jout, tout):
        np.testing.assert_array_equal(_np(t), _np(j), err_msg=name)
    keep = tout[3].numpy()
    if cf == 1.25 and E == 64:
        assert not keep.all(), "the case must drop assignments"
    if cf == 4.0:
        assert keep.all()
    # the combine of the same expert outputs (bf16 sums in another order)
    out = np.random.default_rng(6).standard_normal((E, C, 24)).astype(
        np.float32)
    jy = JL._combine_group(jnp.asarray(out).astype(jnp.bfloat16),
                           *jout[1:], N=g)
    ty = TL._combine_group(torch.from_numpy(out).bfloat16(), *tout[1:], N=g)
    np.testing.assert_allclose(_np(ty), _np(jy), rtol=0, atol=TOL)


def test_top_k_breaks_ties_to_the_lower_index():
    """bf16 router logits tie exactly; the port's top K must take the
    lower expert index first, as ``jax.lax.top_k`` does."""
    r = np.random.default_rng(7)
    levels = np.float32([0.5, 0.25, 0.125, 0.0625])
    probs = levels[r.integers(0, 4, (64, 64))]           # ties everywhere
    jw, je = jax.lax.top_k(jnp.asarray(probs), 6)
    tw, te = TL.top_k(torch.from_numpy(probs), 6)
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))


def test_route_flip_rule():
    """A flip between equal or adjacent bf16 logits is near; one a bf16
    ulp cannot explain is not; the margin counts the pair actually
    swapped, in ulps at that pair."""
    ref = np.float32([[2.0, 1.5, 1.0, 0.5], [2.0, 1.0, 1.0, 0.25],
                      [2.0, 1.5, 1.0, 0.5], [2.0, 1.0, 0.9921875, 0.25],
                      [2.0, 1.0, 0.984375, 0.25]])
    e_ref = np.int64([[0, 1]] * 5)
    # agree, tie flip, far flip, one ulp below 1.0, two ulps below 1.0
    e = np.int64([[1, 0], [0, 2], [0, 3], [0, 2], [0, 2]])
    rf = testing.route_flips(e, e_ref, ref)
    assert rf["flipped"].tolist() == [False, True, True, True, True]
    assert rf["near"].tolist() == [True, True, False, True, False]
    assert rf["margin"][1] == 0.0 and rf["margin"][2] == 1.0
    assert rf["margin"][0] == 0.5                 # K-th minus (K+1)-th
    np.testing.assert_array_equal(rf["margin_ulps"][1:], [0, 128, 1, 2])
    assert rf["max_flip_ulps"] == 128             # ulps of the pair's 1.5


def test_groups_follow_the_jax_assert():
    cfg = get_config("olmoe-1b-7b")
    assert TL.groups(cfg, 8, 2048) == (32, 512)
    assert TL.groups(cfg, 8, 1) == (1, 8)            # decode: the batch
    assert TL.groups(cfg, 1, 256) == (1, 256)
    with pytest.raises(ValueError, match="dispatch groups"):
        TL.groups(dataclasses.replace(cfg, moe_group_size=5), 1, 16)


# -- one layer ----------------------------------------------------------


@pytest.mark.parametrize("impl", ["onehot", "sort"])
@pytest.mark.parametrize("arch", MOE_ARCH_IDS)
def test_moe_layer_matches_jax(arch, impl):
    cfg = dataclasses.replace(jax_config(arch).reduced(), moe_impl=impl,
                              moe_capacity_factor=1.25)
    jp = jax.tree_util.tree_map(
        lambda a: a[0], JL.cast_stacks(JT.init_params(
            cfg, jax.random.PRNGKey(0))["moe"]))
    tp = TL.slice_layer(params_from_jax({"moe": JT.init_params(
        cfg, jax.random.PRNGKey(0))["moe"]}, cfg, "cpu")["moe"], 0)
    x = np.random.default_rng(8).standard_normal(
        (B, S, cfg.d_model)).astype(np.float32)
    jy = JL.moe(jp, jnp.asarray(x).astype(jnp.bfloat16), cfg)
    recs = []
    with TL.route_hook(testing.record_routes(recs)):
        ty = TL.moe(tp, torch.from_numpy(x).bfloat16(), cfg)
    assert ty.dtype == torch.bfloat16 and ty.shape == (B, S, cfg.d_model)
    np.testing.assert_allclose(_np(ty), _np(jy), rtol=0, atol=TOL)
    (_, top_e), = recs
    assert 0 < int(TL.kept_assignments(cfg, top_e)) <= B * S * (
        cfg.experts_per_token)


# -- the model ----------------------------------------------------------


@functools.lru_cache(maxsize=None)
def run(arch):
    """forward, prefill and N_NEW − 1 decode steps of both packages on the
    same weights and tokens (the port fed the JAX package's greedy
    tokens), the port's router held on the JAX package's input and then
    dispatching the JAX package's experts; every step's flips."""
    cfg = jax_config(arch).reduced()
    jp = JT.init_params(cfg, jax.random.PRNGKey(0))
    tp = params_from_jax(jp, cfg, "cpu")
    tok = np.random.default_rng(1).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)
    out = {"cfg": cfg, "params": tp, "tokens": tok, "steps": []}
    with followed_routes() as (jrecs, flips, own):
        jl = jax.jit(lambda p, t: JT.forward(p, cfg, t))(
            jp, jnp.asarray(tok))
        jax.effects_barrier()
        tl = TT.forward(tp, cfg, torch.from_numpy(tok))
        out["forward"] = (jl, tl, list(flips), list(own))
        jrecs.clear(), flips.clear(), own.clear()
        jcache = JT.init_cache(cfg, B, S + N_NEW)
        tcache = TT.init_cache(cfg, B, S + N_NEW, device="cpu")
        jl, jcache = jax.jit(lambda p, t, c: JT.prefill(p, cfg, t, c))(
            jp, jnp.asarray(tok), jcache)
        jax.effects_barrier()
        tl, tcache = TT.prefill(tp, cfg, torch.from_numpy(tok), tcache)
        jdec = jax.jit(lambda p, c, t: JT.decode_step(p, cfg, c, t))
        for t in range(N_NEW):
            out["steps"].append((jl, tl, flips[-cfg.n_layers:],
                                 own[-cfg.n_layers:]))
            if t == N_NEW - 1:
                break
            nxt = np.asarray(jnp.argmax(jl[:, -1], -1)).astype(
                np.int32)[:, None]
            jl, jcache = jdec(jp, jcache, jnp.asarray(nxt))
            jax.effects_barrier()
            tl, tcache = TT.decode_step(tp, cfg, tcache,
                                        torch.from_numpy(nxt))
    return out


@pytest.mark.parametrize("arch", MOE_ARCH_IDS)
def test_forward_logits_match_jax(arch):
    jl, tl, flips, own = run(arch)["forward"]
    cfg = run(arch)["cfg"]
    assert len(flips) == len(own) == cfg.n_layers
    assert tl.shape == (B, S, cfg.padded_vocab) and tl.dtype == torch.bfloat16
    print(f"{arch} forward: {route_summary(flips, own)}")
    np.testing.assert_allclose(_np(tl), _np(jl), rtol=0, atol=TOL)


@pytest.mark.parametrize("arch", MOE_ARCH_IDS)
def test_prefill_and_decode_match_jax(arch):
    """The prefill logits and each decode step's, both fed the JAX
    package's tokens."""
    for t, (jl, tl, flips, own) in enumerate(run(arch)["steps"]):
        assert len(flips) == len(own) == run(arch)["cfg"].n_layers
        print(f"{arch} step {t}: {route_summary(flips, own)}")
        assert tl.shape == (B, 1, run(arch)["cfg"].padded_vocab)
        np.testing.assert_allclose(_np(tl), _np(jl), rtol=0, atol=TOL,
                                   err_msg=f"step {t}")


@pytest.mark.parametrize("arch", MOE_ARCH_IDS)
def test_decode_matches_forward(arch):
    """The port's own serve path: prefill + one decode step give the full
    forward's last logits (the 0.25 gate of tests/test_models.py; no
    assignment drops at ``reduced()``'s capacity factor)."""
    out = run(arch)
    cfg, tp = out["cfg"], out["params"]
    tok = torch.from_numpy(out["tokens"])
    nxt = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (B, 1)).astype(np.int32))
    cache = TT.init_cache(cfg, B, S + 1, device="cpu")
    _, cache = TT.prefill(tp, cfg, tok, cache)
    ld, cache = TT.decode_step(tp, cfg, cache, nxt)
    full = TT.forward(tp, cfg, torch.cat([tok, nxt], 1))
    err = float(torch.max(torch.abs(ld[:, -1].float() - full[:, -1].float())))
    assert err < 0.25, f"{arch}: decode/forward mismatch {err}"


@pytest.mark.parametrize("arch", MOE_ARCH_IDS)
def test_moe_params_follow_the_jax_tree(arch):
    """The port's own init_params: the JAX tree's keys and shapes, stacks
    (experts, router, shared) in bf16, norm scales fp32; the registry
    serves the family."""
    cfg = get_config(arch).reduced()
    assert get_model(cfg) is TT
    p = TT.init_params(cfg, device="cpu", seed=1)
    jp = JT.init_params(cfg, jax.random.PRNGKey(0))
    flat = dict(jax.tree_util.tree_flatten_with_path(p)[0])
    jflat = dict(jax.tree_util.tree_flatten_with_path(jp)[0])
    assert flat.keys() == jflat.keys()
    for path, t in flat.items():
        assert tuple(t.shape) == jflat[path].shape, path
        low = t.dim() >= 3 or path[0].key in ("emb", "head")
        assert t.dtype == (torch.bfloat16 if low else torch.float32), path
    assert ("shared" in p["moe"]) == bool(cfg.n_shared_experts)
