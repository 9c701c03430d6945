"""The port's ``wkv6`` against the JAX package on the CPU: its plain version
against ``repro.kernels.ref.wkv6`` (the sequential oracle; not the Pallas
interpret path, which does not trace on JAX 0.9.0, where ``pl.store`` is
gone) at the shapes of ``tests/test_kernels.py::test_wkv6_kernel``,
ragged T and Dk ≠ Dv, fp32 and bf16; its final state against
``layers.gla_chunked``'s and a ``layers.gla_step`` replay; one step from a
non-zero state against ``gla_step``; state chaining; the dispatch on CPU
tensors and the route by T (T = 1 to the decode kernel, longer T to the
recurrent one); a model of the decode kernel's thread mapping and
summation order (``csrc/wkv6_decode.cu``) against the plain version, to
the bit; and the three CUDA kernels (recurrent, decode, chunked) against
the plain version on a card, over several chunks and at strong decays.

Tolerance: ``repro_torch.testing`` — fp32 within RTOL = ATOL = 1e-5 (the
same recurrence, sums in another order), bf16 outputs within one bf16 ulp
more (``BF16_RTOL``).  On the card the recurrent kernel and its plain
version share their arithmetic op for op, so they agree to the bit; the
check there is the same tolerance, and for the chunked kernel also the
error model of ``testing.WKV_TERMS_RTOL``
(``tests/test_torch_wkv6_chunked.py``).  The decode kernel and its model
are held to the bit (``torch.equal``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.models.layers import gla_chunked, gla_step
from repro_torch import testing
from repro_torch.kernels import _build, ops, ref
from repro_torch.kernels import wkv6 as wkv_mod

from _torch_parity import cuda  # noqa: F401

DTYPES = {"fp32": (torch.float32, jnp.float32),
          "bf16": (torch.bfloat16, jnp.bfloat16)}
# (B, H, T, Dk, Dv): tests/test_kernels.py's three, ragged T, Dk != Dv
SHAPES = [(2, 3, 16, 8, 8), (1, 2, 64, 16, 16), (2, 1, 32, 4, 8),
          (2, 2, 37, 16, 16), (1, 3, 45, 12, 20), (1, 1, 3, 64, 64)]


def _inputs(seed, B, H, T, Dk, Dv, scale=0.3, decay=None):
    """r, k, v, w, u as tests/test_kernels.py draws them (w = sigmoid(N +
    2) in (0, 1), or the constant ``decay``), from NumPy."""
    g = np.random.default_rng(seed)
    r = (scale * g.standard_normal((B, H, T, Dk))).astype(np.float32)
    k = (scale * g.standard_normal((B, H, T, Dk))).astype(np.float32)
    v = (scale * g.standard_normal((B, H, T, Dv))).astype(np.float32)
    w = (1.0 / (1.0 + np.exp(-(g.standard_normal((B, H, T, Dk)) + 2.0)))
         ).astype(np.float32)
    if decay is not None:
        w = np.full_like(w, decay)
    u = (0.1 * g.standard_normal((H, Dk))).astype(np.float32)
    return r, k, v, w, u


def _torch(arrs):
    return [torch.from_numpy(a) for a in arrs]


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("B,H,T,Dk,Dv", SHAPES)
def test_plain_matches_jax_ref(dtype, B, H, T, Dk, Dv):
    tdt, jdt = DTYPES[dtype]
    r, k, v, w, u = _inputs(T, B, H, T, Dk, Dv)
    want = jref.wkv6(*(jnp.asarray(a, jdt) for a in (r, k, v)),
                     jnp.asarray(w), jnp.asarray(u))
    tr, tk, tv = (torch.from_numpy(a).to(tdt) for a in (r, k, v))
    y, S = ref.wkv6(tr, tk, tv, torch.from_numpy(w), torch.from_numpy(u))
    assert y.dtype == tdt and y.shape == (B, H, T, Dv)
    assert S.dtype == torch.float32 and S.shape == (B, H, Dk, Dv)
    testing.assert_attention_close(y, np.asarray(want.astype(jnp.float32)),
                                   dtype == "bf16", f"wkv6 y {dtype}")


@pytest.mark.parametrize("B,H,T,Dk,Dv,chunk", [(2, 2, 96, 8, 8, 32),
                                               (1, 2, 80, 16, 16, 64),
                                               (2, 1, 37, 4, 8, 16)])
def test_final_state_matches_gla_chunked_and_step(B, H, T, Dk, Dv, chunk):
    """y and the final state against the chunked form (T padded to the
    chunk with log w = 0 on the pad, as models/rwkv.py pads it) and against
    a replay of the recurrent step."""
    r, k, v, w, u = _inputs(T + 1, B, H, T, Dk, Dv, scale=0.4)
    pad = (-T) % chunk
    padded = [np.pad(a, ((0, 0), (0, 0), (0, pad), (0, 0)))
              for a in (r, k, v, np.log(w))]
    yc, Sc = gla_chunked(*(jnp.asarray(a) for a in padded), jnp.asarray(u),
                         chunk=chunk)
    y, S = ref.wkv6(*_torch((r, k, v, w, u)))
    testing.assert_close(y, np.asarray(yc)[:, :, :T], "wkv6 y vs gla_chunked")
    testing.assert_close(S, np.asarray(Sc), "wkv6 state vs gla_chunked")
    st = jnp.zeros((B, H, Dk, Dv))
    for t in range(T):
        _, st = gla_step(r[:, :, t], k[:, :, t], v[:, :, t], w[:, :, t], u,
                         st)
    testing.assert_close(S, np.asarray(st), "wkv6 state vs gla_step replay")


@pytest.mark.parametrize("B,H,Dk,Dv", [(2, 3, 16, 16), (1, 2, 64, 64),
                                       (2, 1, 4, 8)])
def test_one_step_from_a_state_matches_gla_step(B, H, Dk, Dv):
    r, k, v, w, u = _inputs(Dk + Dv, B, H, 1, Dk, Dv)
    S0 = np.random.default_rng(5).standard_normal(
        (B, H, Dk, Dv)).astype(np.float32)
    yj, Sj = gla_step(r[:, :, 0], k[:, :, 0], v[:, :, 0], w[:, :, 0], u,
                      jnp.asarray(S0))
    y, S = ref.wkv6(*_torch((r, k, v, w, u)), torch.from_numpy(S0))
    testing.assert_close(y[:, :, 0], np.asarray(yj), "wkv6 decode y")
    testing.assert_close(S, np.asarray(Sj), "wkv6 decode state")


@pytest.mark.parametrize("split", [1, 17, 32])
def test_state_chaining_over_halves_of_t(split):
    """Two calls over [0, split) and [split, T), the second from the first's
    final state, give the one call over all of T to the bit; through
    ops.wkv6 with the state updated in place as decode updates it."""
    r, k, v, w, u = _torch(_inputs(9, 2, 3, 40, 16, 16))
    y, S = ops.wkv6(r, k, v, w, u)
    st = torch.empty_like(S)
    y1, s1 = ops.wkv6(*(a[:, :, :split] for a in (r, k, v, w)), u,
                      state_out=st)
    y2, s2 = ops.wkv6(*(a[:, :, split:] for a in (r, k, v, w)), u, st,
                      state_out=st)
    assert s1 is st and s2 is st
    assert torch.equal(torch.cat([y1, y2], dim=2), y)
    assert torch.equal(st, S)


def test_ops_on_cpu_takes_the_plain_version(monkeypatch):
    def no_build(name):
        raise AssertionError(f"the CPU path reached the build of {name}")

    monkeypatch.setattr(_build, "load", no_build)
    ops.reset_launch_counts()
    r, k, v, w, u = _torch(_inputs(2, 1, 2, 7, 8, 8))
    S0 = torch.ones((1, 2, 8, 8))
    y, S = ops.wkv6(r, k, v, w, u, S0, out_dtype=torch.float32)
    y_p, S_p = ref.wkv6(r, k, v, w, u, S0)
    assert torch.equal(y, y_p) and torch.equal(S, S_p)
    assert torch.equal(S0, torch.ones((1, 2, 8, 8)))     # not written
    with pytest.raises(ValueError, match="CUDA tensors"):
        wkv_mod.launch(r, k, v, w, u)
    assert ops.launch_counts["wkv6_prefill"] == 0
    assert ops.launch_counts["wkv6_decode"] == 0
    assert ops.launch_counts["wkv6_recurrent"] == 0


def test_plain_sums_in_the_kernels_order():
    """The plain version's lane sums: lane l adds the rows k ≡ l (mod 8) in
    order, then the lanes meet in the pairwise tree of csrc/wkv6.cu's xor
    shuffles.  Values that cancel only in that order."""
    f = np.float32
    x = np.array([1e8, 1.0, -1e8, 1.0, 3.0, 0.5, 0.25, 2.0,
                  1.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0], np.float32)
    lanes = ref._slab_sum(torch.from_numpy(x)[:, None], ref.WKV_LANES, 0)
    lane = [x[i] + x[i + 8] for i in range(8)]
    assert lanes[:, 0].tolist() == [float(a) for a in lane]
    want = ((lane[0] + lane[1]) + (lane[2] + lane[3])) + (
        (lane[4] + lane[5]) + (lane[6] + lane[7]))
    got = float(ref._lane_tree(lanes, 0)[0])
    assert got == float(want) and got != float(np.cumsum(x)[-1])
    assert float(want) == float(f(5.75))


def _decode_model(r, k, v, w, u, state, out_dtype=None):
    """csrc/wkv6_decode.cu's arithmetic at T = 1, thread by thread: a CTA of
    4 warps × 32 lanes per (b, h, 64 columns); lane ``l·4 + q`` of warp
    ``wp`` holds columns ``j = 64·cb + 4·(4·wp + q) + c`` (c < 4) of rows
    ``l + 8·i`` (i < EPT, zeros past Dk), sums ``r_k·S_kj`` over its rows
    in order and meets the other row classes in xor shuffles over lane
    bits 2, 3, 4; every warp sums the bonus over 32 lanes of rows
    ``lane + 32·m`` and the xor tree over all 5 lane bits.  Tensors of the
    model: (B, H, column blocks, warps, lanes, c).  Returns (y, state)."""
    B, H, _, Dk = r.shape
    Dv = v.shape[-1]
    ept = 2 if Dk <= 16 else 4 if Dk <= 32 else 8
    nb = -(-Dv // 64)
    f32 = torch.float32
    lane = torch.arange(32)
    l, q = lane // 4, lane % 4
    j = ((torch.arange(nb)[:, None, None, None] * 64
          + 4 * (4 * torch.arange(4)[None, :, None, None] + q[None, None, :,
                                                              None]))
         + torch.arange(4)[None, None, None, :])           # (nb, 4, 32, 4)
    col = j < Dv
    jc = j.clamp(max=Dv - 1)
    S0 = (torch.zeros((B, H, Dk, Dv), dtype=f32) if state is None
          else state.float())
    r1, k1, v1, w1 = (x[:, :, 0].float() for x in (r, k, v, w))

    def rows(x, kk):                      # x (B, H, Dk) at rows kk, 0 past
        return torch.where(kk < Dk, x[..., kk.clamp(max=Dk - 1)],
                           torch.zeros((), dtype=f32))

    vj = torch.where(col, v1[..., jc], torch.zeros((), dtype=f32))
    # the bonus, as one warp sums it
    bonus = torch.zeros((B, H, 32), dtype=f32)
    uf = u.float()
    for m in range(-(-8 * ept // 32)):
        kk = lane + 32 * m
        p = rows(r1, kk) * torch.where(
            kk < Dk, uf[:, kk.clamp(max=Dk - 1)],
            torch.zeros((), dtype=f32))[None] * rows(k1, kk)
        p = torch.where(kk < 8 * ept, p, torch.zeros((), dtype=f32))
        bonus = p if m == 0 else bonus + p
    for off in (1, 2, 4, 8, 16):
        bonus = bonus + bonus[..., lane ^ off]
    # y: the lane's rows in order, then the tree over lane bits 2, 3, 4
    part = None
    S_new = S0.clone()
    for i in range(ept):
        kk = (l + 8 * i)[None, None, :, None].expand_as(j)   # the row
        s = torch.where((kk < Dk) & col,
                        S0[:, :, kk.clamp(max=Dk - 1), jc],
                        torch.zeros((), dtype=f32))
        rr = torch.where(kk < Dk, r1[..., kk.clamp(max=Dk - 1)],
                         torch.zeros((), dtype=f32))
        p = rr * s
        part = p if i == 0 else part + p
        kr = torch.where(kk < Dk, k1[..., kk.clamp(max=Dk - 1)],
                         torch.zeros((), dtype=f32))
        wr = torch.where(kk < Dk, w1[..., kk.clamp(max=Dk - 1)],
                         torch.zeros((), dtype=f32))
        upd = wr * s + kr * vj
        keep = (kk < Dk) & col
        S_new[:, :, kk[keep], j[keep]] = upd[:, :, keep]
    for off in (4, 8, 16):
        part = part + part[:, :, :, :, lane ^ off]
    yv = part + vj * bonus[:, :, None, None, :, None]
    lead = (l == 0)[None, None, :, None].expand_as(j) & col   # lanes 0..3
    y = torch.empty((B, H, 1, Dv), dtype=f32)
    y[:, :, 0, j[lead]] = yv[:, :, lead]
    return y.to(out_dtype or r.dtype), S_new


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("u_dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("B,H,Dk,Dv", [(2, 3, 16, 16), (1, 2, 64, 64),
                                       (2, 2, 16, 64), (2, 1, 64, 16),
                                       (1, 2, 40, 72), (2, 1, 8, 8)])
def test_decode_model_equals_plain_to_the_bit(dtype, u_dtype, B, H, Dk, Dv):
    """The decode kernel's thread mapping and order (``_decode_model``) give
    the plain version's y and state bit for bit at T = 1: zeros in and a
    given state, y in r's type and in fp32, u in bf16 and fp32; and the
    state written in place through ``ops.wkv6`` (the plain path on the
    CPU) is the model's."""
    tdt = DTYPES[dtype][0]
    r, k, v, w, u = _inputs(Dk * Dv + B, B, H, 1, Dk, Dv, scale=1.0)
    tr, tk, tv = (torch.from_numpy(a).to(tdt) for a in (r, k, v))
    tw = torch.from_numpy(w)
    tu = torch.from_numpy(u).to(DTYPES[u_dtype][0])
    S0 = torch.from_numpy(np.random.default_rng(Dk).standard_normal(
        (B, H, Dk, Dv)).astype(np.float32))
    for state in (None, S0):
        for od in (None, torch.float32):
            y_m, S_m = _decode_model(tr, tk, tv, tw, tu, state, od)
            y_p, S_p = ref.wkv6(tr, tk, tv, tw, tu, state, out_dtype=od)
            assert y_m.dtype == y_p.dtype
            assert torch.equal(y_m, y_p) and torch.equal(S_m, S_p)
    st = S0.clone()
    y, S = ops.wkv6(tr, tk, tv, tw, tu, st, state_out=st,
                    out_dtype=torch.float32)
    y_m, S_m = _decode_model(tr, tk, tv, tw, tu, S0, torch.float32)
    assert S is st and torch.equal(st, S_m) and torch.equal(y, y_m)


@pytest.mark.parametrize("T,kernel", [(1, "decode"), (2, "recurrent"),
                                      (3, "recurrent"), (64, "recurrent"),
                                      (2100, "recurrent")])
def test_route_by_t(monkeypatch, T, kernel):
    """ops.wkv6 on card tensors (here: the card check patched to say so)
    reaches wkv6.launch, which sends T = 1 to the decode kernel and every
    longer T to the recurrent kernel, by T alone; nothing reaches the
    chunked kernel or the plain version."""
    from repro_torch.kernels import ops as ops_mod
    called = []

    def kernel_of(name):
        def fn(r, *args, **kwargs):
            called.append((name, r.shape[2]))
            return "y", "state"
        return fn

    def never(*args, **kwargs):
        raise AssertionError("the card path reached another route")

    monkeypatch.setattr(ops_mod, "_on_card", lambda t: True)
    monkeypatch.setattr(ref, "wkv6", never)
    monkeypatch.setattr(wkv_mod, "launch_chunked", never)
    monkeypatch.setattr(wkv_mod, "launch_decode", kernel_of("decode"))
    monkeypatch.setattr(wkv_mod, "launch_recurrent", kernel_of("recurrent"))
    r, k, v, w, u = _torch(_inputs(T, 1, 2, T, 8, 8))
    assert wkv_mod.route(T) == kernel
    assert ops.wkv6(r, k, v, w, u) == ("y", "state")
    assert wkv_mod.launch(r, k, v, w, u, state_out=None) == ("y", "state")
    assert called == [(kernel, T), (kernel, T)]


@pytest.mark.parametrize("route", ["ops.wkv6", "launch_chunked",
                                   "launch_decode"])
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("B,H,T,Dk,Dv,decay", [
    (2, 3, 37, 16, 16, None), (1, 2, 100, 64, 64, None),
    (2, 1, 9, 8, 16, None), (2, 3, 300, 64, 64, None),
    (2, 3, 300, 64, 64, 0.05), (1, 2, 200, 32, 64, 1e-6)])
def test_kernel_matches_plain_on_card(cuda, route, dtype, B, H, T, Dk, Dv,  # noqa: F811
                                      decay):
    """The routed call (ops.wkv6, which launches the recurrent kernel for
    T > 1 and never the chunked one) and the chunked kernel
    (wkv6.launch_chunked) against the plain version, over several 64-step
    chunks and at strong decays; the chunked one also within the error
    model of testing.WKV_TERMS_RTOL.  The decode route runs the same T
    steps as T decode launches through ops.wkv6, the state updated in
    place, each step to the bit of the plain version's."""
    tdt = DTYPES[dtype][0]
    r, k, v, w, u = _inputs(T, B, H, T, Dk, Dv, decay=decay)
    S0 = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (B, H, Dk, Dv)).astype(np.float32)).to(cuda)
    tr, tk, tv = (torch.from_numpy(a).to(cuda, tdt) for a in (r, k, v))
    tw, tu = (torch.from_numpy(a).to(cuda) for a in (w, u))
    ops.reset_launch_counts()
    if route == "launch_decode":
        st = S0.clone()
        ys = []
        for t in range(T):
            step = [a[:, :, t:t + 1] for a in (tr, tk, tv, tw)]
            y_p, S_p = ref.wkv6(*step, tu, st)
            y, S = ops.wkv6(*step, tu, st, state_out=st)
            torch.cuda.synchronize()
            assert S is st and torch.equal(y, y_p) and torch.equal(st, S_p)
            ys.append(y)
        assert ops.launch_counts["wkv6_decode"] == T
        assert ops.launch_counts["wkv6_recurrent"] == 0
        y, S = torch.cat(ys, dim=2), st
    else:
        fn = ops.wkv6 if route == "ops.wkv6" else wkv_mod.launch_chunked
        y, S = fn(tr, tk, tv, tw, tu, S0)
        torch.cuda.synchronize()
        assert ops.launch_counts["wkv6_prefill"] == 1
        assert ops.launch_counts["wkv6_recurrent"] == (
            1 if route == "ops.wkv6" else 0)
        assert ops.launch_counts["wkv6_chunked"] == (
            0 if route == "ops.wkv6" else 3)
    y_p, S_p = ref.wkv6(tr, tk, tv, tw, tu, S0)
    testing.assert_attention_close(y, y_p, dtype == "bf16", "wkv6 y")
    testing.assert_close(S, S_p, "wkv6 state")
    if route == "launch_chunked":
        m_y, m_S = testing.wkv6_terms(tr, tk, tv, tw, tu, S0)
        testing.assert_within_terms(y, y_p, m_y, dtype == "bf16", "y")
        testing.assert_within_terms(S, S_p, m_S, False, "state")
