"""The port's ``wkv6`` against the JAX package on the CPU: its plain version
against ``repro.kernels.ref.wkv6`` (the sequential oracle; not the Pallas
interpret path, which does not trace on JAX 0.9.0, where ``pl.store`` is
gone) at the shapes of ``tests/test_kernels.py::test_wkv6_kernel``,
ragged T and Dk ≠ Dv, fp32 and bf16; its final state against
``layers.gla_chunked``'s and a ``layers.gla_step`` replay; one step from a
non-zero state against ``gla_step``; state chaining; the dispatch on CPU
tensors; and both CUDA kernels (recurrent and chunked) against the plain
version on a card, over several chunks and at strong decays.

Tolerance: ``repro_torch.testing`` — fp32 within RTOL = ATOL = 1e-5 (the
same recurrence, sums in another order), bf16 outputs within one bf16 ulp
more (``BF16_RTOL``).  On the card the recurrent kernel and its plain
version share their arithmetic op for op, so they agree to the bit; the
check there is the same tolerance, and for the chunked kernel also the
error model of ``testing.WKV_TERMS_RTOL``
(``tests/test_torch_wkv6_chunked.py``).
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


@pytest.mark.parametrize("route", ["ops.wkv6", "launch_chunked"])
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("B,H,T,Dk,Dv,decay", [
    (2, 3, 37, 16, 16, None), (1, 2, 100, 64, 64, None),
    (2, 1, 9, 8, 16, None), (2, 3, 300, 64, 64, None),
    (2, 3, 300, 64, 64, 0.05), (1, 2, 200, 32, 64, 1e-6)])
def test_kernel_matches_plain_on_card(cuda, route, dtype, B, H, T, Dk, Dv,  # noqa: F811
                                      decay):
    """The routed call (ops.wkv6, which launches the recurrent kernel and
    never the chunked one) and the chunked kernel (wkv6.launch_chunked)
    against the plain version, over several 64-step chunks and at strong
    decays; the chunked one also within the error model of
    testing.WKV_TERMS_RTOL."""
    tdt = DTYPES[dtype][0]
    r, k, v, w, u = _inputs(T, B, H, T, Dk, Dv, decay=decay)
    S0 = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (B, H, Dk, Dv)).astype(np.float32)).to(cuda)
    tr, tk, tv = (torch.from_numpy(a).to(cuda, tdt) for a in (r, k, v))
    tw, tu = (torch.from_numpy(a).to(cuda) for a in (w, u))
    ops.reset_launch_counts()
    fn = ops.wkv6 if route == "ops.wkv6" else wkv_mod.launch_chunked
    y, S = fn(tr, tk, tv, tw, tu, S0)
    torch.cuda.synchronize()
    assert ops.launch_counts["wkv6_prefill"] == 1
    assert ops.launch_counts["wkv6_chunked"] == (
        0 if route == "ops.wkv6" else 3)
    y_p, S_p = ref.wkv6(tr, tk, tv, tw, tu, S0)
    testing.assert_attention_close(y, y_p, dtype == "bf16", "wkv6 y")
    testing.assert_close(S, S_p, "wkv6 state")
    if route == "launch_chunked":
        m_y, m_S = testing.wkv6_terms(tr, tk, tv, tw, tu, S0)
        testing.assert_within_terms(y, y_p, m_y, dtype == "bf16", "y")
        testing.assert_within_terms(S, S_p, m_S, False, "state")
