"""The chunked ``wkv6`` kernel's arithmetic, modelled on the CPU.

``csrc/wkv6_chunked.cu`` cuts T into chunks of 64 steps and each chunk into
four sub-chunks of 16.  Inside a sub-chunk it decays r by the prefix
products c_t of w, k by the suffix products d_j, and forms the pairwise
scores P_tj = Σ_k r_tk·(k_jk Π_{j<s<t} w_sk), k_j decayed a step at a
time (the bonus Σ_k r_tk u_k k_tk on the diagonal) on the CUDA cores, 4 channels a lane and the 16 lanes'
partials added in lane order; the products
(r c)·S, P·V and (k d)ᵀ·V run on the tensor cores with every fp32 operand
split in three bf16 pieces, h, m and l, and the piece pairs of order ≤ 2
run smallest first.  Three phases: each chunk's own state from zeros,
a scan S_c = D_c·S_{c−1} + S_loc,c, each chunk's y from its entry state.
:func:`chunked_model` repeats that arithmetic in PyTorch (each ``mma``
modelled as its exact products, in float64, added to the fp32 accumulator
with one rounding — the card's accumulation order is its own, which only a
chip run reads).

Held here, against the port's plain recurrence (``ref.wkv6``) and the JAX
package's (``repro.kernels.ref.wkv6``): the model meets the error model of
``testing.WKV_TERMS_RTOL`` at every decay — the model's init (≈ 0.9975),
``sigmoid(N + 2)`` and constant 0.5, 0.05 and 1e-6, fp32 and bf16, ragged
T, from zeros and from a given state — and the unchanged RTOL/ATOL checks
at these small operands (0.3·N(0, 1)); one bf16 rounding of the fp32 operands in
place of the split fails both; every decay factor it forms is ≤ 1 and no
value overflows at w = 1e-6; two calls split on a chunk boundary give the
bits of one.  At the strong decays (w ≤ 0.5) ``layers.gla_chunked`` parts
from the recurrence (its decay factorisation is clipped at exp(±30);
ROADMAP queue 3), so only the port's side is asserted there.

At the model's init decay with N(0, 1) operands the unchanged checks hold
no summation order but the recurrence's own: the exact (float64) sum fails
them against the fp32 plain version.  That is why ``kernels/wkv6.py``
dispatches no call to the chunked kernel.

Inputs are made with NumPy from a seed.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch import testing
from repro_torch.kernels import ref
from repro_torch.kernels import wkv6 as wkv_mod

from _torch_parity import cuda  # noqa: F401

F32, F64 = torch.float32, torch.float64
CHUNK, SUB, KQ = 64, 16, 16     # csrc/wkv6_chunked.cu: C, SUB, KQ
DECAYS = ["model", "fast", 0.5, 0.05, 1e-6]


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """The model runs thousands of tiny ops: on several threads a worker
    that shares the CPU with others spends its time waking them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def inputs(seed, B, H, T, Dk, Dv, decay, scale=0.3, state=False):
    """r, k, v ~ scale·N(0, 1), u ~ 0.1·N(0, 1), w by ``decay``: "model"
    exp(−exp(−6 + N/2)) (the model's init), "fast" sigmoid(N + 2), or a
    constant; a state ~ N(0, 1) where asked."""
    g = np.random.default_rng(seed)
    r, k = (scale * g.standard_normal((2, B, H, T, Dk))).astype(np.float32)
    v = (scale * g.standard_normal((B, H, T, Dv))).astype(np.float32)
    n = g.standard_normal((B, H, T, Dk))
    if decay == "model":
        w = np.exp(-np.exp(-6.0 + 0.5 * n))
    elif decay == "fast":
        w = 1.0 / (1.0 + np.exp(-(n + 2.0)))
    else:
        w = np.full(n.shape, decay)
    u = 0.1 * g.standard_normal((H, Dk))
    s0 = g.standard_normal((B, H, Dk, Dv)) if state else None
    return [torch.from_numpy(np.asarray(a, np.float32)) if a is not None
            else None for a in (r, k, v, w, u, s0)]


def pieces(x: torch.Tensor, split: bool) -> list[torch.Tensor]:
    """x as the kernel feeds it to a product: three bf16 pieces (h, m, l),
    or one bf16 rounding (``split=False``), as fp32 tensors."""
    out = []
    for _ in range(3 if split else 1):
        p = x.to(torch.bfloat16).float()
        out.append(p)
        x = x - p
    return out


def mma(acc, A, B):
    """acc + Σ over piece pairs (i, j), i + j ≤ 2, smallest order first, of
    A_i @ B_j: each product exact (float64), added to the fp32 accumulator
    with one rounding, as one mma.sync each."""
    for s in (2, 1, 0):
        for i, a in enumerate(A):
            j = s - i
            if 0 <= j < len(B):
                acc = (acc.to(F64) + a.to(F64) @ B[j].to(F64)).to(F32)
    return acc


def seq_sum(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Σ over ``dim`` in index order, fp32."""
    s = x.select(dim, 0)
    for i in range(1, x.shape[dim]):
        s = s + x.select(dim, i)
    return s


def slice_sums(p: torch.Tensor) -> torch.Tensor:
    """(..., 64) → (...): each lane's 4 channels in order, then the 16
    lanes' partials in lane order (the kernel's pairwise sums)."""
    p = p.reshape(*p.shape[:-1], KQ, p.shape[-1] // KQ)
    return seq_sum(seq_sum(p, -1), -1)


def chunked_model(r, k, v, w, u, state=None, *, out_dtype=None, split=True,
                  factors=None):
    """The kernel's ``(y, final state)``; ``split=False`` rounds each fp32
    operand once to bf16 instead; ``factors`` (a list) collects the largest
    decay factor formed in each sub-chunk."""
    B, H, T, Dk = r.shape
    Dv = v.shape[-1]
    D = 64
    nc = -(-T // CHUNK)
    pad = nc * CHUNK - T

    def padded(x, fill, width):
        x = x.float()
        x = torch.cat([x, torch.full((B, H, pad, x.shape[-1]), fill)], 2)
        return torch.cat([x, torch.full((B, H, nc * CHUNK, width
                                          - x.shape[-1]), fill)], 3)

    r32, k32, v32 = padded(r, 0.0, D), padded(k, 0.0, D), padded(v, 0.0, D)
    w32 = padded(w, 1.0, D)
    u32 = torch.cat([u.float(), torch.zeros(H, D - Dk)], 1)
    vsplit = v.dtype == F32 and split

    def vp(x):   # V^T pieces: bf16 operands enter exactly
        return pieces(x, True) if vsplit else pieces(x, False)

    def chunk(c, S, out):
        """S^T (B, H, D, D) through chunk c; y^T rows where ``out``."""
        ys = []
        dec = None
        for s in range(CHUNK // SUB):
            t0 = c * CHUNK + s * SUB
            if t0 >= T:
                break
            sl = slice(t0, t0 + SUB)
            rr, kk, ww, vv = r32[:, :, sl], k32[:, :, sl], w32[:, :, sl], \
                v32[:, :, sl]
            cp = torch.ones(B, H, D)
            rd, big = [], 1.0
            for t in range(SUB):
                rd.append(rr[:, :, t] * cp)
                cp = cp * ww[:, :, t]
                big = max(big, float(torch.max(cp)))
            g = cp
            dp = torch.ones(B, H, D)
            kd = [None] * SUB
            for j in range(SUB - 1, -1, -1):
                kd[j] = kk[:, :, j] * dp
                dp = dp * ww[:, :, j]
                big = max(big, float(torch.max(dp)))
            rd, kd = torch.stack(rd, 2), torch.stack(kd, 2)
            dec = g if dec is None else dec * g
            if out:
                P = torch.zeros(B, H, SUB, SUB)
                Kd = kk.clone()   # Kd[j] = k_j Π_{j<s<t} w_s at step t
                for t in range(SUB):
                    if t > 0:
                        Kd[:, :, :t - 1] = Kd[:, :, :t - 1] * ww[:, :, t - 1,
                                                                  None]
                        P[:, :, t, :t] = slice_sums(rr[:, :, t, None]
                                                    * Kd[:, :, :t])
                        big = max(big, float(torch.max(torch.where(
                            kk[:, :, :t] != 0, Kd[:, :, :t].abs()
                            / kk[:, :, :t].abs(), 0.0))))
                    P[:, :, t, t] = slice_sums((rr[:, :, t] * u32) * kk[:, :, t])
                Y = torch.zeros(B, H, D, SUB)
                for q in range(D // 16):
                    ch = slice(16 * q, 16 * q + 16)
                    Y = mma(Y, pieces(S[..., ch], split),
                            pieces(rd[..., ch].transpose(-1, -2), split))
                Y = mma(Y, vp(vv.transpose(-1, -2)),
                        pieces(P.transpose(-1, -2), split))
                ys.append(Y)
                if s + 1 == CHUNK // SUB or t0 + SUB >= T:
                    break
            S = S * g[:, :, None, :]
            S = mma(S, vp(vv.transpose(-1, -2)), pieces(kd, split))
            if factors is not None:
                factors.append(big)
        return S, dec, ys

    # phase 1: each chunk's own state and decay
    loc, decs = [], []
    for c in range(nc):
        S, dec, _ = chunk(c, torch.zeros(B, H, D, D), False)
        loc.append(S)
        decs.append(dec)
    # phase 2: the scan (S^T layout: the decay scales columns)
    S = torch.zeros(B, H, D, D)
    if state is not None:
        S[:, :, :Dv, :Dk] = state.float().transpose(-1, -2)
    entries = []
    for c in range(nc):
        entries.append(S)
        S = decs[c][:, :, None, :] * S + loc[c]
        if factors is not None:
            factors.append(float(torch.max(decs[c])))
    final = S[:, :, :Dv, :Dk].transpose(-1, -2).contiguous()
    # phase 3: y
    y = torch.cat([Y for c in range(nc) for Y in chunk(c, entries[c],
                                                       True)[2]], -1)
    y = y[:, :, :Dv, :T].transpose(-1, -2)
    return y.to(out_dtype or r.dtype), final


def exact(r, k, v, w, u, state=None):
    """The recurrence in float64."""
    r, k, v, w, u = (x.to(F64) for x in (r, k, v, w, u))
    B, H, T, Dk = r.shape
    S = (torch.zeros(B, H, Dk, v.shape[-1], dtype=F64) if state is None
         else state.to(F64).clone())
    ys = []
    for t in range(T):
        kv = k[:, :, t, :, None] * v[:, :, t, None, :]
        ys.append(torch.sum(r[:, :, t, :, None] * (S + u[None, :, :, None]
                                                   * kv), -2))
        S = w[:, :, t, :, None] * S + kv
    return torch.stack(ys, 2), S


def to(dtype, *xs):
    return [x.to(dtype) for x in xs]


@pytest.mark.parametrize("given", [False, True])
@pytest.mark.parametrize("decay", DECAYS)
@pytest.mark.parametrize("dtype,B,H,T,Dk,Dv", [
    ("fp32", 1, 2, 150, 16, 16), ("bf16", 2, 1, 200, 64, 64),
    ("fp32", 1, 1, 77, 32, 48)])
def test_chunked_model_meets_the_checks(dtype, B, H, T, Dk, Dv, decay,
                                        given):
    tdt = F32 if dtype == "fp32" else torch.bfloat16
    r, k, v, w, u, s0 = inputs(T + Dk, B, H, T, Dk, Dv, decay, state=given)
    r, k, v, u = to(tdt, r, k, v, u)
    y, S = chunked_model(r, k, v, w, u, s0)
    y_p, S_p = ref.wkv6(r, k, v, w, u, s0)
    m_y, m_S = testing.wkv6_terms(r, k, v, w, u, s0)
    bf16 = dtype == "bf16"
    testing.assert_within_terms(y, y_p, m_y, bf16, "y vs the recurrence")
    testing.assert_within_terms(S, S_p, m_S, False, "state vs the recurrence")
    testing.assert_attention_close(y, y_p, bf16, "y")
    testing.assert_close(S, S_p, "state")
    if not given:
        want = np.asarray(jref.wkv6(*(jnp.asarray(x.float().numpy()).astype(
            jnp.bfloat16 if bf16 else jnp.float32) for x in (r, k, v)),
            jnp.asarray(w.numpy()), jnp.asarray(u.float().numpy())
            ).astype(jnp.float32))
        testing.assert_within_terms(y, want, m_y, bf16, "y vs JAX ref.wkv6")


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_the_exact_sum_fails_the_unchanged_check_at_the_model_decay(dtype):
    """N(0, 1) operands at the model's init decay, one head, T = 256: the
    float64 recurrence parts from the fp32 plain version beyond RTOL/ATOL
    (y, where the terms cancel), yet both it and the chunked model stay
    within the error model."""
    tdt = F32 if dtype == "fp32" else torch.bfloat16
    r, k, v, w, u, _ = inputs(3, 1, 1, 256, 64, 64, "model", scale=1.0)
    r, k, v, u = to(tdt, r, k, v, u)
    y_p, S_p = ref.wkv6(r, k, v, w, u, out_dtype=F32)
    y_x, S_x = exact(r, k, v, w, u)
    y_c, S_c = chunked_model(r, k, v, w, u, out_dtype=F32)
    m_y, m_S = testing.wkv6_terms(r, k, v, w, u)
    with pytest.raises(AssertionError):
        testing.assert_close(y_x.float(), y_p, "exact y")
    for y, S in ((y_x.float(), S_x.float()), (y_c, S_c)):
        testing.assert_within_terms(y, y_p, m_y, False, "y")
        testing.assert_within_terms(S, S_p, m_S, False, "state")


@pytest.mark.parametrize("decay", ["fast", 0.5])
def test_split_meets_the_check_and_one_bf16_rounding_does_not(decay):
    """fp32 operands: the three-piece split meets RTOL/ATOL and the error
    model; rounding each fp32 operand once to bf16 (8 significant bits)
    fails both."""
    r, k, v, w, u, s0 = inputs(11, 1, 2, 150, 64, 64, decay, scale=1.0,
                               state=True)
    y_p, S_p = ref.wkv6(r, k, v, w, u, s0)
    m_y, m_S = testing.wkv6_terms(r, k, v, w, u, s0)
    y, S = chunked_model(r, k, v, w, u, s0)
    testing.assert_close(y, y_p, "split y")
    testing.assert_close(S, S_p, "split state")
    testing.assert_within_terms(y, y_p, m_y)
    y1, S1 = chunked_model(r, k, v, w, u, s0, split=False)
    with pytest.raises(AssertionError):
        testing.assert_close(y1, y_p, "one bf16 y")
    with pytest.raises(AssertionError):
        testing.assert_close(S1, S_p, "one bf16 state")
    assert testing.terms_ratio(y1, y_p, m_y) > testing.WKV_TERMS_RTOL
    assert testing.terms_ratio(S1, S_p, m_S) > testing.WKV_TERMS_RTOL


@pytest.mark.parametrize("decay", [1e-6, 0.05, 0.5, 1.0])
def test_every_decay_factor_is_at_most_one(decay):
    """No factor the model forms exceeds 1 (products of w ≤ 1 from the later
    step back), so w = 1e-6 underflows to the negligible terms it stands
    for: every output finite, within the error model."""
    r, k, v, w, u, s0 = inputs(5, 1, 2, 140, 16, 16, decay, scale=1.0,
                               state=True)
    factors = []
    y, S = chunked_model(r, k, v, w, u, s0, factors=factors)
    assert factors and max(factors) <= 1.0
    assert bool(torch.isfinite(y).all() and torch.isfinite(S).all())
    y_p, S_p = ref.wkv6(r, k, v, w, u, s0)
    m_y, m_S = testing.wkv6_terms(r, k, v, w, u, s0)
    testing.assert_within_terms(y, y_p, m_y)
    testing.assert_within_terms(S, S_p, m_S)


@pytest.mark.parametrize("split", [64, 128])
def test_two_calls_split_on_a_chunk_boundary_give_the_bits_of_one(split):
    r, k, v, w, u, s0 = inputs(7, 2, 1, 200, 16, 16, "fast", state=True)
    y, S = chunked_model(r, k, v, w, u, s0)
    y1, S1 = chunked_model(*(a[:, :, :split] for a in (r, k, v, w)), u, s0)
    y2, S2 = chunked_model(*(a[:, :, split:] for a in (r, k, v, w)), u, S1)
    assert torch.equal(torch.cat([y1, y2], 2), y) and torch.equal(S2, S)


def test_chunked_kernel_raises_on_cpu_tensors():
    """No fallback: the chunked kernel's wrapper takes CUDA tensors only
    (ops.wkv6 takes the plain version on the CPU, and no call is
    dispatched to the chunked kernel)."""
    r, k, v, w, u, s0 = inputs(3, 1, 2, 70, 16, 16, "model", state=True)
    with pytest.raises(ValueError, match="CUDA tensors"):
        wkv_mod.launch_chunked(r, k, v, w, u, s0)


@pytest.mark.parametrize("decay", DECAYS)
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_chunked_kernel_matches_plain_on_card(cuda, dtype, decay):  # noqa: F811
    """The kernel against the plain recurrence: the error model at every
    decay; RTOL/ATOL too at these magnitudes (scale 0.3)."""
    tdt = F32 if dtype == "fp32" else torch.bfloat16
    r, k, v, w, u, s0 = inputs(1, 2, 3, 300, 64, 64, decay, state=True)
    r, k, v, u = (x.to(cuda, tdt) for x in (r, k, v, u))
    w, s0 = w.to(cuda), s0.to(cuda)
    y, S = wkv_mod.launch_chunked(r, k, v, w, u, s0)
    torch.cuda.synchronize()
    y_p, S_p = ref.wkv6(r, k, v, w, u, s0)
    m_y, m_S = testing.wkv6_terms(r, k, v, w, u, s0)
    testing.assert_within_terms(y, y_p, m_y, dtype == "bf16")
    testing.assert_within_terms(S, S_p, m_S)
    testing.assert_attention_close(y, y_p, dtype == "bf16", "wkv6 y")
    testing.assert_close(S, S_p, "wkv6 state")
