"""The ``flash_attention`` backward's tensor-core design on the CPU: which
(dtype, D) take it (``flash_attention.bwd_route``), and a plain model of
its arithmetic held against autograd of the plain attention in float64.

The model follows ``csrc/flash_attention_bwd.cu``'s tensor-core kernels:
bf16 q, k, v and dO; S = q·k and dP = dO·v accumulated in fp32 (the
products of bf16 values are exact in fp32); P = exp(S·scale − lse) from
the forward's fp32 log-sum-exp; Δ = rowsum(dO ∘ O) from the forward's bf16
output; dS = P (dP − Δ); P and dS each issued as ONE bf16 operand (no
hi/lo split); dV = Pᵀ dO, dK = scale dSᵀ q, dQ = scale dS k accumulated
in fp32, a group's heads summed in order; the gradients rounded to bf16.
Its distance to the float64 gradients is what the card's kernels are held
to (``testing.ATTN_GRAD_TOL[bf16]``, 2⁻⁶ of the largest |value|): the
model reads ≤ 0.0049 at these shapes, with P and dS each split into two
bf16 parts ≤ 0.0035, so one bf16 operand each is kept (five products on
the tensor cores as the bound counts them, and S and dP issued again by
the dQ kernel: 7 issued for the bound's 5).

The float64 reference itself is held against ``jax.grad`` of the JAX
package's ``ref.flash_attention`` (fp32, ``ATTN_GRAD_TOL[fp32]``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch import testing
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ref


def _mask(S, T, causal):
    if not causal:
        return torch.ones((S, T), dtype=torch.bool)
    return (torch.arange(T)[None, :]
            <= torch.arange(S)[:, None] + (T - S))


def _grads64(q, k, v, do, causal):
    """(dq, dk, dv) by autograd of the plain attention in float64 (the
    formula of ``ref.flash_attention``: GQA by head groups, the causal
    mask with the (T − S) offset, masked logits at −1e30)."""
    G = q.shape[1] // k.shape[1]
    qq, kk, vv = (t.double().requires_grad_(True) for t in (q, k, v))
    s = torch.einsum("bhsd,bhtd->bhst", qq, kk.repeat_interleave(G, 1))
    s = s / q.shape[-1] ** 0.5
    s = torch.where(_mask(q.shape[2], k.shape[2], causal), s,
                    torch.tensor(-1e30, dtype=torch.float64))
    o = torch.einsum("bhst,bhtd->bhsd", torch.softmax(s, -1),
                     vv.repeat_interleave(G, 1))
    return torch.autograd.grad(o, (qq, kk, vv), do.double())


def tensor_core_model(q, k, v, do, causal, hi_lo=(False, False)):
    """The tensor-core backward's arithmetic in plain PyTorch (see the
    module's note): ``(dq, dk, dv)`` in bf16.  ``hi_lo``: issue (P, dS) as
    hi = bf16(x) plus lo = bf16(x − hi) instead of one bf16 value (the
    choice the kernel did not take)."""
    B, H, S, D = q.shape
    Hkv, T = k.shape[1], k.shape[2]
    G = H // Hkv
    scale = 1.0 / D ** 0.5
    qf, kf, vf, dof = (t.float() for t in (q, k, v, do))
    kr, vr = kf.repeat_interleave(G, 1), vf.repeat_interleave(G, 1)
    mask = _mask(S, T, causal)
    s = torch.where(mask, torch.einsum("bhsd,bhtd->bhst", qf, kr) * scale,
                    torch.tensor(ref.NEG_INF))
    lse = torch.logsumexp(s, -1, keepdim=True)          # the forward's, fp32
    p = torch.where(mask, torch.exp(s - lse), torch.tensor(0.0))
    o = torch.einsum("bhst,bhtd->bhsd", p, vr).to(torch.bfloat16).float()
    delta = (dof * o).sum(-1, keepdim=True)
    ds = p * (torch.einsum("bhsd,bhtd->bhst", dof, vr) - delta)

    def issue(x, two):
        hi = x.to(torch.bfloat16).float()
        return hi + (x - hi).to(torch.bfloat16).float() if two else hi

    pb, dsb = issue(p, hi_lo[0]), issue(ds, hi_lo[1])
    dv_h = torch.einsum("bhst,bhsd->bhtd", pb, dof).reshape(B, Hkv, G, T, D)
    dk_h = torch.einsum("bhst,bhsd->bhtd", dsb, qf).reshape(B, Hkv, G, T, D)

    def fold(x):
        """A group's heads summed in order, as the dK/dV CTA walks them."""
        out = x[:, :, 0]
        for g in range(1, G):
            out = out + x[:, :, g]
        return out

    dq = scale * torch.einsum("bhst,bhtd->bhsd", dsb, kr)
    return (dq.to(torch.bfloat16), (scale * fold(dk_h)).to(torch.bfloat16),
            fold(dv_h).to(torch.bfloat16))


def _inputs(seed, B, Hkv, G, S, T, D):
    r = np.random.default_rng(seed)
    shapes = ((B, Hkv * G, S, D), (B, Hkv, T, D), (B, Hkv, T, D),
              (B, Hkv * G, S, D))
    return [torch.from_numpy(r.standard_normal(s).astype(np.float32))
            .to(torch.bfloat16) for s in shapes]


@pytest.mark.parametrize("D", [16, 64, 128, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bwd_route(dtype, D):
    """bf16 at D ∈ {64, 128} on the tensor cores; fp32 (TF32 products
    would miss the fp32 bound of 2e-5) and D ∈ {16, 256} on the CUDA
    cores."""
    want = ("wgmma" if dtype == torch.bfloat16 and D in (64, 128)
            else "cuda_cores")
    assert fa.bwd_route(dtype, D) == want
    if want == "wgmma":
        assert fa.prefill_route(dtype, D) == "wgmma"


@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("G", [1, 4])
@pytest.mark.parametrize("S", [256, 333])
def test_tensor_core_model_within_bound(S, G, causal, D):
    q, k, v, do = _inputs(S + 10 * G + D + causal, 1, 2, G, S, S, D)
    want = _grads64(q, k, v, do, causal)
    got = tensor_core_model(q, k, v, do, causal)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        testing.assert_grad_close(a, b, torch.bfloat16,
                                  f"model {name} S={S} G={G}")


@pytest.mark.parametrize("S,T,causal", [(77, 200, True), (50, 333, False),
                                        (1, 9, False), (1, 5, True)])
def test_tensor_core_model_at_offsets_and_one_row(S, T, causal):
    """The shapes of chip_smoke's backward phase: the causal offset T − S,
    non-causal S ≠ T, and a single query row."""
    q, k, v, do = _inputs(S + T, 2, 2, 4, S, T, 64)
    want = _grads64(q, k, v, do, causal)
    got = tensor_core_model(q, k, v, do, causal)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        testing.assert_grad_close(a, b, torch.bfloat16, name)


def test_hi_lo_split_changes_little():
    """Issuing P and dS as two bf16 parts each moves the model by less than
    a quarter of the bound: one bf16 operand each is what the kernel
    issues."""
    q, k, v, do = _inputs(7, 1, 2, 4, 256, 256, 128)
    want = _grads64(q, k, v, do, True)
    one = tensor_core_model(q, k, v, do, True)
    two = tensor_core_model(q, k, v, do, True, hi_lo=(True, True))
    for a, b, w in zip(one, two, want):
        s1, s2 = testing.grad_share(a, w), testing.grad_share(b, w)
        assert s1 <= testing.ATTN_GRAD_TOL[torch.bfloat16] / 2
        assert abs(s1 - s2) <= testing.ATTN_GRAD_TOL[torch.bfloat16] / 4


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("S,T,G", [(24, 24, 1), (5, 37, 4)])
def test_float64_reference_matches_jax_grad(S, T, G, causal):
    """The float64 gradients the model is held to, against ``jax.grad`` of
    the JAX package's reference on the same (bf16-valued) inputs in
    fp32."""
    q, k, v, do = _inputs(S * T + G, 2, 2, G, S, T, 64)
    want = _grads64(q, k, v, do, causal)
    arrs = [t.float().numpy() for t in (q, k, v, do)]

    def loss(q, k, v):
        return jnp.sum(jref.flash_attention(q, k, v, causal=causal)
                       * arrs[3])

    got = jax.grad(loss, argnums=(0, 1, 2))(*arrs[:3])
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        testing.assert_grad_close(np.asarray(a), b, torch.float32, name)


def test_launch_backward_takes_cuda_tensors_only():
    q, k, v, do = _inputs(3, 1, 1, 2, 8, 8, 64)
    lse = torch.zeros((1, 2, 8))
    with pytest.raises(ValueError, match="CUDA"):
        fa.launch_backward(q, k, v, q, lse, do, causal=True, scale=0.125)
