"""The port's ``flash_attention`` against the JAX package on the CPU: its
plain version against ``repro.kernels.ref.flash_attention`` and against
``flash_attention_pallas`` in interpret mode (where the shape meets its
``S % bq`` rule), in fp32 and bf16, with GQA groups 1/2/4, D 16/64, causal
or not, S = T and S < T, ``kv_valid_len``, and S > 1,024 (the query
chunks); the dispatch on CPU tensors; and the CUDA kernel against its plain
version on a card.

Tolerance: ``repro_torch.testing`` — fp32 within RTOL = ATOL = 1e-5 (sums
in another order); bf16 within one bf16 ulp more (``BF16_RTOL``: the two
fp32 results may round to neighbouring bf16 values).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention_pallas
from repro_torch import testing
from repro_torch.kernels import flash_attention as fa_mod
from repro_torch.kernels import ops, ref

from _torch_parity import cuda  # noqa: F401

DTYPES = {"fp32": (torch.float32, jnp.float32),
          "bf16": (torch.bfloat16, jnp.bfloat16)}


def _qkv(seed, B, H, Hkv, S, T, D):
    r = np.random.default_rng(seed)
    return (r.standard_normal((B, H, S, D)).astype(np.float32),
            r.standard_normal((B, Hkv, T, D)).astype(np.float32),
            r.standard_normal((B, Hkv, T, D)).astype(np.float32))


def _both(arrs, dtype):
    tdt, jdt = DTYPES[dtype]
    return ([torch.from_numpy(a).to(tdt) for a in arrs],
            [jnp.asarray(a, jdt) for a in arrs])


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("S,T", [(24, 24), (5, 37)])
@pytest.mark.parametrize("D", [16, 64])
@pytest.mark.parametrize("group", [1, 2, 4])
def test_attention_plain_matches_jax_ref(group, D, S, T, causal, dtype):
    Hkv = 2
    arrs = _qkv(group * D + S, 2, Hkv * group, Hkv, S, T, D)
    (q, k, v), (jq, jk, jv) = _both(arrs, dtype)
    got = ops.flash_attention(q, k, v, causal=causal)
    assert got.shape == q.shape and got.dtype == q.dtype
    want = jref.flash_attention(jq, jk, jv, causal=causal)
    testing.assert_attention_close(got, want, dtype == "bf16")


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("S,kv_valid_len", [(1, 1), (1, 23), (1, 40),
                                            (3, 17)])
@pytest.mark.parametrize("group", [1, 4])
def test_attention_kv_valid_len_matches_jax_ref(group, S, kv_valid_len,
                                                dtype):
    """Decode against a partially filled cache of T = 40: keys at or past
    kv_valid_len take no part (the cache past them holds other values)."""
    arrs = _qkv(kv_valid_len + group, 1, 2 * group, 2, S, 40, 16)
    (q, k, v), (jq, jk, jv) = _both(arrs, dtype)
    got = ops.flash_attention(q, k, v, causal=False,
                              kv_valid_len=kv_valid_len)
    want = jref.flash_attention(jq, jk, jv, causal=False,
                                kv_valid_len=kv_valid_len)
    testing.assert_attention_close(got, want, dtype == "bf16")
    # the keys past kv_valid_len do not matter
    k2, v2 = k.clone(), v.clone()
    k2[:, :, kv_valid_len:] = 7.0
    v2[:, :, kv_valid_len:] = -3.0
    assert torch.equal(ops.flash_attention(q, k2, v2, causal=False,
                                           kv_valid_len=kv_valid_len), got)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_attention_query_chunks_match_jax_ref(dtype):
    """S = T = 2,048 > 1,024 runs the queries in two chunks, as there."""
    arrs = _qkv(7, 1, 2, 1, 2048, 2048, 16)
    (q, k, v), (jq, jk, jv) = _both(arrs, dtype)
    got = ops.flash_attention(q, k, v)
    testing.assert_attention_close(got, jref.flash_attention(jq, jk, jv),
                                   dtype == "bf16")
    # the chunked plain version is the unchunked one (no chunk boundary
    # leaks into the causal offset)
    whole = ref.flash_attention(q[:, :, 1:], k, v)
    testing.assert_attention_close(got[:, :, 1:], whole, dtype == "bf16")


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("S,T,group", [(32, 32, 1), (16, 48, 2),
                                       (32, 64, 4)])
def test_attention_plain_matches_pallas_interpret(S, T, group, causal):
    arrs = _qkv(S + T + group, 1, 2 * group, 2, S, T, 16)
    (q, k, v), (jq, jk, jv) = _both(arrs, "fp32")
    want = flash_attention_pallas(jq, jk, jv, causal=causal, bq=16, bk=16,
                                  interpret=True)
    testing.assert_attention_close(ops.flash_attention(q, k, v,
                                                       causal=causal),
                                   want, False)


def test_ops_attention_on_cpu_is_the_plain_version():
    q, k, v = (torch.from_numpy(a) for a in _qkv(3, 2, 4, 2, 9, 13, 16))
    for kw in ({}, {"causal": False}, {"kv_valid_len": 6, "causal": False},
               {"scale": 0.3}):
        assert torch.equal(ops.flash_attention(q, k, v, **kw),
                           ref.flash_attention(q, k, v, **kw))


def test_attention_launcher_refuses_cpu_tensors():
    """The kernel wrapper launches on CUDA tensors only: a CPU tensor is an
    error, not a quiet run of the plain version."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(4, 1, 2, 1, 4, 4, 16))
    with pytest.raises(ValueError, match="CUDA"):
        fa_mod.launch(q, k, v, causal=True, scale=0.25)


def test_card_tensors_go_to_the_kernel_and_raise_without_one(monkeypatch):
    """A tensor the dispatch takes for a card's goes to the kernel wrapper,
    never to the plain version: here, with no card, that raises."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(5, 1, 2, 1, 4, 4, 16))
    monkeypatch.setattr(ops, "_on_card", lambda t: True)
    monkeypatch.setattr(ref, "flash_attention", None)   # no way back
    with pytest.raises(ValueError, match="CUDA"):
        ops.flash_attention(q, k, v)
    with pytest.raises(ValueError, match="CUDA"):
        ops.flash_attention(q[:, :, :1], k, v, kv_valid_len=3)


def test_non_cpu_tensor_never_falls_back_to_plain_attention():
    """Neither on the CPU nor on a card (nor ``meta``, the dry run's
    stand-in for the card): a fake tensor on another device raises."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode():
        q = torch.empty((1, 2, 4, 16), device="xla")
        k = torch.empty((1, 1, 4, 16), device="xla")
    with pytest.raises(RuntimeError, match="no kernel"):
        ops.flash_attention(q, k, k)


@pytest.mark.parametrize("per_sm,warps", [(2, 4), (1, 1), (3, 2)])
@pytest.mark.parametrize("B,Hkv,G,kv", [(8, 8, 4, 2080), (1, 1, 1, 1),
                                        (1, 8, 4, 32768), (64, 8, 4, 100),
                                        (2, 1, 32, 777), (8, 8, 4, 15),
                                        (8, 8, 4, 17), (1, 1, 8, 1000),
                                        (40, 8, 1, 250), (256, 8, 4, 4096),
                                        (1, 1, 1, 131072)])
def test_decode_splits_cover_the_valid_keys(B, Hkv, G, kv, per_sm, warps):
    sms, tile = 132, fa_mod.DECODE_TILE
    nsplit, chunk = fa_mod.decode_splits(B, Hkv, G, kv, sms, per_sm, warps)
    assert chunk % tile == 0 and nsplit >= 1
    assert (nsplit - 1) * chunk < kv <= nsplit * chunk   # none empty
    ctas = B * Hkv * -(-G // fa_mod.DECODE_HEADS)
    slots = sms * per_sm
    tiles = -(-kv // tile)
    if ctas < 132 and kv > chunk:
        assert nsplit > 1

    def chain(splits):   # tiles a warp walks
        return -(-(-(-tiles // splits)) // warps)

    # each warp walks a short chain, and the grid takes the fewest whole
    # waves of resident CTAs that give one: the splits of a wave less
    # would not
    assert chain(nsplit) <= fa_mod.DECODE_CHAIN
    waves = -(-nsplit * ctas // slots)
    fewer = max(1, (waves - 1) * slots // ctas)
    if waves > 1 and fewer < nsplit:
        assert chain(fewer) > fa_mod.DECODE_CHAIN
    if waves == 1:   # as many splits as a wave holds, at most one a warp
        most = min(slots // ctas, -(-tiles // warps))
        assert nsplit == -(-kv // (-(-tiles // most) * tile))


def test_decode_splits_fill_one_wave_at_the_serving_shape():
    """B = 8, Hkv = 8, G = 4, T = 2,080 on 132 SMs of two 4-warp CTAs: 64
    CTAs a split, so 4 splits of 528 keys fill one wave of 264 slots, and
    each warp walks 9 tiles of 16 keys."""
    assert fa_mod.decode_splits(8, 8, 4, 2080, 132, 2, 4) == (4, 528)


@pytest.mark.parametrize("D", [8, 16, 32, 64, 128, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
def test_prefill_route(dtype, D):
    """bf16 at D ∈ {64, 128, 256} runs on the tensor cores; fp32 operands
    and every other head dim keep the CUDA-core kernel."""
    want = ("wgmma" if dtype == torch.bfloat16 and D in (64, 128, 256)
            else "cuda_cores")
    assert fa_mod.prefill_route(dtype, D) == want


def _split_p_attention(q, k, v, *, split: bool, bk: int = 128):
    """The tensor-core prefill's arithmetic on the CPU, causal: fp32 logits
    of bf16 q, k; an online softmax over tiles of ``bk`` keys in the log2
    domain (the scale times log2 e on the fp32 logits); P rounded to bf16
    for P·V, either once or split into hi = bf16(p) and lo = bf16(p − hi)
    with two products into one fp32 accumulator; l the sum of the fp32 p.
    Products of bf16 values are exact in fp32, as on the tensor cores."""
    B, H, S, D = q.shape
    T = k.shape[2]
    c = float(np.float32(1.0 / D ** 0.5 * np.log2(np.e)))
    kf, vf = k.float(), v.float()
    qpos = torch.arange(S)[:, None] + (T - S)
    m = torch.full((B, H, S, 1), -1e30)
    l = torch.zeros((B, H, S, 1))
    o = torch.zeros((B, H, S, D))
    for k0 in range(0, T, bk):
        s = q.float() @ kf[:, :, k0:k0 + bk].transpose(-1, -2)
        kpos = torch.arange(k0, min(T, k0 + bk))[None, :]
        s = torch.where(kpos <= qpos, s, torch.tensor(-1e30))
        mn = torch.maximum(m, s.amax(-1, keepdim=True) * c)
        alpha = torch.exp2(m - mn)
        p = torch.exp2(s * c - mn)
        m = mn
        l = alpha * l + p.sum(-1, keepdim=True)
        hi = p.bfloat16().float()
        pv = hi @ vf[:, :, k0:k0 + bk]
        if split:
            pv = pv + (p - hi).bfloat16().float() @ vf[:, :, k0:k0 + bk]
        o = alpha * o + pv
    return (o / l).bfloat16()


def test_split_p_meets_the_bf16_check_and_one_bf16_p_does_not():
    """Why the tensor-core prefill splits P: at D = 128, S = T = 256,
    causal, P split in two bf16 parts agrees with the plain version within
    the unchanged bf16 check; P rounded once to bf16 (what a single bf16
    product does) fails it."""
    q, k, v = (torch.from_numpy(a).bfloat16()
               for a in _qkv(16, 1, 2, 1, 256, 256, 128))
    want = ref.flash_attention(q, k, v, causal=True)
    testing.assert_attention_close(_split_p_attention(q, k, v, split=True),
                                   want, True)
    with pytest.raises(AssertionError):
        testing.assert_attention_close(
            _split_p_attention(q, k, v, split=False), want, True)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("B,H,Hkv,S,T,D,causal,kvl", [
    (2, 8, 2, 77, 77, 128, True, None), (1, 4, 1, 33, 100, 64, True, None),
    (2, 4, 4, 1, 300, 256, False, 151), (1, 32, 8, 1, 2080, 128, False,
                                         2080)])
def test_attention_kernel_matches_plain_on_card(cuda, dtype, B, H, Hkv, S,  # noqa: F811
                                                T, D, causal, kvl):
    tdt = DTYPES[dtype][0]
    q, k, v = (torch.from_numpy(a).to(cuda, tdt)
               for a in _qkv(S + T, B, H, Hkv, S, T, D))
    got = ops.flash_attention(q, k, v, causal=causal, kv_valid_len=kvl)
    torch.cuda.synchronize()
    testing.assert_attention_close(
        got, ref.flash_attention(q, k, v, causal=causal, kv_valid_len=kvl),
        dtype == "bf16")


@pytest.mark.parametrize("strided", [True, False])
@pytest.mark.parametrize("group", [1, 4, 8])
@pytest.mark.parametrize("D", [64, 128, 256])
@pytest.mark.parametrize("S,T", [(127, 127), (128, 128), (129, 129),
                                 (127, 129), (128, 129), (129, 257)])
def test_attention_kernel_tile_edges_on_card(cuda, S, T, D, group,  # noqa: F811
                                             strided):
    """The tensor-core prefill at its tiles' edges (128 queries, 128 or 32
    keys), bf16, causal, on contiguous operands and on the model's
    (B, S, H, D) projections seen as (B, H, S, D)."""
    B, Hkv = 2, 2
    arrs = _qkv(S + T + D + group, B, Hkv * group, Hkv, S, T, D)
    if strided:
        q, k, v = (torch.from_numpy(a.transpose(0, 2, 1, 3).copy())
                   .to(cuda, torch.bfloat16).transpose(1, 2) for a in arrs)
    else:
        q, k, v = (torch.from_numpy(a).to(cuda, torch.bfloat16)
                   for a in arrs)
    before = ops.launch_counts["flash_attention_prefill_wgmma"]
    got = ops.flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert ops.launch_counts["flash_attention_prefill_wgmma"] == before + 1
    testing.assert_attention_close(
        got, ref.flash_attention(q, k, v, causal=True), True)
