"""Attention: the CUDA kernel's launch wrapper and its plain version.

Replaces the TPU kernel ``repro.kernels.flash_attention.
flash_attention_pallas`` (``src/repro/kernels/flash_attention.py:69``,
``pl.pallas_call`` at ``:91``).  Source: ``csrc/flash_attention.cu``.

An online softmax over KV tiles, GQA by head groups (query head ``h`` reads
KV head ``h // (H / Hkv)``), the causal mask ``kpos ≤ qpos + (T − S)`` and
the ``kv_valid_len`` mask; logits, softmax state and accumulator in fp32;
the output in ``q.dtype``.  ``S > 1`` launches a prefill kernel, chosen by
:func:`prefill_route`: bf16 at D ∈ {64, 128, 256} (the model path) runs
on the tensor cores (``wgmma`` over K/V tiles brought by TMA into a ring
of shared-memory stages, a producer warp, P split into two bf16 parts for
P·V); fp32 operands and D = 16 run on the CUDA cores.  ``S == 1``
launches the decode kernel once: the valid keys cut into splits (see
:func:`decode_splits`), each warp of a CTA walking its own 16-key tiles,
the last CTA of each (b, KV head, head group) folding the splits.
Operands are read through their strides (the last axis contiguous, rows
on 16-byte boundaries; a view that is not is copied first), fp32 or bf16;
the output is allocated ``(B, S, H, D)`` in memory and returned as its
``(B, H, S, D)`` view, so the model's ``transpose(1, 2).reshape(B, S,
H·D)`` copies nothing.

What bounds it on the H100: operations at prefill, bytes at decode (see
the note at the head of the source).

Training: :func:`launch` with ``with_lse=True`` takes a prefill kernel at
any S (S = 1 too) and leaves each query row's fp32 log-sum-exp, which
:func:`launch_backward` reads: the backward of ``csrc/
flash_attention_bwd.cu`` (a dK/dV kernel per key tile that walks the
query heads of its KV group, a dQ kernel per query tile, Δ =
rowsum(dO ∘ O) from a pre-pass or the dQ kernel; no float atomics, so
the same bits every call), on the route
:func:`bwd_route` gives: bf16 at D ∈ {64, 128} on the tensor cores
(``wgmma`` over TMA rings as the prefill, P and dS each one bf16 operand,
Δ summed by the dQ kernel, 64-key dK/dV CTAs), fp32 and D ∈ {16, 256}
on the CUDA cores.  No TPU kernel precedes the backward: the JAX package
differentiates its jnp reference.

The plain version is :func:`repro_torch.kernels.ref.flash_attention`; the
dispatch in :mod:`repro_torch.kernels.ops` takes it for CPU tensors only.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import flash_attention as plain  # noqa: F401

HEAD_DIMS = (16, 64, 128, 256)   # the instantiations of csrc/flash_attention.cu
WGMMA_HEAD_DIMS = (64, 128, 256)  # those of the tensor-core prefill (bf16)
#: those of the tensor-core backward (bf16): at D = 256 a warpgroup's dV
#: (or dK) alone would take 128 registers a thread (csrc note)
WGMMA_BWD_HEAD_DIMS = (64, 128)
DECODE_TILE = 16                  # keys of a decode warp's tile (csrc DEC_KS)
DECODE_HEADS = 8                  # query heads per decode CTA (csrc DEC_GC)
#: tiles a decode warp walks, at most: at the Qwen3-8B serving shape on an
#: H100 one wave of 9-tile chains (0.039 ms) beat two waves of 5-tile
#: chains (0.047 ms) and 19 splits of 2-tile chains (0.064 ms; measured by
#: ``ab_attention.py --decode-chain``)
DECODE_CHAIN = 16
_GRID_YZ = 65535
_INT_MAX = 2 ** 31 - 1
_sm_count: dict[int, int] = {}
_decode_shape: dict[tuple, tuple[int, int]] = {}
_tickets: dict[tuple[int, int], torch.Tensor] = {}


def prefill_route(dtype: torch.dtype, D: int) -> str:
    """The prefill kernel for operands of ``dtype`` at head dim ``D``:
    ``"wgmma"`` (tensor cores, bf16 at D ∈ {64, 128, 256}) or
    ``"cuda_cores"`` (fp32 operands, and D = 16)."""
    return ("wgmma" if dtype == torch.bfloat16 and D in WGMMA_HEAD_DIMS
            else "cuda_cores")


def bwd_route(dtype: torch.dtype, D: int) -> str:
    """The backward's kernels for operands of ``dtype`` at head dim ``D``:
    ``"wgmma"`` (tensor cores, bf16 at D ∈ {64, 128}) or ``"cuda_cores"``
    (fp32 operands, whose products on the tensor cores would be TF32, and
    D ∈ {16, 256})."""
    return ("wgmma" if dtype == torch.bfloat16 and D in WGMMA_BWD_HEAD_DIMS
            else "cuda_cores")


def decode_splits(B: int, Hkv: int, G: int, kv_valid: int, sms: int,
                  per_sm: int = 2, warps: int = 4) -> tuple[int, int]:
    """``(nsplit, chunk)`` of the decode launch: the ``kv_valid`` keys cut
    into splits of ``chunk`` keys (a multiple of the tile, none empty).
    A split is one CTA of ``warps`` warps per (b, KV head, head group), and
    ``sms × per_sm`` CTAs are resident at once (a wave).  The split count
    fills whole waves: the fewest waves ``w`` whose ``⌊w·slots / ctas⌋``
    splits give each warp at most :data:`DECODE_CHAIN` tiles, or as many
    splits as give every warp one tile."""
    ctas = B * Hkv * -(-G // DECODE_HEADS)
    slots = sms * per_sm
    tiles = -(-kv_valid // DECODE_TILE)
    cap = max(1, -(-tiles // warps))         # every warp at least one tile
    waves = 1
    while True:
        nsplit = min(max(1, waves * slots // ctas), cap)
        chain = -(-(-(-tiles // nsplit)) // warps)
        if chain <= DECODE_CHAIN or nsplit == cap:
            break
        waves += 1
    chunk = -(-tiles // nsplit) * DECODE_TILE
    return -(-kv_valid // chunk), chunk


def _bhs(t: torch.Tensor) -> tuple[torch.Tensor, int, int, int]:
    """``t`` with its last axis contiguous and its rows on 16-byte
    boundaries (the kernel moves rows 16 bytes at a time), and its (b,
    head, position) strides in elements."""
    size = t.element_size()
    if (t.stride(3) != 1 or t.data_ptr() % 16
            or any(t.stride(i) * size % 16 for i in range(3))):
        t = t.contiguous()
    return t, t.stride(0), t.stride(1), t.stride(2)


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if (q.device.type != "cuda" or k.device != q.device
            or v.device != q.device or q.dim() != 4 or k.dim() != 4
            or v.shape != k.shape or q.dtype not in (torch.float32,
                                                     torch.bfloat16)
            or k.dtype != q.dtype or v.dtype != q.dtype):
        raise ValueError(
            f"flash_attention kernel takes CUDA tensors q (B, H, S, D), "
            f"k and v (B, Hkv, T, D), all fp32 or all bf16, got q "
            f"{q.dtype} {tuple(q.shape)} on {q.device}, k {k.dtype} "
            f"{tuple(k.shape)} on {k.device}, v {v.dtype} {tuple(v.shape)}")
    B, H, S, D = q.shape
    Hkv, T = k.shape[1], k.shape[2]
    if k.shape[0] != B or k.shape[3] != D or Hkv == 0 or H % Hkv:
        raise ValueError(f"flash_attention kernel: q {tuple(q.shape)} and "
                         f"k {tuple(k.shape)} do not pair up (H % Hkv == 0)")
    if D not in HEAD_DIMS:
        raise ValueError(f"flash_attention kernel: head dim {D} is not one "
                         f"of its instantiations {HEAD_DIMS}")
    if not (B <= _GRID_YZ and H <= _GRID_YZ and S <= _INT_MAX
            and T <= _INT_MAX):
        raise ValueError(f"flash_attention kernel: unsupported shape B={B} "
                         f"H={H} S={S} T={T}")


def launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
           causal: bool, scale: float, kv_valid_len=None,
           with_lse: bool = False):
    """The kernel's attention ``(B, H, S, D)`` for q ``(B, H, S, D)`` and
    k, v ``(B, Hkv, T, D)`` on the card, all fp32 or all bf16.  With
    ``with_lse`` (training; no ``kv_valid_len``) a prefill kernel runs at
    any S and the result is ``(out, lse)``, ``lse`` ``(B, H, S)`` fp32."""
    _check(q, k, v)
    B, H, S, D = q.shape
    Hkv, T = k.shape[1], k.shape[2]
    if with_lse and kv_valid_len is not None:
        raise ValueError("flash_attention kernel: the backward takes no "
                         "kv_valid_len (training never passes one)")
    kv = T if kv_valid_len is None else min(int(kv_valid_len), T)
    if kv < 1:
        raise ValueError(f"flash_attention kernel: kv_valid_len "
                         f"{kv_valid_len} leaves a query no key")
    if causal and S > 1 and S > T:
        raise ValueError(f"flash_attention kernel: causal attention needs "
                         f"T >= S (got S={S}, T={T}): the first queries "
                         "would see no key")
    out = torch.empty((B, S, H, D), dtype=q.dtype,
                      device=q.device).transpose(1, 2)
    lse = (torch.empty((B, H, S), dtype=torch.float32, device=q.device)
           if with_lse else None)
    if B == 0 or S == 0 or H == 0:
        return (out, lse) if with_lse else out
    q, *sq = _bhs(q)
    k, *sk = _bhs(k)
    v, *sv = _bhs(v)
    so = [out.stride(0), out.stride(1), out.stride(2)]
    scale32 = float(np.float32(scale))
    bf16 = int(q.dtype == torch.bfloat16)
    lib = _build.load("flash_attention")
    stream = torch.cuda.current_stream(q.device).cuda_stream
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            *sq, *sk, *sv, *so)
    lse_ptr = None if lse is None else lse.data_ptr()
    if S == 1 and not with_lse:
        dev = q.device.index
        G = H // Hkv
        if dev not in _sm_count:
            _sm_count[dev] = torch.cuda.get_device_properties(
                q.device).multi_processor_count
        key = (dev, D, bf16, min(G, DECODE_HEADS))
        if key not in _decode_shape:
            per_sm = lib.flash_attention_decode_shape(D, bf16, G, 0)
            if per_sm < 1:
                raise RuntimeError(f"flash_attention (decode): no CTA of "
                                   f"D={D} fits an SM (CUDA {-per_sm})")
            _decode_shape[key] = (
                per_sm, lib.flash_attention_decode_shape(D, bf16, G, 1))
        per_sm, warps = _decode_shape[key]
        nsplit, chunk = decode_splits(B, Hkv, G, kv, _sm_count[dev],
                                      per_sm, warps)
        scratch = [None, None, None]
        if nsplit > 1:
            scratch = [torch.empty((nsplit, B, H, D), dtype=torch.float32,
                                   device=q.device),
                       torch.empty((nsplit, B, H, 2), dtype=torch.float32,
                                   device=q.device),
                       _ticket_buffer(q.device, stream,
                                      B * Hkv * -(-G // DECODE_HEADS))]
        _build.check(lib.flash_attention_decode_launch(
            *ptrs, B, H, Hkv, D, kv, chunk, nsplit, scale32, bf16,
            *(None if t is None else t.data_ptr() for t in scratch), stream),
            "flash_attention (decode)")
        _build.launch_counts["flash_attention_decode"] += 1
    elif prefill_route(q.dtype, D) == "wgmma":
        # TMA takes a stride only where the dim is longer than one
        dims = {"q": (B, H, S), "k": (B, Hkv, T), "v": (B, Hkv, T)}
        for name, st in (("q", sq), ("k", sk), ("v", sv)):
            st[:] = [s if n > 1 else D for s, n in zip(st, dims[name])]
        _build.check(lib.flash_attention_prefill_wgmma_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            *sq, *sk, *sv, *so, B, H, Hkv, S, T, D, kv, int(bool(causal)),
            scale32, lse_ptr, stream), "flash_attention (prefill, wgmma)")
        _build.launch_counts["flash_attention_prefill"] += 1
        _build.launch_counts["flash_attention_prefill_wgmma"] += 1
    else:
        _build.check(lib.flash_attention_prefill_launch(
            *ptrs, B, H, Hkv, S, T, D, kv, int(bool(causal)), scale32, bf16,
            lse_ptr, stream), "flash_attention (prefill)")
        _build.launch_counts["flash_attention_prefill"] += 1
    if with_lse:
        _build.launch_counts["flash_attention_prefill_lse"] += 1
        return out, lse
    return out


def launch_backward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor, *,
                    causal: bool, scale: float
                    ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(dq, dk, dv)`` of the attention ``o = launch(q, k, v, causal=,
    scale=, with_lse=True)`` for the output's gradient ``do`` (B, H, S,
    D), in the operands' type, from the forward's ``lse``, on the route
    :func:`bwd_route` gives, each launch counted: on the CUDA cores a Δ =
    rowsum(dO ∘ O) pre-pass, dK/dV, dQ; on the tensor cores dQ (whose
    kernel also writes Δ), then dK/dV.  Operands whose rows or strides are
    not on 16-byte boundaries (the tensor-core kernels read them by TMA)
    are copied first, as :func:`launch` copies them.  dq is returned as a
    ``(B, H, S, D)`` view of ``(B, S, H, D)`` memory, dk and dv as views
    of ``(B, T, Hkv, D)``, as the forward returns its output."""
    _check(q, k, v)
    B, H, S, D = q.shape
    Hkv, T = k.shape[1], k.shape[2]
    if (o.shape != q.shape or do.shape != q.shape or o.dtype != q.dtype
            or lse.shape != (B, H, S) or lse.dtype != torch.float32):
        raise ValueError(f"flash_attention backward: o {tuple(o.shape)} "
                         f"{o.dtype}, dO {tuple(do.shape)}, lse "
                         f"{tuple(lse.shape)} {lse.dtype} do not match q "
                         f"{tuple(q.shape)} {q.dtype}")
    if causal and S > T:
        raise ValueError(f"flash_attention backward: causal attention needs "
                         f"T >= S (got S={S}, T={T})")
    dq = torch.empty((B, S, H, D), dtype=q.dtype,
                     device=q.device).transpose(1, 2)
    dk = torch.empty((B, T, Hkv, D), dtype=q.dtype,
                     device=q.device).transpose(1, 2)
    dv = torch.empty((B, T, Hkv, D), dtype=q.dtype,
                     device=q.device).transpose(1, 2)
    if B == 0 or H == 0 or S == 0:
        return dq, dk.zero_(), dv.zero_()
    do = do.to(q.dtype)
    (q, *sq), (k, *sk), (v, *sv), (o, *so), (do, *sd) = (
        _bhs(t) for t in (q, k, v, o, do))
    # TMA takes a stride only where the dim is longer than one
    for st, dims in ((sq, (B, H, S)), (sk, (B, Hkv, T)), (sv, (B, Hkv, T)),
                     (so, (B, H, S)), (sd, (B, H, S))):
        st[:] = [s if n > 1 else D for s, n in zip(st, dims)]
    lse = lse.contiguous()
    strides = [*sq, *sk, *sv, *so, *sd]
    for t in (dq, dk, dv):
        strides += [t.stride(0), t.stride(1), t.stride(2)]
    st = (ctypes.c_longlong * 24)(*strides)
    scale32 = float(np.float32(scale))
    bf16 = int(q.dtype == torch.bfloat16)
    lib = _build.load("flash_attention_bwd")
    stream = torch.cuda.current_stream(q.device).cuda_stream
    counts = _build.launch_counts
    delta = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr())
    causal = int(bool(causal))
    if bwd_route(q.dtype, D) == "wgmma":
        # dQ first: its kernel also writes Δ, which the dK/dV kernel reads
        _build.check(lib.flash_attention_bwd_dq_wgmma_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
            st, B, H, Hkv, S, T, D, causal, scale32, stream),
            "flash_attention backward (dq and delta, wgmma)")
        counts["flash_attention_bwd_dq"] += 1
        counts["flash_attention_bwd_dq_wgmma"] += 1
        _build.check(lib.flash_attention_bwd_dkdv_wgmma_launch(
            *args, dk.data_ptr(), dv.data_ptr(), st, B, H, Hkv, S, T, D,
            causal, scale32, stream),
            "flash_attention backward (dk, dv, wgmma)")
        counts["flash_attention_bwd_dkdv"] += 1
        counts["flash_attention_bwd_dkdv_wgmma"] += 1
        return dq, dk, dv
    _build.check(lib.flash_attention_bwd_delta_launch(
        o.data_ptr(), do.data_ptr(), delta.data_ptr(), *so, *sd, B, H, S, D,
        bf16, stream), "flash_attention backward (delta)")
    counts["flash_attention_bwd_delta"] += 1
    shape = (B, H, Hkv, S, T, D, causal, scale32, bf16, stream)
    _build.check(lib.flash_attention_bwd_dkdv_launch(
        *args, dk.data_ptr(), dv.data_ptr(), st, *shape),
        "flash_attention backward (dk, dv)")
    counts["flash_attention_bwd_dkdv"] += 1
    _build.check(lib.flash_attention_bwd_dq_launch(
        *args, dq.data_ptr(), st, *shape), "flash_attention backward (dq)")
    counts["flash_attention_bwd_dq"] += 1
    return dq, dk, dv


def _ticket_buffer(device: torch.device, stream: int, n: int
                   ) -> torch.Tensor:
    """The decode launch's tickets for launches on ``stream``: ints that
    start at zero and that each launch leaves at zero."""
    key = (device.index, stream)
    buf = _tickets.get(key)
    if buf is None or buf.numel() < n:
        buf = torch.zeros(max(n, 1024), dtype=torch.int32, device=device)
        _tickets[key] = buf
    return buf


SMEM_KINDS = {"prefill": 0, "prefill_wgmma": 1, "decode": 2}


BWD_SMEM_KINDS = {"dkdv": 0, "dq": 1, "dkdv_wgmma": 2, "dq_wgmma": 3}


def bwd_smem_bytes(D: int, kind: str) -> int:
    """Dynamic shared memory of one CTA of the backward's ``"dkdv"`` or
    ``"dq"`` kernel on the CUDA cores, or ``"dkdv_wgmma"`` or
    ``"dq_wgmma"`` on the tensor cores, at head dim ``D``, read from the
    built kernel; -1 where there is no such instantiation."""
    return int(_build.load("flash_attention_bwd").flash_attention_bwd_smem(
        D, BWD_SMEM_KINDS[kind]))


def smem_bytes(D: int, kind: str) -> int:
    """Dynamic shared memory of one CTA of ``kind`` (``"prefill"`` on the
    CUDA cores, ``"prefill_wgmma"``, ``"decode"`` at G = 4), bf16, read
    from the built kernel; -1 where there is no such instantiation."""
    return int(_build.load("flash_attention").flash_attention_smem(
        D, SMEM_KINDS[kind]))
