"""Attention: the CUDA kernel's launch wrapper and its plain version.

Replaces the TPU kernel ``repro.kernels.flash_attention.
flash_attention_pallas`` (``src/repro/kernels/flash_attention.py:69``,
``pl.pallas_call`` at ``:91``).  Source: ``csrc/flash_attention.cu``.

An online softmax over KV tiles, GQA by head groups (query head ``h`` reads
KV head ``h // (H / Hkv)``), the causal mask ``kpos ≤ qpos + (T − S)`` and
the ``kv_valid_len`` mask; logits, softmax state and accumulator in fp32;
the output in ``q.dtype``.  ``S > 1`` launches the prefill kernel (one CTA
per (b, h, 64-query tile), KV tiles above the diagonal or past
``kv_valid_len`` skipped); ``S == 1`` the decode kernel (the valid keys cut
into splits, one CTA per (split, KV head, up to 8 of its query heads, b),
then a combining pass).  Operands are read through their strides (the last
axis contiguous, rows on 16-byte boundaries; a view that is not is copied
first), fp32 or bf16; the output is allocated ``(B, S, H, D)`` in
memory and returned as its ``(B, H, S, D)`` view, so the model's
``transpose(1, 2).reshape(B, S, H·D)`` copies nothing.

What bounds it on the H100: operations at prefill, bytes at decode (see
the note at the head of the source); the products run in fp32 on the CUDA
cores in this version.

The plain version is :func:`repro_torch.kernels.ref.flash_attention`; the
dispatch in :mod:`repro_torch.kernels.ops` takes it for CPU tensors only.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import flash_attention as plain  # noqa: F401

HEAD_DIMS = (16, 64, 128, 256)   # the instantiations of csrc/flash_attention.cu
DECODE_TILE = 64                 # keys per decode tile (csrc BT)
DECODE_HEADS = 8                 # query heads per decode CTA (csrc GC)
_GRID_YZ = 65535
_INT_MAX = 2 ** 31 - 1
_sm_count: dict[int, int] = {}


def decode_splits(B: int, Hkv: int, G: int, kv_valid: int, sms: int
                  ) -> tuple[int, int]:
    """``(nsplit, chunk)`` of the decode launch: the ``kv_valid`` keys cut
    into splits of ``chunk`` keys (a multiple of the tile, none empty), as
    many as bring the grid to about two CTAs per SM."""
    ctas = B * Hkv * -(-G // DECODE_HEADS)
    tiles = -(-kv_valid // DECODE_TILE)
    nsplit = min(max(1, -(-2 * sms // ctas)), tiles)
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


def launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
           causal: bool, scale: float, kv_valid_len=None) -> torch.Tensor:
    """The kernel's attention ``(B, H, S, D)`` for q ``(B, H, S, D)`` and
    k, v ``(B, Hkv, T, D)`` on the card, all fp32 or all bf16."""
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
    if B == 0 or S == 0 or H == 0:
        return out
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
    if S == 1:
        dev = q.device.index
        if dev not in _sm_count:
            _sm_count[dev] = torch.cuda.get_device_properties(
                q.device).multi_processor_count
        nsplit, chunk = decode_splits(B, Hkv, H // Hkv, kv, _sm_count[dev])
        part_acc = torch.empty((nsplit, B, H, D), dtype=torch.float32,
                               device=q.device)
        part_ml = torch.empty((nsplit, B, H, 2), dtype=torch.float32,
                              device=q.device)
        _build.check(lib.flash_attention_decode_launch(
            *ptrs, B, H, Hkv, D, kv, chunk, nsplit, scale32, bf16,
            part_acc.data_ptr(), part_ml.data_ptr(), stream),
            "flash_attention (decode)")
        _build.launch_counts["flash_attention_decode"] += 1
    else:
        _build.check(lib.flash_attention_prefill_launch(
            *ptrs, B, H, Hkv, S, T, D, kv, int(bool(causal)), scale32, bf16,
            stream), "flash_attention (prefill)")
        _build.launch_counts["flash_attention_prefill"] += 1
    return out


def smem_bytes(D: int, decode: bool) -> int:
    """Dynamic shared memory of one CTA, read from the built kernel."""
    return int(_build.load("flash_attention").flash_attention_smem(
        D, int(decode)))
