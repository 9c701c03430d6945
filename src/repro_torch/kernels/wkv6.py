"""RWKV-6 WKV recurrence: the CUDA kernel's launch wrapper and its plain
version.

Replaces the TPU kernel ``repro.kernels.wkv6.wkv6_pallas``
(``src/repro/kernels/wkv6.py:52``, ``pl.pallas_call`` at ``:69``).  Source:
``csrc/wkv6.cu``.

``y_t = r_t·(S + diag(u)·k_tᵀv_t)``, ``S ← diag(w_t)·S + k_tᵀv_t`` from an
initial state (zeros, or a given ``(B, H, Dk, Dv)`` fp32 state), returning
``y`` and the final state: the TPU kernel's function with the state in and
out, which prefill (the final state into the cache) and decode (the cache's
state in, written back in place) need.  One CTA per (b, h, 16 columns of
the state) walks all of T with the state in registers; chunks of 32 steps
are staged in shared memory by ``cp.async`` with the next one in flight.
Any T (the ragged chunk is masked in the kernel; the ``T % bt`` rule belongs
to the Pallas launch only); Dk ≤ 64 and Dk, Dv with 16-byte rows.  r, k, v
fp32 or bf16, w fp32, u fp32 or bf16; operands are read through their
strides (last axis contiguous, rows on 16-byte boundaries; a view that is
not is copied first); ``y`` is allocated ``(B, T, H, Dv)`` in memory and
returned as its ``(B, H, T, Dv)`` view, so the model's
``transpose(1, 2).reshape(B, T, H·Dv)`` copies nothing.

What bounds it on the H100: operations at prefill (5·Dk·Dv per step and
head), bytes at decode (the fp32 state, read and written once).  This
version runs unfused fp32 products on the CUDA cores, in the plain
version's order, so the two agree to the bit.

The plain version is :func:`repro_torch.kernels.ref.wkv6`; the dispatch in
:mod:`repro_torch.kernels.ops` takes it for CPU tensors only.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import _bhs
from repro_torch.kernels.ref import wkv6 as plain  # noqa: F401

MAX_DK = 64          # the largest instantiation of csrc/wkv6.cu
_GRID_YZ = 65535
_OPERANDS = (torch.float32, torch.bfloat16)


def _state(s, shape, device, what: str):
    if s is not None and (s.device != device or s.dtype != torch.float32
                          or tuple(s.shape) != shape
                          or not s.is_contiguous()):
        raise ValueError(f"wkv6 kernel: {what} must be a contiguous fp32 "
                         f"{shape} tensor on {device}, got {s.dtype} "
                         f"{tuple(s.shape)} on {s.device}")
    return s


def launch(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           w: torch.Tensor, u: torch.Tensor, state=None, *, state_out=None,
           out_dtype=None) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel's ``(y, final_state)`` for r, k, w ``(B, H, T, Dk)``, v
    ``(B, H, T, Dv)``, u ``(H, Dk)`` on the card.  ``state_out`` (which may
    be ``state``) receives the final state in place; a new tensor does
    otherwise."""
    dev = r.device
    if (dev.type != "cuda" or any(t.device != dev for t in (k, v, w, u))
            or r.dim() != 4 or v.dim() != 4 or r.dtype not in _OPERANDS
            or k.dtype != r.dtype or v.dtype != r.dtype
            or w.dtype != torch.float32 or u.dtype not in _OPERANDS):
        raise ValueError(
            f"wkv6 kernel takes CUDA tensors r, k, v (B, H, T, D) all fp32 "
            f"or all bf16, w fp32 and u fp32 or bf16, got r {r.dtype} "
            f"{tuple(r.shape)} on {dev}, k {k.dtype}, v {v.dtype} "
            f"{tuple(v.shape)}, w {w.dtype} on {w.device}, u {u.dtype} on "
            f"{u.device}")
    B, H, T, Dk = r.shape
    Dv = v.shape[3]
    if (k.shape != r.shape or w.shape != r.shape
            or v.shape[:3] != r.shape[:3] or tuple(u.shape) != (H, Dk)):
        raise ValueError(f"wkv6 kernel: r {tuple(r.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}, w "
                         f"{tuple(w.shape)}, u {tuple(u.shape)} do not pair "
                         "up")
    per16 = 16 // r.element_size()
    if not (0 < Dk <= MAX_DK and Dk % per16 == 0 and Dk % 4 == 0
            and Dv > 0 and Dv % per16 == 0):
        raise ValueError(f"wkv6 kernel: Dk={Dk}, Dv={Dv} in {r.dtype}: it "
                         f"takes Dk <= {MAX_DK} and Dk, Dv multiples of "
                         f"{per16} (16-byte rows)")
    if not (0 < B <= _GRID_YZ and 0 < H <= _GRID_YZ and T > 0):
        raise ValueError(f"wkv6 kernel: unsupported shape B={B} H={H} T={T}")
    if out_dtype not in (None, r.dtype, torch.float32):
        raise ValueError(f"wkv6 kernel: y in {out_dtype}: it writes r's "
                         "type or fp32")
    shape = (B, H, Dk, Dv)
    state = _state(state, shape, dev, "state")
    state_out = _state(state_out, shape, dev, "state_out")
    if state_out is None:
        state_out = torch.empty(shape, dtype=torch.float32, device=dev)
    y = torch.empty((B, T, H, Dv), dtype=out_dtype or r.dtype,
                    device=dev).transpose(1, 2)
    r, *sr = _bhs(r)
    k, *sk = _bhs(k)
    v, *sv = _bhs(v)
    w, *sw = _bhs(w)
    u = u.contiguous()
    lib = _build.load("wkv6")
    stream = torch.cuda.current_stream(dev).cuda_stream
    _build.check(lib.wkv6_launch(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
        u.data_ptr(), 0 if state is None else state.data_ptr(),
        state_out.data_ptr(), y.data_ptr(), *sr, *sk, *sv, *sw,
        y.stride(0), y.stride(1), y.stride(2), B, H, T, Dk, Dv,
        int(r.dtype == torch.bfloat16), int(u.dtype == torch.bfloat16),
        int(y.dtype == torch.float32), stream), "wkv6")
    _build.launch_counts["wkv6_decode" if T == 1 else "wkv6_prefill"] += 1
    return y, state_out


def smem_bytes(Dk: int, bf16: bool) -> int:
    """Dynamic shared memory of one CTA, read from the built kernel."""
    return int(_build.load("wkv6").wkv6_smem(Dk, int(bf16)))
