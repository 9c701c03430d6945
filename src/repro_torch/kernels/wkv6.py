"""RWKV-6 WKV recurrence: the CUDA kernels' launch wrappers and their plain
version.

Replaces the TPU kernel ``repro.kernels.wkv6.wkv6_pallas``
(``src/repro/kernels/wkv6.py:52``, ``pl.pallas_call`` at ``:69``).
Sources: ``csrc/wkv6.cu`` (the recurrent kernel), ``csrc/wkv6_decode.cu``
(the decode kernel, T = 1) and ``csrc/wkv6_chunked.cu`` (the chunked
kernel).

``y_t = r_t·(S + diag(u)·k_tᵀv_t)``, ``S ← diag(w_t)·S + k_tᵀv_t`` from an
initial state (zeros, or a given ``(B, H, Dk, Dv)`` fp32 state), returning
``y`` and the final state: the TPU kernel's function with the state in and
out, which prefill (the final state into the cache) and decode (the cache's
state in, written back in place) need.  Any T; Dk ≤ 64 and Dk, Dv with
16-byte rows.  r, k, v fp32 or bf16, w fp32, u fp32 or bf16; operands are
read through their strides (last axis contiguous, rows on 16-byte
boundaries; a view that is not is copied first); ``y`` is allocated ``(B,
T, H, Dv)`` in memory and returned as its ``(B, H, T, Dv)`` view, so the
model's ``transpose(1, 2).reshape(B, T, H·Dv)`` copies nothing.

:func:`launch`, which :func:`repro_torch.kernels.ops.wkv6` takes for
every call, sends a call by T alone (:func:`route`): T = 1 to the decode
kernel, any longer T to the recurrent kernel.  There is no fallback: a
kernel that fails to build or launch raises.

* :func:`launch_recurrent`, the recurrent kernel: one CTA per (b, h, 16
  columns of the state) walks all of T with the state in registers,
  chunks of 32 steps staged by ``cp.async``; unfused fp32 products on
  the CUDA cores in the plain version's order, so the two agree to the
  bit.  Bound: operations at prefill (5·Dk·Dv per step and head).
* :func:`launch_decode`, the decode kernel: one step, no staging and no
  shared memory, each thread holding 4 columns of 8 state rows loaded
  and stored 16 bytes at a time, every CTA resident at once; the same
  order of the sums, so the same bits as the plain version and as the
  recurrent kernel at T = 1.  Bound: bytes (the fp32 state read and
  written).
* :func:`launch_chunked`, the chunked kernel: chunks of 64 steps with
  their products on the tensor cores (every fp32 operand split in three
  bf16 pieces), in three launches — each chunk's own state, a scan over
  the chunk states, each chunk's y — so time runs in parallel.  Its sums
  run in another order than the recurrence's; it meets
  ``testing.WKV_TERMS_RTOL``, the error model against the magnitude of
  the terms.  Bound: bytes.  On the H100 it is the faster of the two
  from T = 64 at B = 8, H = 32 (``chip_smoke.py``'s times phase).

No call is dispatched to the chunked kernel.  The port's checks of
``wkv6`` against its plain version (``testing.assert_attention_close`` and
``assert_close``, RTOL = ATOL = 1e-5) hold any kernel to the recurrence's
own rounding where the decay is slow and the terms cancel: at the model's
init decay (w ≈ 0.9975) with N(0, 1) operands even the exact sum parts
from the plain version by more than they allow, from T = 70 at B × H =
256 on (``tests/test_torch_wkv6_chunked.py``).  Only the kernels that
repeat the plain version's order meet them at the model's shapes.

The backward (:func:`launch_backward`, which ``ops.wkv6``'s autograd
Function takes on the card) is sent by :func:`bwd_route`: the model's
states (:data:`BWD_CHUNKED_SHAPES`: 64 × 64, 16 × 16, 16 × 128) to the
chunked backward (``csrc/wkv6_bwd_chunked.cu``: chunks of 64 steps in
parallel, their products on the tensor cores, held to the recurrence
within ``testing.WKV_GRAD_TOL``), any other state to the recurrent one
(``csrc/wkv6_bwd.cu``, which repeats ``ref.wkv6_backward``'s order to the
bit).

Launches are counted under ``wkv6_decode`` (the decode kernel),
``wkv6_recurrent`` (the recurrent kernel), ``wkv6_prefill`` (every call of
T > 1, on either prefill kernel), ``wkv6_chunked`` (three a chunked
call), ``wkv6_bwd`` and ``wkv6_bwd_du`` (one each a recurrent backward
call) and ``wkv6_bwd_chunked`` and ``wkv6_bwd_chunked_du`` (three and one
a chunked backward call).

On the dry run's ``meta`` operands (``_build.dry``) each launch runs its
checks, allocates its outputs and scratch, bumps its counters and reports
``cost.wkv6`` and ``cost.wkv6_backward``'s work; it builds, loads and
launches nothing.

The plain version is :func:`repro_torch.kernels.ref.wkv6`; the dispatch in
:mod:`repro_torch.kernels.ops` takes it for CPU tensors only.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, cost
from repro_torch.kernels.flash_attention import _bhs
from repro_torch.kernels.ref import wkv6 as plain  # noqa: F401
from repro_torch.kernels.ref import wkv6_bwd_tile

MAX_DK = 64          # the largest instantiation of csrc/wkv6.cu and
                     # csrc/wkv6_decode.cu
CHUNK = 64           # steps per chunk of csrc/wkv6_chunked.cu
CHUNKED_MAX_D = 64   # Dk and Dv the chunked kernel takes
#: the states (Dk, Dv) the chunked backward (csrc/wkv6_bwd_chunked.cu) has
#: an instantiation of: rwkv6-1.6b's head, reduced()'s, Jamba's Mamba scan
BWD_CHUNKED_SHAPES = ((64, 64), (16, 16), (16, 128))
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


def _shape(r, k, v, w, u) -> tuple[int, int, int, int, int]:
    """Check the operands of a call; returns (B, H, T, Dk, Dv)."""
    dev = r.device
    if (not _build.on_card(r) or any(t.device != dev for t in (k, v, w, u))
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
    return B, H, T, Dk, Dv


def _operands(r, k, v, w, u, state, state_out, out_dtype):
    """Check a call; returns (shape (B, H, T, Dk, Dv), state, state_out —
    allocated when not given —, y (B, H, T, Dv) as a view of (B, T, H,
    Dv))."""
    B, H, T, Dk, Dv = _shape(r, k, v, w, u)
    dev = r.device
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
    return (B, H, T, Dk, Dv), state, state_out, y


def route(T: int) -> str:
    """The kernel a call of T steps takes: ``"decode"`` at T = 1,
    ``"recurrent"`` otherwise."""
    return "decode" if T == 1 else "recurrent"


def launch(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           w: torch.Tensor, u: torch.Tensor, state=None, *, state_out=None,
           out_dtype=None) -> tuple[torch.Tensor, torch.Tensor]:
    """``(y, final_state)`` for r, k, w ``(B, H, T, Dk)``, v ``(B, H, T,
    Dv)``, u ``(H, Dk)`` on the card, by the kernel :func:`route` names
    for T.  ``state_out`` (which may be ``state``) receives the final
    state in place; a new tensor does otherwise."""
    T = r.shape[2] if r.dim() == 4 else 0
    fn = launch_decode if route(T) == "decode" else launch_recurrent
    return fn(r, k, v, w, u, state, state_out=state_out,
              out_dtype=out_dtype)


def launch_recurrent(r, k, v, w, u, state=None, *, state_out=None,
                     out_dtype=None) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`launch`'s function on the recurrent kernel
    (``csrc/wkv6.cu``), any T."""
    (B, H, T, Dk, Dv), state, state_out, y = _operands(
        r, k, v, w, u, state, state_out, out_dtype)
    r, *sr = _bhs(r)
    k, *sk = _bhs(k)
    v, *sv = _bhs(v)
    w, *sw = _bhs(w)
    u = u.contiguous()
    if _build.dry(r):
        return _dry_forward("wkv6_recurrent", r, u, state, y, state_out)
    lib = _build.load("wkv6")
    stream = torch.cuda.current_stream(r.device).cuda_stream
    _build.check(lib.wkv6_launch(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
        u.data_ptr(), 0 if state is None else state.data_ptr(),
        state_out.data_ptr(), y.data_ptr(), *sr, *sk, *sv, *sw,
        y.stride(0), y.stride(1), y.stride(2), B, H, T, Dk, Dv,
        int(r.dtype == torch.bfloat16), int(u.dtype == torch.bfloat16),
        int(y.dtype == torch.float32), stream), "wkv6")
    _count_forward("wkv6_recurrent", T)
    return y, state_out


def _count_forward(name: str, T: int) -> None:
    """A forward call's launches: one under ``name`` (three for the
    chunked kernel), and the call once under wkv6_prefill where T > 1."""
    _build.launch_counts[name] += 3 if name == "wkv6_chunked" else 1
    if T > 1:
        _build.launch_counts["wkv6_prefill"] += 1


def _dry_forward(name, r, u, state, y, state_out):
    """A forward launch on the dry run's ``meta`` operands: its counters
    and its work (``cost.wkv6``), no launch."""
    B, H, T, Dk = r.shape
    _count_forward(name, T)
    cost.report(name, cost.wkv6(B, H, T, Dk, y.shape[3], r.element_size(),
                                state is not None, y.element_size()))
    return y, state_out


def launch_decode(r, k, v, w, u, state=None, *, state_out=None,
                  out_dtype=None) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`launch`'s function at T = 1 on the decode kernel
    (``csrc/wkv6_decode.cu``); any other T raises."""
    (B, H, T, Dk, Dv), state, state_out, y = _operands(
        r, k, v, w, u, state, state_out, out_dtype)
    if T != 1:
        raise ValueError(f"wkv6 decode kernel: T={T}, it takes T = 1")
    r, *sr = _bhs(r)
    k, *sk = _bhs(k)
    v, *sv = _bhs(v)
    w, *sw = _bhs(w)
    u = u.contiguous()
    if _build.dry(r):
        return _dry_forward("wkv6_decode", r, u, state, y, state_out)
    lib = _build.load("wkv6_decode")
    stream = torch.cuda.current_stream(r.device).cuda_stream
    _build.check(lib.wkv6_decode_launch(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
        u.data_ptr(), 0 if state is None else state.data_ptr(),
        state_out.data_ptr(), y.data_ptr(), *sr[:2], *sk[:2], *sv[:2],
        *sw[:2], y.stride(0), y.stride(1), B, H, Dk, Dv,
        int(r.dtype == torch.bfloat16), int(u.dtype == torch.bfloat16),
        int(y.dtype == torch.float32), stream), "wkv6 decode")
    _count_forward("wkv6_decode", T)
    return y, state_out


def launch_chunked(r, k, v, w, u, state=None, *, state_out=None,
                   out_dtype=None) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`launch`'s function on the chunked kernel
    (``csrc/wkv6_chunked.cu``), for Dk, Dv ≤ 64: three launches, with two
    ``(B, H, ⌈T/64⌉, 64, 64)`` fp32 tensors of scratch (each chunk's own
    state, each chunk's entry state)."""
    (B, H, T, Dk, Dv), state, state_out, y = _operands(
        r, k, v, w, u, state, state_out, out_dtype)
    if Dk > CHUNKED_MAX_D or Dv > CHUNKED_MAX_D:
        raise ValueError(f"wkv6 chunked kernel: Dk={Dk}, Dv={Dv}: it takes "
                         f"Dk, Dv <= {CHUNKED_MAX_D}")
    nc = -(-T // CHUNK)
    dev = r.device
    st, se = torch.empty((2, B, H, nc, CHUNKED_MAX_D, CHUNKED_MAX_D),
                         dtype=torch.float32, device=dev)
    dc = torch.empty((B, H, nc, CHUNKED_MAX_D), dtype=torch.float32,
                     device=dev)
    r, *sr = _bhs(r)
    k, *sk = _bhs(k)
    v, *sv = _bhs(v)
    w, *sw = _bhs(w)
    u = u.contiguous()
    if _build.dry(r):
        return _dry_forward("wkv6_chunked", r, u, state, y, state_out)
    lib = _build.load("wkv6_chunked")
    stream = torch.cuda.current_stream(dev).cuda_stream
    _build.check(lib.wkv6_chunked_launch(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
        u.data_ptr(), 0 if state is None else state.data_ptr(),
        state_out.data_ptr(), y.data_ptr(), st.data_ptr(), se.data_ptr(),
        dc.data_ptr(),
        *sr, *sk, *sv, *sw, y.stride(0), y.stride(1), y.stride(2), B, H, T,
        Dk, Dv, int(r.dtype == torch.bfloat16),
        int(u.dtype == torch.bfloat16), int(y.dtype == torch.float32),
        stream), "wkv6 chunked")
    _count_forward("wkv6_chunked", T)
    return y, state_out


def bwd_route(T: int, Dk: int, Dv: int, dtype: torch.dtype) -> str:
    """The backward kernel a call takes: ``"chunked"`` (``csrc/
    wkv6_bwd_chunked.cu``) for a state of :data:`BWD_CHUNKED_SHAPES` with
    fp32 or bf16 operands, at any T ≥ 1 (a partial chunk is masked);
    ``"recurrent"`` (``csrc/wkv6_bwd.cu``) for the other states it takes
    (Dk ≤ 64, Dv ≤ 128)."""
    if T < 1:
        raise ValueError(f"wkv6 backward: T={T}")
    return ("chunked" if (Dk, Dv) in BWD_CHUNKED_SHAPES
            and dtype in _OPERANDS else "recurrent")


def _backward_operands(r, k, v, w, u, state, dy, d_state_out):
    """Check a backward call; returns (B, H, T, Dk, Dv), the state and
    ``d_state_out`` (contiguous), each checked."""
    B, H, T, Dk, Dv = _shape(r, k, v, w, u)
    dev = r.device
    state = _state(state, (B, H, Dk, Dv), dev, "state")
    if (dy.device != dev or tuple(dy.shape) != (B, H, T, Dv)
            or dy.dtype not in (r.dtype, torch.float32)):
        raise ValueError(f"wkv6 backward: dy {dy.dtype} {tuple(dy.shape)} "
                         f"on {dy.device}: it takes (B, H, T, Dv) = "
                         f"{(B, H, T, Dv)} in {r.dtype} or fp32 on {dev}")
    if d_state_out is not None:
        if (d_state_out.device != dev or d_state_out.dtype != torch.float32
                or tuple(d_state_out.shape) != (B, H, Dk, Dv)):
            raise ValueError(f"wkv6 backward: d_state_out "
                             f"{d_state_out.dtype} "
                             f"{tuple(d_state_out.shape)}: it takes fp32 "
                             f"{(B, H, Dk, Dv)} on {dev}")
        d_state_out = d_state_out.contiguous()
    return (B, H, T, Dk, Dv), state, d_state_out


def _backward_outputs(B, H, T, Dk, Dv, dtype, u_dtype, dev):
    """dr, dk, dv in ``dtype`` and dw fp32, each ``(B, T, H, D)`` in memory
    as its ``(B, H, T, D)`` view; du ``(H, Dk)`` in u's type; d_state."""
    def out(D, dt):
        return torch.empty((B, T, H, D), dtype=dt, device=dev).transpose(1, 2)

    return (out(Dk, dtype), out(Dk, dtype), out(Dv, dtype),
            out(Dk, torch.float32),
            torch.empty((H, Dk), dtype=u_dtype, device=dev),
            torch.empty((B, H, Dk, Dv), dtype=torch.float32, device=dev))


def _strides(ins, outs) -> ctypes.Array:
    """The (b, head, position) strides of the operands (already through
    ``_bhs``) and of the outputs, in the kernels' order."""
    strides = [s for t in ins for s in (t.stride(0), t.stride(1),
                                        t.stride(2))]
    for t in outs:
        strides += [t.stride(0), t.stride(1), t.stride(2)]
    return (ctypes.c_longlong * len(strides))(*strides)


def launch_backward(r, k, v, w, u, state, dy, d_state_out=None
                    ) -> tuple[torch.Tensor, ...]:
    """``(dr, dk, dv, dw, du, d_state)`` of :func:`launch`'s function at
    ``(r, k, v, w, u, state)`` for the output's gradient ``dy`` ``(B, H, T,
    Dv)`` (fp32 or r's type) and the final state's ``d_state_out`` (zeros
    when None), on the backward kernel :func:`bwd_route` names for the
    call, Dk ≤ 64 and Dv ≤ 128.  dr, dk, dv in r's type and dw fp32, each
    allocated ``(B, T, H, D)`` in memory and returned as its ``(B, H, T,
    D)`` view (the model's layout); du ``(H, Dk)`` in u's type; d_state
    ``(B, H, Dk, Dv)`` fp32.  No fallback: a kernel that fails to build or
    launch raises."""
    T = r.shape[2] if r.dim() == 4 else 0
    Dk = r.shape[3] if r.dim() == 4 else 0
    Dv = v.shape[3] if v.dim() == 4 else 0
    fn = (launch_backward_chunked if bwd_route(T, Dk, Dv, r.dtype)
          == "chunked" else launch_backward_recurrent)
    return fn(r, k, v, w, u, state, dy, d_state_out)


def launch_backward_chunked(r, k, v, w, u, state, dy, d_state_out=None
                            ) -> tuple[torch.Tensor, ...]:
    """:func:`launch_backward`'s function on the chunked kernel
    (``csrc/wkv6_bwd_chunked.cu``), for the states of
    :data:`BWD_CHUNKED_SHAPES`: four launches (each chunk's own state and
    gradient-state, the scans, each chunk's gradients, du's sum), with fp32
    scratch of two ``(B, H, ⌈T/64⌉, Dk, Dv)`` states and two ``(B, H,
    ⌈T/64⌉, Dk)`` vectors.  bf16 operands with an fp32 dy go in as fp32
    (exact), and dr, dk, dv come back rounded to bf16 once."""
    (B, H, T, Dk, Dv), state, d_state_out = _backward_operands(
        r, k, v, w, u, state, dy, d_state_out)
    if (Dk, Dv) not in BWD_CHUNKED_SHAPES:
        raise ValueError(f"wkv6 chunked backward: Dk={Dk}, Dv={Dv}: it "
                         f"takes {BWD_CHUNKED_SHAPES}")
    out_dtype = r.dtype
    if dy.dtype != r.dtype:
        r, k, v = r.float(), k.float(), v.float()
    dev = r.device
    dr, dk, dv, dw, du, d_state = _backward_outputs(B, H, T, Dk, Dv,
                                                    r.dtype, u.dtype, dev)
    nc = -(-T // CHUNK)
    se, sx = torch.empty((2, B, H, nc, Dk, Dv), dtype=torch.float32,
                         device=dev)
    dc, dup = torch.empty((2, B, H, nc, Dk), dtype=torch.float32,
                          device=dev)
    ins = [_bhs(t)[0] for t in (r, k, v, w, dy)]
    strides = _strides(ins, (dr, dk, dv, dw))
    r, k, v, w, dy = ins
    u = u.contiguous()
    if _build.dry(r):
        _dry_backward("wkv6_bwd_chunked", r, dy, state, Dv)
        return _chunked_grads(out_dtype, dr, dk, dv, dw, du, d_state)
    lib = _build.load("wkv6_bwd_chunked")
    stream = torch.cuda.current_stream(dev).cuda_stream
    _build.check(lib.wkv6_bwd_chunked_launch(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(), u.data_ptr(),
        0 if state is None else state.data_ptr(), dy.data_ptr(),
        0 if d_state_out is None else d_state_out.data_ptr(), dr.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), dw.data_ptr(), du.data_ptr(),
        d_state.data_ptr(), se.data_ptr(), sx.data_ptr(), dc.data_ptr(),
        dup.data_ptr(), strides, B, H, T, Dk, Dv,
        int(r.dtype == torch.bfloat16), int(u.dtype == torch.bfloat16),
        stream), "wkv6 chunked backward")
    _count_backward("wkv6_bwd_chunked")
    return _chunked_grads(out_dtype, dr, dk, dv, dw, du, d_state)


def _chunked_grads(out_dtype, dr, dk, dv, dw, du, d_state):
    """The chunked backward's gradients, dr, dk, dv rounded to the
    operands' type once where they were computed in fp32."""
    if out_dtype != dr.dtype:
        dr, dk, dv = (t.to(out_dtype) for t in (dr, dk, dv))
    return dr, dk, dv, dw, du, d_state


def _count_backward(name: str) -> None:
    """A backward call's launches: the chunked kernel's three and its
    du's sum, or the recurrent kernel's scan and its du's sum."""
    _build.launch_counts[name] += 3 if name == "wkv6_bwd_chunked" else 1
    _build.launch_counts[name + "_du"] += 1


def _dry_backward(name, r, dy, state, Dv) -> None:
    """A backward launch on the dry run's ``meta`` operands: its counters
    and its work (``cost.wkv6_backward``), no launch."""
    B, H, T, Dk = r.shape
    _count_backward(name)
    cost.report(name, cost.wkv6_backward(B, H, T, Dk, Dv, r.element_size(),
                                         dy.element_size(),
                                         state is not None))


def launch_backward_recurrent(r, k, v, w, u, state, dy, d_state_out=None
                              ) -> tuple[torch.Tensor, ...]:
    """:func:`launch_backward`'s function on the recurrent kernel
    (``csrc/wkv6_bwd.cu``), any state it takes (Dk ≤ 64, Dv ≤ 128): two
    launches (the scan, then du's sum over b) and fp32 scratch of ``(B, H,
    ⌈T/C⌉)`` states (:func:`backward_chunk`).  It repeats
    ``ref.wkv6_backward``'s order of sums, so the two agree to the bit."""
    (B, H, T, Dk, Dv), state, d_state_out = _backward_operands(
        r, k, v, w, u, state, dy, d_state_out)
    dkp, cpt, tc = wkv6_bwd_tile(Dk, Dv)
    dev = r.device
    dry = _build.dry(r)
    if dry:
        lib, nc = None, -(-T // bwd_chunk_steps(dkp, cpt, tc))
    else:
        lib = _build.load("wkv6_bwd")
        nc = -(-T // int(lib.wkv6_bwd_chunk(dkp, cpt, tc)))
    dr, dk, dv, dw, du, d_state = _backward_outputs(B, H, T, Dk, Dv,
                                                    r.dtype, u.dtype, dev)
    dup = torch.empty((B, H, Dk), dtype=torch.float32, device=dev)
    ck = torch.empty((B, H, nc, dkp * cpt * tc), dtype=torch.float32,
                     device=dev)
    ins = [_bhs(t)[0] for t in (r, k, v, w, dy)]
    strides = _strides(ins, (dr, dk, dv, dw))
    r, k, v, w, dy = ins
    u = u.contiguous()
    if dry:
        _dry_backward("wkv6_bwd", r, dy, state, Dv)
        return dr, dk, dv, dw, du, d_state
    stream = torch.cuda.current_stream(dev).cuda_stream
    _build.check(lib.wkv6_bwd_launch(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(), u.data_ptr(),
        0 if state is None else state.data_ptr(), dy.data_ptr(),
        0 if d_state_out is None else d_state_out.data_ptr(), dr.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), dw.data_ptr(), du.data_ptr(),
        d_state.data_ptr(), dup.data_ptr(), ck.data_ptr(), strides, B, H, T,
        Dk, Dv, dkp, cpt, tc, int(r.dtype == torch.bfloat16),
        int(u.dtype == torch.bfloat16), int(dy.dtype == torch.bfloat16),
        stream), "wkv6 backward")
    _count_backward("wkv6_bwd")
    return dr, dk, dv, dw, du, d_state


def bwd_chunk_steps(dkp: int, cpt: int, tc: int) -> int:
    """``csrc/wkv6_bwd.cu``'s ``Tile<DKP, CPT, TC>::C``, the steps between
    the recurrent backward's kept states: as many (DKP × CPT·TC) fp32
    states as fit 128 KB (DKP = 64) or 64 KB of shared memory, at most 32
    (``wkv6_bwd_chunk`` of the built library; ``chip_smoke.py`` holds the
    two equal)."""
    budget = 32768 if dkp == 64 else 16384
    return min(budget // (dkp * cpt * tc), 32)


def backward_smem_bytes_chunked(Dk: int, Dv: int, bf16: bool) -> int:
    """Dynamic shared memory of one gradient CTA of the chunked backward,
    read from the built kernel."""
    return int(_build.load("wkv6_bwd_chunked").wkv6_bwd_chunked_smem(
        Dk, Dv, int(bf16)))


def backward_chunk(Dk: int, Dv: int) -> int:
    """Steps between the backward kernel's kept states at a ``(Dk, Dv)``
    state, read from the built kernel."""
    return int(_build.load("wkv6_bwd").wkv6_bwd_chunk(*wkv6_bwd_tile(Dk, Dv)))


def backward_smem_bytes(Dk: int, Dv: int) -> int:
    """Dynamic shared memory of one backward CTA, read from the built
    kernel."""
    return int(_build.load("wkv6_bwd").wkv6_bwd_smem(*wkv6_bwd_tile(Dk, Dv)))


def smem_bytes(Dk: int, bf16: bool) -> int:
    """Dynamic shared memory of one recurrent CTA, read from the built
    kernel."""
    return int(_build.load("wkv6").wkv6_smem(Dk, int(bf16)))


def chunked_smem_bytes(bf16: bool) -> int:
    """Dynamic shared memory of one chunk CTA, read from the built
    kernel."""
    return int(_build.load("wkv6_chunked").wkv6_chunked_smem(int(bf16)))
