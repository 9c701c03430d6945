"""Public kernel entry points: pad → dispatch → slice (counterpart of
``repro.kernels.ops``).

Dispatch follows the tensors: a CPU tensor takes the plain version
(:mod:`repro_torch.kernels.ref`), a CUDA tensor launches the hand-written
kernel or the call raises — there is no fallback to the plain version on
the card, and no capacity rule choosing one (a shape the kernel does not
take raises).

The wrappers own the padding contract: the eval set and ``cur_min`` are
zero-padded to the kernels' eval tile, so padded columns contribute
``max(0 − d², 0) = 0`` exactly; the ragged candidate edge is masked inside
the kernels, so ``X`` is never copied.  Raw gain sums are divided by the
*unpadded* eval-set size, as in ``repro.kernels.ops``.

Constraint operands (``weights``/``budget``, ``group_ids``/``caps``, or
the same as one :class:`repro_torch.kernels.ref.Encoding` passed as
``enc=``) go to the kernels as contiguous ``(M, n)`` fp32 weights,
``(M, n)`` int32 group ids, a ``(G,)`` int32 caps array and a ``(1,)``
fp32 knapsack limit on the card (``float32(budget + KNAPSACK_TOL)`` of a
number, the device's ``budget + KNAPSACK_TOL`` of a ``DynamicKnapsack``'s
tensor: :func:`repro_torch.kernels.ref.limit_operand`); the kernels read
the limit and the caps, so no host read sits in a solve.  A caller that
launches many times on one set of operands (the τ-ladder) builds the
``Encoding`` once and passes it on, so no level uploads ``caps`` again.

Eval weights (``eval_weights`` ``(m,)``, ``WeightedExemplarClustering``)
go to the three selection kernels zero-padded to the eval tile, as ``E``
and ``cur_min`` are; a padded column's contribution is 0 whatever its
weight.  A weighted call launches the kernels' weighted instantiation (the
JAX package sends it to its jnp reference instead: on the card the port
has no plain path).

Narrow candidate rows (bf16, or int8 with per-row ``x_scale``/``x_zp``)
go to the three selection kernels as they are, with the scale and
zero-point as contiguous ``(M, n)`` fp32; the kernels dequantize on the
card.  ``compute_dtype=torch.bfloat16`` launches their bf16-dot
instantiation, on every path alike, so the fused and the step-wise paths
score a row with the same bits (the JAX package's Pallas kernels take no
``compute_dtype`` and score in fp32 on the TPU, while its jnp reference,
the CPU's path, honours it everywhere; the port follows the reference).
Other row types are cast to fp32 first, as before.

``rbf_kernel`` takes a machine axis on either operand: an operand without
one (or with one machine) is shared by every machine at machine stride 0,
never copied per machine.

``flash_attention`` takes ``kv_valid_len`` (decode against a partially
filled cache) into its kernel too: the JAX package sends that case to its
jnp reference, and on the card the port has no plain path.  It takes any
``S`` and ``T``; the kernel masks the ragged edges (the ``S % bq`` rule
belongs to the Pallas launch only).

``wkv6`` takes an initial state and returns the final one (prefill fills
the cache's state, decode updates it in place through ``state_out``), and
any T: the kernel masks the ragged chunk (the ``T % bt`` rule belongs to
the Pallas launch only).

Gradients.  On the CPU ``flash_attention`` and ``wkv6`` are their plain
versions, differentiated by autograd.  On the card, where the kernels
write raw memory, each is a ``torch.autograd.Function``: while grad is
enabled and an operand requires it, ``flash_attention``'s forward saves
q, k, v, its output and the log-sum-exp, and its backward launches the
hand-written backward (``flash_attention.launch_backward``);
``wkv6``'s backward raises ``NotImplementedError`` (its kernel is ROADMAP
item 14a), so no gradient is ever dropped silently.

"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import exemplar_gains as _eg
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import greedy_select as _gs
from repro_torch.kernels import rbf_kernel as _rbf
from repro_torch.kernels import ref
from repro_torch.kernels import threshold_select as _ts
from repro_torch.kernels import wkv6 as _wkv
from repro_torch.kernels._build import launch_counts  # noqa: F401

__all__ = ["exemplar_gains", "flash_attention", "greedy_select",
           "launch_counts", "pairwise_sqdist", "rbf_kernel",
           "reset_launch_counts", "threshold_select", "wkv6"]


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


def _on_card(t: torch.Tensor) -> bool:
    if t.device.type == "cpu":
        return False
    if t.device.type == "cuda":
        return True
    raise RuntimeError(f"no kernel for tensors on {t.device}: pass CPU "
                       "tensors for the plain version or CUDA tensors")


def _pad_eval(E: torch.Tensor, cur_min: torch.Tensor):
    """Zero-pad the eval rows and the cur_min columns to the eval tile.
    The padded cur_min is always a fresh tensor: greedy_select's kernel
    updates it in place."""
    m = E.shape[0]
    mp = m + (-m) % _eg.BM
    Ep = F.pad(E, (0, 0, 0, mp - m)).contiguous()
    cmp_ = torch.zeros((cur_min.shape[0], mp), dtype=torch.float32,
                       device=cur_min.device)
    cmp_[:, :m] = cur_min
    return Ep, cmp_


def _pad_weights(ew, m: int):
    """The eval weights as a contiguous fp32 ``(mp,)`` tensor, zero-padded
    to the eval tile, or ``None``."""
    if ew is None:
        return None
    ew = ew.float().reshape(m)
    return F.pad(ew, (0, (-m) % _eg.BM)).contiguous()


def pairwise_sqdist(X: torch.Tensor, Y: torch.Tensor) -> torch.Tensor:
    """(..., n, d), (m, d) -> (..., n, m).  Always the plain version."""
    return ref.pairwise_sqdist(X, Y)


def rbf_kernel(X: torch.Tensor, Y: torch.Tensor, h: float) -> torch.Tensor:
    """``exp(−‖x − y‖²/h²)`` for every pair of rows: X ``(n, d)`` or
    ``(Mx, n, d)``, Y ``(m, d)`` or ``(My, m, d)`` with ``Mx, My ∈ {1, M}``;
    returns ``(n, m)``, or ``(M, n, m)`` where either operand had the
    machine axis."""
    if not _on_card(X):
        return ref.rbf_kernel(X, Y, h)
    batched = X.dim() == 3 or Y.dim() == 3
    K = _rbf.launch((X if X.dim() == 3 else X.unsqueeze(0)).float(),
                    (Y if Y.dim() == 3 else Y.unsqueeze(0)).float(), h)
    return K if batched else K[0]


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, scale: float | None = None,
                    kv_valid_len=None) -> torch.Tensor:
    """Attention with GQA by head groups: q ``(B, H, S, D)``, k and v
    ``(B, Hkv, T, D)``; a causal mask with the ``(T − S)`` offset, keys at
    or past ``kv_valid_len`` masked; returns ``(B, H, S, D)`` in
    ``q.dtype`` (see :func:`repro_torch.kernels.ref.flash_attention`)."""
    if not _on_card(q):
        return ref.flash_attention(q, k, v, causal=causal, scale=scale,
                                   kv_valid_len=kv_valid_len)
    if scale is None:
        scale = 1.0 / (q.shape[-1] ** 0.5)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        if kv_valid_len is not None:
            raise ValueError("flash_attention: no backward under "
                             "kv_valid_len (training never passes one)")
        return _FlashAttention.apply(q, k, v, bool(causal), float(scale))
    return _fa.launch(q, k, v, causal=causal, scale=scale,
                      kv_valid_len=kv_valid_len)


class _FlashAttention(torch.autograd.Function):
    """The card's attention with its hand-written backward."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, scale: float):
        o, lse = _fa.launch(q, k, v, causal=causal, scale=scale,
                            with_lse=True)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.scale = causal, scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = _fa.launch_backward(q, k, v, o, lse, do,
                                         causal=ctx.causal, scale=ctx.scale)
        return dq, dk, dv, None, None


#: the ROADMAP item that ports wkv6's backward
WKV6_BACKWARD_ITEM = ("ROADMAP item 14a, the wkv6 backward kernel (RWKV-6 "
                      "and hybrid training)")


class _Wkv6(torch.autograd.Function):
    """The card's wkv6, whose backward is not written yet: it raises."""

    @staticmethod
    def forward(ctx, r, k, v, w, u, state, state_out, out_dtype):
        if state_out is not None:
            ctx.mark_dirty(state_out)
        return _wkv.launch(r, k, v, w, u, state, state_out=state_out,
                           out_dtype=out_dtype)

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError(
            "wkv6 on the card has no backward kernel yet: "
            f"{WKV6_BACKWARD_ITEM}; train RWKV-6 and the hybrid on the CPU "
            "(device='cpu') until then")


def wkv6(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
         u: torch.Tensor, state: torch.Tensor | None = None, *,
         state_out: torch.Tensor | None = None,
         out_dtype: torch.dtype | None = None
         ) -> tuple[torch.Tensor, torch.Tensor]:
    """RWKV-6 WKV recurrence: r, k, w ``(B, H, T, Dk)`` (w the decay in
    (0, 1), fp32), v ``(B, H, T, Dv)``, u ``(H, Dk)``, from ``state``
    ``(B, H, Dk, Dv)`` fp32 (zeros when None).  Returns ``y`` ``(B, H, T,
    Dv)`` in ``out_dtype`` (``r.dtype`` by default) and the final state,
    written into ``state_out`` when given (it may be ``state``: an update
    in place).  See :func:`repro_torch.kernels.ref.wkv6`."""
    if not _on_card(r):
        y, final = ref.wkv6(r, k, v, w, u, state, out_dtype=out_dtype)
        if state_out is None:
            return y, final
        return y, state_out.copy_(final)
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (r, k, v, w, u, state)):
        return _Wkv6.apply(r, k, v, w, u, state, state_out, out_dtype)
    return _wkv.launch(r, k, v, w, u, state, state_out=state_out,
                       out_dtype=out_dtype)


def exemplar_gains(X: torch.Tensor, E: torch.Tensor, cur_min: torch.Tensor,
                   *, compute_dtype=None, x_scale=None, x_zp=None,
                   eval_weights=None) -> torch.Tensor:
    """Marginal gains of exemplar clustering for every row of ``X``.

    ``X`` is ``(n, d)`` or ``(M, n, d)`` (bf16, or int8 with ``x_scale``/
    ``x_zp`` following its leading axes, or fp32); ``cur_min`` is ``(m,)``
    (shared) or ``(M, m)``; ``eval_weights`` ``(m,)`` weigh the eval
    columns; ``compute_dtype`` the x·e contraction.  Returns ``(n,)`` or
    ``(M, n)``.
    """
    bf16dot = ref.check_compute_dtype(compute_dtype)
    if not _on_card(X):
        return ref.exemplar_gains(X, E, cur_min, compute_dtype=compute_dtype,
                                  x_scale=x_scale, x_zp=x_zp,
                                  eval_weights=eval_weights)
    Xb, rows = _card_rows(X, x_scale, x_zp)
    M, m = Xb.shape[0], E.shape[0]
    cm = cur_min.reshape(-1, m).expand(M, m)
    Ep, cmp_ = _pad_eval(E.float(), cm)
    g = _eg.launch(Xb, Ep, cmp_, _pad_weights(eval_weights, m),
                   bf16dot=bf16dot, **rows) / m
    return g if X.dim() == 3 else g[0]


def _card_rows(X: torch.Tensor, x_scale, x_zp) -> tuple[torch.Tensor, dict]:
    """The candidate rows with a machine axis as the kernels take them
    (bf16 and int8 kept narrow, any other type as fp32; contiguous) and
    the kernels' ``x_scale``/``x_zp`` as contiguous ``(M, n)`` fp32."""
    Xb = X if X.dim() == 3 else X.unsqueeze(0)
    if Xb.dtype not in (torch.bfloat16, torch.int8):
        Xb = Xb.float()
    M, n = Xb.shape[:2]
    if (x_scale is None) != (x_zp is None):
        raise ValueError("x_scale and x_zp pair up")
    if x_scale is None:
        return Xb.contiguous(), {}
    return Xb.contiguous(), {
        "x_scale": x_scale.float().reshape(M, n).contiguous(),
        "x_zp": x_zp.float().reshape(M, n).contiguous()}


def _card_encoding(enc: ref.Encoding) -> dict:
    """The kernels' constraint operands (see the module docstring)."""
    kw = {}
    if enc.w is not None:
        kw.update(w=enc.w, limit=enc.limit)
    if enc.gid is not None:
        kw.update(gid=enc.gid, caps=enc.caps)
    return kw


def greedy_select(X: torch.Tensor, E: torch.Tensor, cur_min: torch.Tensor,
                  mask: torch.Tensor, k: int, *, compute_dtype=None,
                  weights=None, budget=None, group_ids=None, caps=None,
                  x_scale=None, x_zp=None, eval_weights=None, enc=None):
    """Fused k-step exemplar greedy; returns ``(sel_idx, cur_min_out)``.

    ``X`` is ``(n, d)`` or ``(M, n, d)`` with ``mask`` ``(n,)`` or
    ``(M, n)``; ``cur_min`` ``(m,)`` seeds every machine.  ``sel_idx`` is
    int64, −1 from the first step with no feasible candidate on.  Ties
    go to the lowest index.  ``weights``/``budget`` (a knapsack) and
    ``group_ids``/``caps`` (a partition matroid) constrain every step, as
    :func:`repro_torch.kernels.ref.greedy_select` says; ``eval_weights``
    ``(m,)`` weigh the eval columns of every step's gains.  Narrow ``X``
    (bf16, or int8 with ``x_scale``/``x_zp``) is dequantized in the kernel;
    ``compute_dtype`` is the gains' contraction.  On the CPU the
    result is bit-identical to the step-wise greedy with
    ``ExemplarClustering``; on the card both score a row with the same
    kernel tile, and only the difference-form ``cur_min`` refresh may round
    apart (fma in the kernel).
    """
    bf16dot = ref.check_compute_dtype(compute_dtype)
    if not _on_card(X):
        return ref.greedy_select(X, E, cur_min, mask, k, weights=weights,
                                 budget=budget, group_ids=group_ids,
                                 caps=caps, enc=enc,
                                 eval_weights=eval_weights,
                                 compute_dtype=compute_dtype,
                                 x_scale=x_scale, x_zp=x_zp)
    batched = X.dim() == 3
    Xb, rows = _card_rows(X, x_scale, x_zp)
    M, n, m = Xb.shape[0], Xb.shape[1], E.shape[0]
    avail = mask.reshape(M, -1).to(torch.uint8, copy=True)  # kernel state
    cm = cur_min.reshape(-1, m).expand(M, m)
    Ep, cmp_ = _pad_eval(E.float(), cm)
    enc = ref.encoding(M, n, X.device, enc, weights, budget, group_ids, caps)
    sel, cm_out = _gs.launch(Xb, Ep, cmp_, avail, k, m,
                             ew=_pad_weights(eval_weights, m),
                             bf16dot=bf16dot, **rows, **_card_encoding(enc))
    sel, cm_out = sel.long(), cm_out[:, :m]
    return (sel, cm_out) if batched else (sel[0], cm_out[0])


def threshold_select(X: torch.Tensor, E: torch.Tensor, cur_min: torch.Tensor,
                     mask: torch.Tensor, tau, k: int, *, used=None,
                     counts=None, count=None, bn: int = 256,
                     compute_dtype=None, weights=None, budget=None,
                     group_ids=None, caps=None, x_scale=None, x_zp=None,
                     eval_weights=None, active=None, enc=None):
    """One τ-level of threshold-batch selection; returns ``(accept,
    cur_min_out)`` with ``accept`` a bool mask of the rows committed.

    ``X`` is ``(n, d)`` or ``(M, n, d)`` with ``mask`` and ``cur_min``
    following it; ``tau``, ``used``, ``count`` per machine, ``counts``
    ``(M, G)``; ``active`` ``(M,)`` marks the machines whose ladder still
    runs (the others accept nothing and keep ``cur_min``);
    ``eval_weights`` ``(m,)`` weigh the gains' eval columns.  The semantics
    are block-sequential at ``bn``, which is part of the function's
    meaning: as in ``repro.kernels.ops``, ``bn = min(bn, max(8, n))``.
    Narrow ``X`` (bf16, or int8 with ``x_scale``/``x_zp``) is dequantized
    in the kernels; ``compute_dtype`` is the contraction of the gains and
    of the fold.
    """
    bf16dot = ref.check_compute_dtype(compute_dtype)
    n = X.shape[-2]
    bn = min(bn, max(8, n))
    if not _on_card(X):
        return ref.threshold_select(
            X, E, cur_min, mask, tau, k, used=used, counts=counts,
            count=count, bn=bn, compute_dtype=compute_dtype, weights=weights,
            budget=budget, group_ids=group_ids, caps=caps, x_scale=x_scale,
            x_zp=x_zp, eval_weights=eval_weights, active=active, enc=enc)
    batched = X.dim() == 3
    Xb, rows = _card_rows(X, x_scale, x_zp)
    M, m = Xb.shape[0], E.shape[0]
    dev = X.device
    enc = ref.encoding(M, n, dev, enc, weights, budget, group_ids, caps)

    def per_machine(v, dtype, shape):
        """A scalar or per-machine operand as a contiguous (M, ...) tensor
        (zeros where the caller passed none)."""
        if v is None:
            return torch.zeros(shape, dtype=dtype, device=dev)
        v = torch.as_tensor(v, dtype=dtype, device=dev)
        return v.reshape((-1,) + shape[1:]).expand(shape).contiguous()

    cm = cur_min.reshape(-1, m).expand(M, m)
    Ep, cmp_ = _pad_eval(E.float(), cm)
    acc = _ts.launch(
        Xb, Ep, cmp_, mask.reshape(M, n).to(torch.uint8),
        per_machine(tau, torch.float32, (M,)),
        per_machine(used, torch.float32, (M,)),
        per_machine(count, torch.int32, (M,)),
        per_machine(counts, torch.int32, (M, enc.G)),
        per_machine(True if active is None else active, torch.uint8, (M,)),
        k, bn, m, ew=_pad_weights(eval_weights, m), bf16dot=bf16dot, **rows,
        **_card_encoding(enc))
    acc, cm_out = acc.bool(), cmp_[:, :m]
    return (acc, cm_out) if batched else (acc[0], cm_out[0])
