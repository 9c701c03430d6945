"""The work of each hand-written kernel, in one place, and the card that
does it.

A kernel's :class:`Work` is the operations it must do, at the rate its
bound takes them (``"bf16"`` or ``"tf32"`` on the tensor cores,
``"fp32"`` on the CUDA cores), and the bytes it must move: each input read
once and each output written once.  Where the work depends on the data
(the candidates a greedy step still has), the caller passes what its run
needs; without data (the dry run) every row counts as valid.

Two readers share these numbers: ``chip_smoke.py``'s times phase, which
puts each kernel's time beside ``Work.bound_ms`` at the shapes of its
path, and the dry run (``repro_torch.launch.op_analyzer``), where each
kernel wrapper's dry branch reports the work of its call instead of
launching it (:func:`report`).  So the kernel table's bounds and the
roofline read the same work whatever implements the kernel.

:data:`H100` is the card: an NVIDIA H100 SXM's data-sheet rates (dense
bf16 989 and TF32 495 TFLOP/s on the tensor cores, fp32 67 TFLOP/s
outside them, HBM3 3.35 TB/s) and what torch and the built kernels report
on an H100 80GB HBM3 at 700 W (``chip_smoke.py``'s ``phase_dryrun`` holds
the dry branches' copies of the latter against the card).  This module
imports neither torch nor anything of the kernels, so a script may read it
without a card.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class Device:
    """One device of the roofline.  ``rates``: operations a second by
    rate name, ``"bf16"``, ``"tf32"``, ``"fp32"`` (empty: every operation
    at ``peak_flops``, as the JAX package's TPU model takes them); ``link_bw``: bytes a second of
    the collective link, ``None`` where no link is modelled (one card);
    ``memory_bytes``: what one device holds; ``smem_optin``: the shared
    memory a block may opt in to; ``sms``: its multiprocessors."""
    name: str
    peak_flops: float
    hbm_bw: float
    link_bw: float | None = None
    rates: tuple = ()
    memory_bytes: int = 0
    smem_optin: int = 0
    sms: int = 0

    def rate(self, name: str) -> float:
        return dict(self.rates).get(name, self.peak_flops)


H100 = Device(
    name="NVIDIA H100 80GB HBM3", peak_flops=989e12, hbm_bw=3.35e12,
    rates=(("bf16", 989e12), ("tf32", 495e12), ("fp32", 67e12)),
    # torch.cuda.get_device_properties(0): total_memory,
    # shared_memory_per_block_optin, multi_processor_count on an H100 80GB
    # HBM3 at 700 W
    memory_bytes=85_017_493_504, smem_optin=232_448, sms=132)


@dataclasses.dataclass(frozen=True)
class Work:
    """Operations by rate, ``((rate, operations), ...)``, and bytes moved.
    ``overlap``: the parts at different rates run at once (the gain tile's
    tensor-core products beside its CUDA-core epilogue), so the compute
    time is the longest part's; otherwise the parts add up."""
    ops: tuple
    nbytes: float
    overlap: bool = False

    @property
    def flops(self) -> float:
        return sum(v for _, v in self.ops)

    def by_rate(self) -> dict:
        out: dict = {}
        for r, v in self.ops:
            out[r] = out.get(r, 0) + v
        return out

    def compute_s(self, dev: Device = H100) -> float:
        ts = [v / dev.rate(r) for r, v in self.ops]
        if not ts:
            return 0.0
        return max(ts) if self.overlap else sum(ts)

    def bound_ms(self, dev: Device = H100) -> tuple[float, str]:
        """(the least milliseconds ``dev`` could take, what bounds it:
        ``"operations"`` or ``"bytes"``)."""
        t_ops, t_bytes = self.compute_s(dev), self.nbytes / dev.hbm_bw
        return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                           else "bytes")

    def fp32_only_ms(self, dev: Device = H100) -> float:
        """The bound with every operation at the fp32 rate (a kernel that
        keeps them all on the CUDA cores)."""
        return 1e3 * max(self.flops / dev.rate("fp32"),
                         self.nbytes / dev.hbm_bw)


# -- the gain tile: exemplar_gains, greedy_select, threshold_select ------

def gain_tile(pairs: float, d: int, nbytes: float, epilogue: int) -> Work:
    """A kernel on the gain tile with the distances on the tensor cores:
    2d products per (row, eval column) pair at the TF32 rate beside the
    ``epilogue`` remaining operations a pair (3; 4 with eval weights) at
    the fp32 rate, the two at once."""
    return Work((("tf32", pairs * 2 * d), ("fp32", pairs * epilogue)),
                nbytes, overlap=True)


def exemplar_gains(M: int, n: int, d: int, m: int, *, row_bytes=None,
                   weighted: bool = False) -> Work:
    """One launch over ``M`` machines of ``n`` rows against ``m`` eval
    rows: every pair scored; the rows (``row_bytes`` each, fp32 by
    default), E and each machine's cur_min read, the gains written."""
    rb = 4 * d if row_bytes is None else row_bytes
    return gain_tile(M * n * m, d, M * n * rb + 4 * m * d + 4 * M * m
                     + 4 * M * n, 4 if weighted else 3)


def greedy_calls(M: int, n: int, k: int) -> int:
    """The candidates ``k`` greedy steps score on ``M`` machines of ``n``
    valid rows (one fewer each step)."""
    return M * sum(max(n - t, 0) for t in range(k))


def greedy_select(M: int, n: int, d: int, m: int, k: int, *, calls=None,
                  row_bytes=None, constrained: bool = False,
                  weighted: bool = False, dev: Device = H100) -> Work:
    """One call, ``k`` launches: ``calls`` (row, step) scores
    (:func:`greedy_calls` where not given); the rows, E, the seed cur_min
    (and the eval weights), the availability mask (and the knapsack
    weights and group ids) read, the selections and cur_min written.

    The distances do not change across the steps, so the work is the
    cheaper on ``dev`` of two ways to have them: recomputed for every
    score (the kernel's way), or computed once for every (row, eval
    column) pair, written as an fp32 ``M·n × m`` matrix and read back for
    every score, where that matrix fits ``dev``'s memory.  Recomputing is
    the cheaper at small d (at d ≤ 11 on the H100, for any k)."""
    rb = 4 * d if row_bytes is None else row_bytes
    calls = greedy_calls(M, n, k) if calls is None else calls
    io = (M * n * rb + 4 * m * d + (8 if weighted else 4) * m + M * n
          + (8 * M * n if constrained else 0) + 4 * M * k + 4 * M * m)
    epilogue = 4 if weighted else 3
    fresh = gain_tile(calls * m, d, io, epilogue)
    pairs = M * n * m
    if 4 * pairs > dev.memory_bytes:
        return fresh
    once = Work((("tf32", pairs * 2 * d), ("fp32", calls * m * epilogue)),
                io + 4 * pairs + 4 * calls * m, overlap=True)
    return min((fresh, once), key=lambda w: w.bound_ms(dev)[0])


def threshold_select(M: int, n: int, d: int, m: int, *, rows=None,
                     row_bytes=None, constrained: bool = False) -> Work:
    """One τ-level (three launches): ``rows`` rows scored (every row where
    not given); the rows, their mask (and the knapsack weights and group
    ids), E and cur_min read, the accept mask and cur_min written, the
    per-machine scalars each way."""
    rb = 4 * d if row_bytes is None else row_bytes
    rows = M * n if rows is None else rows
    return gain_tile(rows * m, d, M * n * (rb + (8 if constrained else 0)
                                           + 2) + 4 * m * d + 8 * M * m
                     + 16 * M, 3)


# -- rbf_kernel -----------------------------------------------------------

def rbf_kernel(Mx: int, n: int, My: int, m: int, d: int) -> Work:
    """``(max(Mx, My), n, m)`` out of X ``(Mx, n, d)`` and Y ``(My, m, d)``
    (a shared operand read once): a dot (2d), the pair's norms (3), the
    scale, clamp and exp (3) an output element, fp32."""
    M = max(Mx, My)
    return Work((("fp32", M * n * m * (2 * d + 6)),),
                4 * (Mx * n * d + My * m * d + M * n * m))


# -- flash_attention ------------------------------------------------------

def visible_pairs(S: int, T: int, causal: bool, kv) -> int:
    """(query, key) pairs that take part: each query row sees the keys
    below kv_valid_len and, causal, at or before its own position."""
    kv = T if kv is None else min(kv, T)
    if not causal:
        return S * kv
    if kv >= T:
        # Σ_r min(T, r + 1 + T − S) in closed form: every r ≥ S − 1 sees T
        lo = T - S + 1
        if lo >= 1:
            return S * lo + S * (S - 1) // 2
    return sum(min(kv, r + 1 + T - S) for r in range(S))


def _rate(itemsize: int) -> str:
    return "bf16" if itemsize == 2 else "fp32"


def attention(B, H, Hkv, S, T, D, causal, kv, itemsize) -> Work:
    """The products (4 operations a visible pair and feature), and the
    bytes of q, the valid K/V and the output, each moved once."""
    kvn = T if kv is None else min(kv, T)
    return Work(((_rate(itemsize), 4 * B * H * D
                  * visible_pairs(S, T, causal, kv)),),
                itemsize * D * (2 * B * H * S + 2 * B * Hkv * kvn))


def attention_backward(B, H, Hkv, S, T, D, causal, itemsize) -> Work:
    """5 products of 2·D a visible pair, and the bytes of q, k, v, o, dO
    and the three gradients, and the fp32 log-sum-exp."""
    return Work(((_rate(itemsize), 5 * 2 * B * H * D
                  * visible_pairs(S, T, causal, None)),),
                itemsize * D * (4 * B * H * S + 4 * B * Hkv * T)
                + 4 * B * H * S)


# -- wkv6 -----------------------------------------------------------------

def wkv6(B, H, T, Dk, Dv, itemsize, state_in, y_itemsize) -> Work:
    """Every kernel of the forward (recurrent, decode, chunked): the bytes
    of r, k, v and u (``itemsize``), w (fp32), y (``y_itemsize``) and the
    fp32 state, read where given and written, each moved once, against
    5·Dk·Dv + 3·Dk + 2·Dv operations a step and head (the state update
    w·S + k·v, r·S, the bonus (r·u)·k and v·a) at the TF32 tensor-core
    rate (:meth:`Work.fp32_only_ms`: the recurrent kernel's CUDA
    cores)."""
    steps = B * H * T
    flops = steps * (5 * Dk * Dv + 3 * Dk + 2 * Dv)
    nbytes = (steps * ((2 * Dk + Dv) * itemsize + 4 * Dk + Dv * y_itemsize)
              + H * Dk * itemsize + 4 * B * H * Dk * Dv * (1 + int(state_in)))
    return Work((("tf32", flops),), nbytes)


def wkv6_backward(B, H, T, Dk, Dv, itemsize, dy_itemsize, state_in) -> Work:
    """Both routes of the backward: the bytes of r, k, v and dy read and
    dr, dk, dv written (``itemsize``, ``dy_itemsize``), w read and dw
    written (fp32), u read and du written, the fp32 S_0 and dS_T read and
    dS_0 written where ``state_in``, each moved once, against 14·Dk·Dv +
    12·Dk + 4·Dv operations a step and head (the state S_{t−1} (w·S + k·v,
    3), S·dy, G·v, G ⊙ S and Gᵀ·k each a product and a sum (8), the update
    w·G + r·dy (3); the bonus a_t and c_t, the u terms of dr and dk, and
    du) at the TF32 tensor-core rate, as :func:`wkv6`."""
    steps = B * H * T
    flops = steps * (14 * Dk * Dv + 12 * Dk + 4 * Dv)
    nbytes = (steps * (2 * (2 * Dk + Dv) * itemsize + Dv * dy_itemsize
                       + 8 * Dk) + 2 * H * Dk * itemsize
              + 4 * B * H * Dk * Dv * (3 if state_in else 0))
    return Work((("tf32", flops),), nbytes)


# -- the dry run's ledger ---------------------------------------------------

#: callbacks ``(counter, work)`` of the op analyzers that are counting
_sinks: list = []


def report(counter: str, work: Work) -> None:
    """A dry branch's call: ``work`` done under the launch counter
    ``counter`` (the call's first; the others it bumps carry launches
    only), handed to every op analyzer that is counting."""
    for sink in list(_sinks):
        sink(counter, work)
