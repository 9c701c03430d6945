"""RBF kernel matrix: the CUDA kernel, its plain version, its launch.

Replaces the TPU kernel ``repro.kernels.rbf_kernel.rbf_kernel_pallas``
(``src/repro/kernels/rbf_kernel.py:31``, ``pl.pallas_call`` at ``:44``).
Source: ``csrc/rbf_kernel.cu``.

``K = exp(−max(‖x‖² + ‖y‖² − 2 x·y, 0)·inv_h2)`` with the host's
``inv_h2 = float32(1/(h·h))``, ``expf`` and no fast math.  The sums over the
feature axis run in order, each product rounded before its add, so the
kernel and its plain version give a pair the same squared distance (see
``csrc/rbf_kernel.cu``).  Two instantiations, chosen by :func:`rowvec`:
the 32 × 128 output tile, and for a few X rows (``ActiveSetSelection``'s
update: one row against every candidate) the row vector, in which a CTA
streams 1,024 consecutive Y rows of one machine with 16-byte loads and
keeps the X rows in shared memory.  A leading machine grid axis with a
machine stride per operand, 0 for an operand every machine shares
(``FacilityLocation``'s eval set), so a shared operand is never copied per
machine.

What bounds it on the H100: bytes — the output is 4·n·m bytes per machine
(92 GB a step at the ``FacilityLocation`` gain shape of a Webscope round 0,
which its caller scores in candidate chunks), and at the
``ActiveSetSelection`` update shape it reads every candidate row once; the
``exp`` rate on the SFUs is the next limit.

The plain version is :func:`repro_torch.kernels.ref.rbf_kernel`; the
dispatch in :mod:`repro_torch.kernels.ops` takes it for CPU tensors only.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import rbf_kernel as plain  # noqa: F401

ROWS = 32     # X rows per output tile (csrc/rbf_kernel.cu)
COLS = 128    # Y rows per output tile
ROWVEC_N = 4  # the row vector takes n <= ROWVEC_N X rows ...
ROWVEC_D = 32  # ... of d <= ROWVEC_D features
SPAN = 1024   # Y rows per row-vector CTA
_GRID_YZ = 65535


def rowvec(n: int, d: int) -> bool:
    """The rule: the row vector for n ≤ 4 X rows of d ≤ 32 features, where
    a 32-row tile would leave most of its rows empty (n = 1 at
    ``ActiveSetSelection``'s update); the 32 × 128 tile otherwise."""
    return n <= ROWVEC_N and d <= ROWVEC_D


def _rows_operand(t: torch.Tensor, M: int, what: str):
    """(tensor, machine stride in elements) of a ``(Mt, r, d)`` operand whose
    rows are contiguous; stride 0 where one machine's rows are shared."""
    if (t.device.type != "cuda" or t.dtype != torch.float32
            or t.dim() != 3 or t.shape[0] not in (1, M)):
        raise ValueError(f"rbf_kernel kernel takes fp32 CUDA tensors "
                         f"(Mt, rows, d) with Mt in (1, {M}), got {what} "
                         f"{t.dtype} {tuple(t.shape)} on {t.device}")
    d = t.shape[2]
    if t.shape[1] > 1 and t.stride(1) != d or d > 1 and t.stride(2) != 1:
        t = t.contiguous()
    return t, (t.stride(0) if t.shape[0] > 1 else 0)


def launch(X: torch.Tensor, Y: torch.Tensor, h: float) -> torch.Tensor:
    """``K`` ``(M, n, m)`` on the card for X ``(Mx, n, d)`` and Y
    ``(My, m, d)``, ``Mx, My ∈ {1, M}``; each operand's rows must be
    contiguous (a slice along the row axis of a machine stack is taken as
    it is, by its machine stride)."""
    M = max(X.shape[0], Y.shape[0])
    X, sx = _rows_operand(X, M, "X")
    Y, sy = _rows_operand(Y, M, "Y")
    n, m, d = X.shape[1], Y.shape[1], X.shape[2]
    if Y.device != X.device or Y.shape[2] != d:
        raise ValueError(f"rbf_kernel kernel: X {tuple(X.shape)} on "
                         f"{X.device} and Y {tuple(Y.shape)} on {Y.device} "
                         f"do not pair up")
    vec = rowvec(n, d)
    if (not 0 < M <= _GRID_YZ or -(-n // ROWS) > _GRID_YZ
            or -(-m // (SPAN if vec else COLS)) >= 2 ** 31
            or not 0 < d < 2 ** 31):
        raise ValueError(f"rbf_kernel kernel: unsupported shape M={M} n={n} "
                         f"m={m} d={d}")
    out = torch.empty((M, n, m), dtype=torch.float32, device=X.device)
    if n == 0 or m == 0:
        return out
    inv_h2 = float(np.float32(1.0 / (float(h) * float(h))))
    fn = _build.load("rbf_kernel").rbf_kernel_launch
    stream = torch.cuda.current_stream(X.device).cuda_stream
    _build.check(fn(X.data_ptr(), Y.data_ptr(), out.data_ptr(), sx, sy, M, n,
                    m, d, inv_h2, int(vec), stream), "rbf_kernel")
    _build.launch_counts["rbf_kernel"] += 1
    if vec:
        _build.launch_counts["rbf_kernel_rowvec"] += 1
    return out

