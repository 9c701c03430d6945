"""Exemplar-clustering gains: the CUDA kernel, its plain version, its launch.

Replaces the TPU kernel ``repro.kernels.exemplar_gains.exemplar_gains_pallas``
(``src/repro/kernels/exemplar_gains.py:72``, ``pl.pallas_call`` at ``:107``).
Source: ``csrc/exemplar_gains.cu`` with the gain tile of
``csrc/exemplar_tile.cuh``.

The tile folds both squared norms into one product of depth
round_up(d + 2, 8) and runs it on the tensor cores as three TF32 products
per 8-deep k-step (hi·hi, hi·lo, lo·hi of each operand's TF32 split, which
keeps fp32's accuracy; one unsplit TF32 product does not).  What bounds it
on the H100 is then the CUDA-core epilogue, four fp32 issue slots per
(candidate, eval column) pair (clamp, subtract, clamp, add).  One launch
scores every machine of a round on the tile's persistent grid (as
``greedy_select`` scores a step): resident CTAs per SM × 132, each walking
a contiguous range of the flattened (machine, 128-row tile) space with e~
staged once, a machine's cur_min when it enters the machine and the row
tiles double-buffered by ``cp.async``; a row's sum is the same tile call
as before and as the fused kernels', so the same bits.
Eval weights (``WeightedExemplarClustering``) are the tile's weighted
instantiation, a kernel of their own: the add becomes an fma with the
weight, so unit weights give the unweighted bits.

Narrow candidate rows (the TPU kernel's ``quantized`` instantiation, and
bf16 rows) and the bf16 x·e contraction (``compute_dtype``, the objective's
``score_dtype="bfloat16"``) are the tile's operand instantiations: bf16
rows, int8 rows with a per-row ``x_scale``/``x_zp`` dequantized as
``x·scale + zp`` in two fp32 roundings, each with or without the bf16
dot.  A row moves ``d·itemsize`` bytes (+ 8 of scale and zero-point at
int8); the operations do not change.  Their launches are counted once
more under ``exemplar_gains_bf16``, ``_q8`` and ``_bf16dot``.

The plain version is :func:`repro_torch.kernels.ref.exemplar_gains`; the
dispatch in :mod:`repro_torch.kernels.ops` takes it for CPU tensors only.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import exemplar_gains as plain  # noqa: F401

BN = 128   # candidate rows per block (csrc/exemplar_tile.cuh)
BM = 64    # E and cur_min are zero-padded to a multiple of it

#: the candidate row types the tile takes (its ``xtype`` codes)
XTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_SUFFIX = {1: "_bf16", 2: "_q8"}


def row_operand(X: torch.Tensor, x_scale, x_zp, what: str) -> int:
    """The tile's ``xtype`` of the candidate rows ``X`` ``(M, n, d)``:
    fp32, bf16, or int8 with ``x_scale``/``x_zp`` ``(M, n)`` contiguous
    fp32 on X's device (the other types take none).  Raises ValueError on
    anything else."""
    xtype = XTYPES.get(X.dtype)
    quantized = x_scale is not None or x_zp is not None
    if xtype is None or (xtype == 2) != quantized:
        raise ValueError(f"{what} kernel takes fp32 or bf16 rows, or int8 "
                         f"rows with x_scale and x_zp; got {X.dtype} rows "
                         f"{'with' if quantized else 'without'} them")
    for t in (x_scale, x_zp) if quantized else ():
        if (t is None or t.device != X.device or t.dtype != torch.float32
                or not t.is_contiguous() or tuple(t.shape) != X.shape[:2]):
            raise ValueError(f"{what} kernel: x_scale and x_zp must be "
                             f"contiguous fp32 tensors of shape "
                             f"{tuple(X.shape[:2])} on {X.device}")
    return xtype


def count_launches(kernel: str, name: str, xtype: int, bf16dot: bool,
                   n: int = 1) -> None:
    """Add ``n`` launches of ``kernel`` to its counter ``name`` and, for
    narrow rows or the bf16 dot, once more to ``<kernel>_bf16``,
    ``<kernel>_q8`` and ``<kernel>_bf16dot``."""
    _build.launch_counts[name] += n
    if xtype in _SUFFIX:
        _build.launch_counts[kernel + _SUFFIX[xtype]] += n
    if bf16dot:
        _build.launch_counts[kernel + "_bf16dot"] += n


def check_tile(device: torch.device, d: int, mp: int, weighted: bool,
               what: str) -> None:
    """Raise ValueError where the tile's shared memory at ``(d, mp)``
    (``csrc/exemplar_tile.cuh``'s ``Layout``, linear in mp) exceeds what a
    block of ``device`` may opt in to."""
    need = _build.load("exemplar_gains").exemplar_tile_smem(d, mp,
                                                            int(weighted))
    have = torch.cuda.get_device_properties(
        device).shared_memory_per_block_optin
    if need > have:
        raise ValueError(f"{what} kernel: d={d} mp={mp} needs {need} B of "
                         f"shared memory, the card gives a block {have}")


def launch(X: torch.Tensor, E: torch.Tensor, cur_min: torch.Tensor,
           ew: torch.Tensor | None = None, *, x_scale=None, x_zp=None,
           bf16dot: bool = False) -> torch.Tensor:
    """Raw gain sums ``(M, n)`` on the card (not divided by m).

    X ``(M, n, d)`` fp32, bf16, or int8 with ``x_scale``/``x_zp`` ``(M, n)``
    fp32; E ``(mp, d)`` with ``mp % BM == 0`` and cur_min ``(M, mp)``,
    fp32; all contiguous and on one CUDA device.  ``ew`` ``(mp,)`` the eval
    weights, zero-padded like cur_min (``None``: the unweighted
    instantiation); ``bf16dot`` contracts x·e in bf16.
    """
    M, n, d = X.shape
    mp = E.shape[0]
    xtype = row_operand(X, x_scale, x_zp, "exemplar_gains")
    checks = [(E, (mp, d)), (cur_min, (M, mp))]
    if ew is not None:
        checks.append((ew, (mp,)))
    if X.device.type != "cuda" or not X.is_contiguous():
        raise ValueError(f"exemplar_gains kernel takes contiguous CUDA rows, "
                         f"got {X.device}")
    for t, shape in checks:
        if (t.device.type != "cuda" or t.device != X.device
                or t.dtype != torch.float32 or not t.is_contiguous()
                or tuple(t.shape) != shape):
            raise ValueError(f"exemplar_gains kernel takes contiguous fp32 "
                             f"CUDA tensors of shape {shape}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
    if mp % BM or not 0 < M < 65536 or n >= 2 ** 31:
        raise ValueError(f"exemplar_gains kernel: unsupported shape "
                         f"M={M} n={n} mp={mp}")
    out = torch.empty((M, n), dtype=torch.float32, device=X.device)
    if n == 0:
        return out
    check_tile(X.device, d, mp, ew is not None, "exemplar_gains")
    fn = _build.load("exemplar_gains").exemplar_gains_launch
    stream = torch.cuda.current_stream(X.device).cuda_stream
    _build.check(fn(X.data_ptr(), xtype,
                    None if x_scale is None else x_scale.data_ptr(),
                    None if x_zp is None else x_zp.data_ptr(), int(bf16dot),
                    E.data_ptr(), cur_min.data_ptr(), out.data_ptr(), M, n,
                    d, mp, None if ew is None else ew.data_ptr(), stream),
                 "exemplar_gains")
    count_launches("exemplar_gains", "exemplar_gains" if ew is None
                   else "exemplar_gains_weighted", xtype, bf16dot)
    return out
