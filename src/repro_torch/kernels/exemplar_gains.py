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
(candidate, eval column) pair (clamp, subtract, clamp, add).  A leading
machine axis on the grid scores every machine of a round in one launch.
Eval weights (``WeightedExemplarClustering``) are the tile's weighted
instantiation, a kernel of their own: the add becomes an fma with the
weight, so unit weights give the unweighted bits.

The plain version is :func:`repro_torch.kernels.ref.exemplar_gains`; the
dispatch in :mod:`repro_torch.kernels.ops` takes it for CPU tensors only.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import exemplar_gains as plain  # noqa: F401

BN = 128   # candidate rows per block (csrc/exemplar_tile.cuh)
BM = 64    # E and cur_min are zero-padded to a multiple of it


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
           ew: torch.Tensor | None = None) -> torch.Tensor:
    """Raw gain sums ``(M, n)`` on the card (not divided by m).

    X ``(M, n, d)``, E ``(mp, d)`` with ``mp % BM == 0`` and cur_min
    ``(M, mp)``, all fp32, contiguous and on one CUDA device; ``ew``
    ``(mp,)`` the eval weights, zero-padded like cur_min (``None``: the
    unweighted instantiation).
    """
    M, n, d = X.shape
    mp = E.shape[0]
    checks = [(X, (M, n, d)), (E, (mp, d)), (cur_min, (M, mp))]
    if ew is not None:
        checks.append((ew, (mp,)))
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
    _build.check(fn(X.data_ptr(), E.data_ptr(), cur_min.data_ptr(),
                    out.data_ptr(), M, n, d, mp,
                    None if ew is None else ew.data_ptr(), stream),
                 "exemplar_gains")
    _build.launch_counts["exemplar_gains" if ew is None
                         else "exemplar_gains_weighted"] += 1
    return out
