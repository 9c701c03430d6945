"""Exemplar-clustering gains: the CUDA kernel, its plain version, its launch.

Replaces the TPU kernel ``repro.kernels.exemplar_gains.exemplar_gains_pallas``
(``src/repro/kernels/exemplar_gains.py:72``, ``pl.pallas_call`` at ``:107``).
Source: ``csrc/exemplar_gains.cu`` with the gain tile of
``csrc/exemplar_tile.cuh``.

What bounds it on the H100: fp32 FMA issue — (2d + 3) operations per
(candidate, eval column) pair, with no tensor-core route for fp32 outside
TF32, which the port does not use.  The design keeps an 8 x 4 block of dot
products per thread in registers, streams the feature axis through shared
memory in 8-wide passes (any d) and adds a leading machine axis to the
grid, so one launch scores every machine of a round.  Eval weights
(``WeightedExemplarClustering``) are the tile's weighted instantiation, a
kernel of their own: the unweighted one compiles as before.

The plain version is :func:`repro_torch.kernels.ref.exemplar_gains`; the
dispatch in :mod:`repro_torch.kernels.ops` takes it for CPU tensors only.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import exemplar_gains as plain  # noqa: F401

BN = 128   # candidate rows per block (csrc/exemplar_tile.cuh)
BM = 64    # eval columns per tile: E and cur_min are zero-padded to it


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
    fn = _build.load("exemplar_gains").exemplar_gains_launch
    stream = torch.cuda.current_stream(X.device).cuda_stream
    _build.check(fn(X.data_ptr(), E.data_ptr(), cur_min.data_ptr(),
                    out.data_ptr(), M, n, d, mp,
                    None if ew is None else ew.data_ptr(), stream),
                 "exemplar_gains")
    _build.launch_counts["exemplar_gains" if ew is None
                         else "exemplar_gains_weighted"] += 1
    return out
