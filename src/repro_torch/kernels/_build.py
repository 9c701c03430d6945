"""Build the CUDA sources with ``nvcc`` and load them with ``ctypes``.

Each ``csrc/<name>.cu`` becomes one shared library with a plain C entry
point, compiled for Hopper (``sm_90a``) into ``build/kernels/`` at the repo
root on first use.  The file name carries a digest of the sources, so an
edited kernel is rebuilt and a stale library is never loaded.  All missing
libraries are compiled together, one ``nvcc`` process per source.

Every entry point returns ``cudaGetLastError()`` after its launches; the
wrappers raise when it is not 0.  On ``meta`` operands (the dry run,
:func:`dry`) a wrapper loads nothing.
"""
from __future__ import annotations

import concurrent.futures
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = ("exemplar_gains", "greedy_select", "threshold_select",
           "rbf_kernel", "flash_attention", "flash_attention_bwd", "wkv6",
           "wkv6_decode", "wkv6_chunked", "wkv6_bwd", "wkv6_bwd_chunked")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _LL, _F = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                   ctypes.c_float)
# C signatures: every pointer and the stream as c_void_p (a plain int would
# be cut to 32 bits), sizes as long long, fp32 constants as float, the rest
# as int
ARGTYPES = {
    "exemplar_gains_launch": [_P, _I, _P, _P, _I, _P, _P, _P, _LL, _LL, _I,
                              _I, _P, _P],
    "exemplar_tile_smem": [_I, _I, _I],
    "greedy_select_launch": [_P, _I, _P, _P, _I] + [_P] * 7
    + [_LL, _LL, _I, _I, _I, _I, _LL, _P, _P, _P, _P, _P, _P, _I, _P, _P],
    "greedy_select_grid": [_LL, _LL, _I, _I, _I, _I, _I, _I],
    "threshold_select_launch": [_P, _I, _P, _P, _I] + [_P] * 19
    + [_LL, _LL] + [_I] * 6 + [_P, _P, _P],
    "threshold_select_max_groups": [_I, _I, _I, _I],
    "rbf_kernel_launch": [_P, _P, _P, _LL, _LL, _LL, _LL, _LL, _I, _F, _I,
                          _P],
    "flash_attention_prefill_launch": [_P] * 4 + [_LL] * 12 + [_I] * 8
    + [_F, _I, _P, _P],
    "flash_attention_prefill_wgmma_launch": [_P] * 4 + [_LL] * 12
    + [_I] * 8 + [_F, _P, _P],
    "flash_attention_decode_launch": [_P] * 4 + [_LL] * 12 + [_I] * 7
    + [_F, _I, _P, _P, _P, _P],
    "flash_attention_decode_shape": [_I, _I, _I, _I],
    "flash_attention_smem": [_I, _I],
    "flash_attention_bwd_delta_launch": [_P] * 3 + [_LL] * 6 + [_I] * 5
    + [_P],
    "flash_attention_bwd_dkdv_launch": [_P] * 9 + [_I] * 7 + [_F, _I, _P],
    "flash_attention_bwd_dq_launch": [_P] * 8 + [_I] * 7 + [_F, _I, _P],
    "flash_attention_bwd_dkdv_wgmma_launch": [_P] * 9 + [_I] * 7
    + [_F, _P],
    "flash_attention_bwd_dq_wgmma_launch": [_P] * 9 + [_I] * 7 + [_F, _P],
    "flash_attention_bwd_smem": [_I, _I],
    "wkv6_launch": [_P] * 8 + [_LL] * 15 + [_I] * 8 + [_P],
    "wkv6_smem": [_I, _I],
    "wkv6_decode_launch": [_P] * 8 + [_LL] * 10 + [_I] * 7 + [_P],
    "wkv6_chunked_launch": [_P] * 11 + [_LL] * 15 + [_I] * 8 + [_P],
    "wkv6_chunked_smem": [_I],
    "wkv6_bwd_launch": [_P] * 17 + [_I] * 11 + [_P],
    "wkv6_bwd_chunk": [_I, _I, _I],
    "wkv6_bwd_smem": [_I, _I, _I],
    "wkv6_bwd_chunked_launch": [_P] * 19 + [_I] * 7 + [_P],
    "wkv6_bwd_chunked_smem": [_I, _I, _I],
}
#: entry points that return a size rather than an error code
RESTYPES = {"exemplar_tile_smem": _LL, "greedy_select_grid": _LL}

#: kernel launches per kernel, counted by the wrappers where they launch
#: (re-exported as ``ops.launch_counts``).  The weighted launches (eval
#: weights, ``WeightedExemplarClustering``) are counted apart, and so are
#: greedy_select's unweighted launches with a constraint encoding (one a
#: greedy step); threshold_select's walk is two launches a τ-level, the head
#: (counted as threshold_select or threshold_select_weighted) and the tail
#: (threshold_select_tail), with the pre-pass between them
#: (threshold_select_prepass), weighted or not; rbf_kernel's launches that
#: take the row vector are counted once more (rbf_kernel_rowvec);
#: flash_attention's prefill (S > 1) and decode (S = 1) launches apart (the
#: prefill launches that take the tensor-core route are counted once more
#: under flash_attention_prefill_wgmma; a forward that saves the
#: log-sum-exp for the backward counted once more under
#: flash_attention_prefill_lse) and its backward's kernels
#: (flash_attention_bwd_delta, _dkdv, _dq; one launch each a call, no
#: _delta on the tensor-core route, whose dQ kernel writes Δ; its
#: launches counted once more under flash_attention_bwd_dkdv_wgmma and
#: _dq_wgmma); wkv6's
#: decode kernel's launches (wkv6_decode), its recurrent kernel's
#: (wkv6_recurrent), every call of
#: T > 1 on either prefill kernel (wkv6_prefill), the chunked kernel's
#: launches (three a call, wkv6_chunked) and its backward's: the recurrent
#: kernel's (wkv6_bwd, the scan, and wkv6_bwd_du, the sum of du over b: one
#: each a call) and the chunked kernel's (wkv6_bwd_chunked: three a call,
#: each chunk's own states, the scans, each chunk's gradients;
#: wkv6_bwd_chunked_du, du's sum over the chunks and b: one a call).  The
#: three gain-tile kernels' launches on narrow rows or with the bf16 x·e
#: contraction are counted once more under <kernel>_bf16 (bf16 rows),
#: <kernel>_q8 (int8 rows with scale and zero-point) and <kernel>_bf16dot
#: (threshold_select: its heads)
launch_counts: dict[str, int] = {
    name: 0 for name in (
        "exemplar_gains", "exemplar_gains_weighted", "exemplar_gains_bf16",
        "exemplar_gains_q8", "exemplar_gains_bf16dot", "greedy_select",
        "greedy_select_constrained", "greedy_select_weighted",
        "greedy_select_bf16", "greedy_select_q8", "greedy_select_bf16dot",
        "threshold_select", "threshold_select_weighted",
        "threshold_select_bf16", "threshold_select_q8",
        "threshold_select_bf16dot",
        "threshold_select_prepass", "threshold_select_tail", "rbf_kernel",
        "rbf_kernel_rowvec",
        "flash_attention_prefill", "flash_attention_prefill_wgmma",
        "flash_attention_decode", "flash_attention_prefill_lse",
        "flash_attention_bwd_delta", "flash_attention_bwd_dkdv",
        "flash_attention_bwd_dq", "flash_attention_bwd_dkdv_wgmma",
        "flash_attention_bwd_dq_wgmma",
        "wkv6_prefill", "wkv6_decode", "wkv6_recurrent", "wkv6_chunked",
        "wkv6_bwd", "wkv6_bwd_du", "wkv6_bwd_chunked",
        "wkv6_bwd_chunked_du")}
#: ptxas register/shared-memory report of each library built in this process
build_log: dict[str, str] = {}
#: wall seconds from the start of a build to the end of each library's nvcc
build_seconds: dict[str, float] = {}

_libs: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(home) / "bin" / "nvcc"
    found = str(path) if path.exists() else shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA kernels "
                           "are built from source at first use")
    return found


_flags: list[str] = []
_flags_lock = threading.Lock()


def nvcc_flags() -> tuple[str, ...]:
    """``NVCC_FLAGS``, and ``--split-compile=0`` where this ``nvcc`` takes
    it (its optimization passes then run on every host thread: the
    flash_attention library, the longest, builds in less wall time)."""
    with _flags_lock:
        if not _flags:
            extra = []
            try:
                found = "--split-compile" in subprocess.run(
                    [_nvcc(), "--help"], capture_output=True, text=True,
                    timeout=60).stdout
            except (OSError, RuntimeError, subprocess.SubprocessError):
                found = False
            if found:
                extra = ["--split-compile=0"]
            _flags.extend([*NVCC_FLAGS, *extra])
        return tuple(_flags)


def lib_path(name: str) -> Path:
    h = hashlib.sha256()
    for src in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(src.read_bytes())
    h.update(" ".join(nvcc_flags()).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def build_all(names=SOURCES) -> float:
    """Compile every library in ``names`` that is missing, all at once;
    returns the wall seconds spent."""
    todo = [n for n in names if not lib_path(n).exists()]
    if not todo:
        return 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    procs = {}
    for name in todo:
        tmp = lib_path(name).with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *nvcc_flags(), "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    def wait(name):
        out, _ = procs[name][1].communicate()
        build_seconds[name] = time.perf_counter() - t0
        return out

    failed = []
    with concurrent.futures.ThreadPoolExecutor(len(procs)) as pool:
        outs = dict(zip(procs, pool.map(wait, procs)))
    for name, (tmp, proc) in procs.items():
        build_log[name] = outs[name]
        if proc.returncode != 0:
            failed.append(f"{name}:\n{outs[name]}")
        else:
            os.replace(tmp, lib_path(name))
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return time.perf_counter() - t0


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build_all((name,))
            lib = ctypes.CDLL(str(lib_path(name)))
            for fn, argtypes in ARGTYPES.items():
                if hasattr(lib, fn):
                    getattr(lib, fn).argtypes = argtypes
                    getattr(lib, fn).restype = RESTYPES.get(fn, ctypes.c_int)
            _libs[name] = lib
        return lib


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")


def dry(t) -> bool:
    """Whether a wrapper's operand is the dry run's stand-in for a card
    tensor: a tensor on the ``meta`` device (shape, type and strides, no
    data).  The wrapper then runs its checks, allocates its outputs and
    scratch, bumps its launch counters and reports its call's work
    (:func:`repro_torch.kernels.cost.report`), and builds, loads and
    launches nothing.  The branch follows the operands alone: a CUDA
    tensor launches (or raises), never the dry branch."""
    return t.device.type == "meta"


def on_card(t) -> bool:
    """A tensor on the card, or on the dry run's stand-in for it."""
    return t.device.type in ("cuda", "meta")
