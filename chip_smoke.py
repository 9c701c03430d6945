#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py      # every phase, one CUDA card

Phases, each failing the run (non-zero exit, no ``ok`` line) on any error:

1. setup — the card's name and power limit, torch's version, a digest of
   the port's sources, the kernels' build from
   ``src/repro_torch/kernels/csrc`` (one nvcc per source);
2. kernels — ``exemplar_gains`` and ``greedy_select`` against their plain
   PyTorch versions on the card, d ∈ {6, 17, 64, 3072}, ragged n and m,
   M ∈ {1, 7}, and one M = 1 machine of more than 512 candidate tiles;
3. scan path — ``run_algorithm("greedy", fused=False)`` on one 22,500-row
   block, launching ``exemplar_gains``; its selections and the fused
   path's against the plain greedy under the near-tie rule;
4. main path — TREE at the paper's Webscope deployment (Lucic et al. 2016
   §4.4: n = 45M, d = 6, μ = 22,500 = 0.05% of n, k = 50) and centralized
   greedy over the same ground set, on the card; the centralized
   selections against the plain greedy over all 45M rows;
5. times — each kernel at its path's shapes, held against its plain
   version there, timed beside it and beside its bound (fp32 FMA rate,
   memory rate).

Ends with one JSON line per kernel table and the ``ok`` line.  Imports
nothing of the JAX package.
"""
from __future__ import annotations

import hashlib
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# NVIDIA H100 SXM data sheet: fp32 outside the tensor cores, HBM3 rate
PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12
SEED = 0
WEBSCOPE = dict(n=45_000_000, d=6, k=50, mu=22_500, n_eval=512)


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def log(msg: str) -> None:
    print(msg, flush=True)


def eval_rows(data, n_eval: int):
    """The eval subsample, drawn as the repo's benchmarks draw it."""
    import numpy as np
    r = np.random.default_rng(0)
    return data[r.choice(len(data), min(n_eval, len(data)), replace=False)]


def cuda_ms(fn, runs: int, warmup: int = 1) -> float:
    """Median milliseconds of ``runs`` calls, timed with CUDA events.  Each
    timed call is queued behind a ~1 ms device sleep, so the host's launch
    overhead falls outside the event window: the time is the device's."""
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        torch.cuda._sleep(2_000_000)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def bound_ms(flops: float, nbytes: float) -> tuple[float, str]:
    t_ops, t_bytes = flops / PEAK_FP32, nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


def phase_setup():
    import torch
    from repro_torch.kernels import _build
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if smi.returncode != 0:
        fail(f"nvidia-smi: {smi.stderr.strip()}")
    log(smi.stdout.strip().splitlines()[0])
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")
    digest = hashlib.sha256()
    for f in sorted([ROOT / Path(__file__).name,
                     *(ROOT / "src" / "repro_torch").rglob("*.py"),
                     *(ROOT / "src" / "repro_torch").rglob("*.cu*")]):
        digest.update(f.relative_to(ROOT).as_posix().encode())
        digest.update(f.read_bytes())
    log(f"source digest (chip_smoke.py + src/repro_torch): "
        f"{digest.hexdigest()[:16]}")
    t = _build.build_all()
    log(f"kernel build: {t:.2f} s ({', '.join(_build.SOURCES)})")
    for name, out in _build.build_log.items():
        for line in out.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas {name}: {line.strip()}")


def _dataset(d: int, n: int, seed: int):
    from repro_torch.data import datasets
    gen = {6: datasets.webscope, 17: datasets.csn, 64: datasets.large_scale,
           3072: datasets.tiny}[d]
    return gen(n=n, d=d, seed=seed)


def check_greedy(sel, cm_out, T, E, e0, trace, what: str
                 ) -> tuple[int, int, float]:
    """greedy_select's output against the plain greedy's ``trace``: each
    machine's selections exactly up to its first near tie, and every
    machine's cur_min against the plain refresh of its own selections (and
    against the plain cur_min where the selections are identical).
    Returns (near-tie steps, machines identical, max |Δ cur_min|)."""
    import torch
    from repro_torch import testing
    from repro_torch.kernels import ref
    sel_p, cm_p, gap, best = trace
    ok, n_tie = testing.selections_agree(sel, sel_p, gap, best)
    if not ok:
        fail(f"{what}: sel differs from the plain greedy before any near tie")
    want = ref.refresh_cur_min(T, E, e0, sel)
    testing.assert_close(cm_out, want, f"{what}: cur_min, every machine")
    same = torch.all(sel == sel_p, dim=-1)
    testing.assert_close(cm_out[same], cm_p[same],
                         f"{what}: cur_min, machines selecting as plain")
    return n_tie, int(same.sum()), max(testing.max_abs_err(cm_out, want),
                                       testing.max_abs_err(cm_out[same],
                                                           cm_p[same]))


def phase_kernels() -> None:
    """Both kernels against their plain versions at ragged shapes."""
    import numpy as np
    import torch
    from repro_torch import testing
    from repro_torch.kernels import ops, ref
    cases = [(M, n, m, d, k) for d, n, m, k in
             ((6, 1000, 300, 10), (17, 777, 130, 12), (64, 501, 99, 8),
              (3072, 300, 70, 5)) for M in (1, 7)]
    # one machine of 782 candidate tiles: the commit's reduction loop over
    # tile winners goes round more than once (512 threads)
    cases.append((1, 100_003, 300, 6, 10))
    ties = 0
    for M, n, m, d, k in cases:
        X = _dataset(d, M * n + m, seed=100 + d)
        E = torch.as_tensor(X[M * n:], device="cuda")
        T = torch.as_tensor(X[:M * n].reshape(M, n, d), device="cuda")
        mask = torch.as_tensor(
            np.random.default_rng(d * M).random((M, n)) < 0.85, device="cuda")
        e0 = torch.sum(E * E, dim=-1)
        trace = ref.greedy_select_trace(T, E, e0, mask, k)
        for cm in (e0, trace[1]):               # first step, and after k
            g = ops.exemplar_gains(T, E, cm)
            g_p = ref.exemplar_gains(T, E, cm)
            testing.assert_close(g, g_p, f"exemplar_gains M={M} n={n} m={m} "
                                         f"d={d}")
        sel, cm_out = ops.greedy_select(T, E, e0, mask, k)
        torch.cuda.synchronize()
        n_tie, same, err = check_greedy(sel, cm_out, T, E, e0, trace,
                                        f"greedy_select M={M} n={n} m={m} "
                                        f"d={d}")
        ties += n_tie
        log(f"  kernels M={M} n={n} m={m} d={d} k={k}: gains, sel, cur_min "
            f"agree ({same}/{M} machines select as plain, max|dcm| "
            f"{err:.3g}, near-tie steps {n_tie})")
    log(f"kernels vs plain: {len(cases)} shapes agree within rtol="
        f"{testing.RTOL} atol={testing.ATOL}; near-tie steps {ties}")


def phase_scan() -> dict:
    """Scan path through exemplar_gains on one 22,500-row block."""
    import torch
    from repro_torch import testing
    from repro_torch.convert import objective_from_numpy
    from repro_torch.core.algorithms import run_algorithm
    from repro_torch.data import datasets
    from repro_torch.kernels import ops, ref
    k, mu = WEBSCOPE["k"], WEBSCOPE["mu"]
    data = datasets.webscope(n=mu, d=WEBSCOPE["d"])
    obj = objective_from_numpy(eval_rows(data, WEBSCOPE["n_eval"]), "cuda")
    T = torch.as_tensor(data, device="cuda")
    mask = torch.ones((mu,), dtype=torch.bool, device="cuda")
    ops.reset_launch_counts()
    scan = run_algorithm("greedy", obj, T, mask, k, fused=False)
    torch.cuda.synchronize()
    counts = dict(ops.launch_counts)
    if counts["exemplar_gains"] == 0:
        fail("scan path launched exemplar_gains no time")
    fused = run_algorithm("greedy", obj, T, mask, k)
    seed = torch.sum(obj.eval_set ** 2, dim=-1)
    sel_p, _, gap, best = ref.greedy_select_trace(T, obj.eval_set, seed,
                                                  mask, k)
    for name, sel in (("scan", scan.sel_idx), ("fused", fused.sel_idx),
                      ("scan vs fused", scan.sel_idx)):
        other = fused.sel_idx if name == "scan vs fused" else sel_p
        ok, n_tie = testing.selections_agree(sel, other, gap, best)
        if not ok:
            fail(f"{name}: selections differ from the plain greedy's "
                 f"before any near tie")
    testing.assert_close(scan.value, fused.value, "scan vs fused value")
    if int(scan.oracle_calls) != int(fused.oracle_calls):
        fail("scan and fused oracle calls differ")
    log(f"scan path: {mu} rows, k={k}, launches {counts}, value "
        f"{float(scan.value)!r} (fused {float(fused.value)!r}); scan and "
        f"fused select as the plain greedy, near-tie steps {n_tie}")
    return {"T": T, "obj": obj, "launches": counts["exemplar_gains"],
            "cur_min": obj.update(obj.init_state(T, mask), T,
                                  scan.sel_idx[0])["cur_min"]}


def phase_main() -> dict:
    """TREE and centralized greedy at the Webscope deployment."""
    import numpy as np
    import torch
    from repro_torch import testing
    from repro_torch.convert import objective_from_numpy
    from repro_torch.core import (TorchPlan, TreeConfig, centralized_greedy,
                                  tree_maximize)
    from repro_torch.data import datasets
    from repro_torch.kernels import ops, ref
    n, d, k, mu = (WEBSCOPE[key] for key in ("n", "d", "k", "mu"))
    t0 = time.perf_counter()
    data = datasets.webscope(n=n, d=d)
    obj = objective_from_numpy(eval_rows(data, WEBSCOPE["n_eval"]), "cuda")
    X = torch.as_tensor(data, device="cuda")
    del data
    log(f"main path data: webscope n={n} d={d} ({X.numel() * 4 / 1e9:.2f} GB "
        f"on the card) in {time.perf_counter() - t0:.1f} s")
    cfg = TreeConfig(k=k, capacity=mu, seed=SEED)
    ops.reset_launch_counts()
    tree = tree_maximize(obj, X, cfg, device="cuda", plan=TorchPlan(SEED))
    torch.cuda.synchronize()
    counts = dict(ops.launch_counts)
    ops.reset_launch_counts()
    t1 = time.perf_counter()
    cent = centralized_greedy(obj, X, k, device="cuda")
    cent_value = float(cent.value)
    cent_wall = time.perf_counter() - t1
    cent_counts = dict(ops.launch_counts)
    ratio = tree.value / cent_value
    bound = cfg.round_bound_exact(n)
    log(f"TREE: rounds {tree.rounds} (bound {bound}), machines/round "
        f"{tree.machines_per_round}, oracle calls {tree.oracle_calls}, "
        f"value {tree.value!r}")
    log(f"TREE round walls (CUDA events, s): {tree.round_walls}; total "
        f"{tree.total_wall_s:.3f} s; round values {tree.round_values}")
    log(f"TREE launches: {counts}")
    log(f"centralized greedy: value {cent_value!r}, wall {cent_wall:.3f} s, "
        f"launches {cent_counts}")
    log(f"TREE / centralized value ratio: {ratio!r}")
    if counts["greedy_select"] == 0:
        fail("main path launched greedy_select no time")
    if tree.rounds > bound:
        fail(f"rounds {tree.rounds} exceed round_bound_exact {bound}")
    if not (math.isfinite(tree.value) and math.isfinite(cent_value)):
        fail("non-finite value")
    if tree.sel_rows.shape != (k, d) or int(tree.sel_mask.sum()) != k:
        fail("TREE selection has the wrong shape or count")
    rescore = obj.evaluate(torch.as_tensor(tree.sel_rows, device="cuda"),
                           torch.as_tensor(tree.sel_mask, device="cuda"))
    testing.assert_close(float(rescore), tree.value, "TREE value re-scored")
    if ratio < 0.9:
        fail(f"TREE/centralized ratio {ratio} below 0.9")
    # the centralized run (greedy_select at M = 1 over 351,563 tiles)
    # against the plain greedy over all n rows, chunked over rows
    testing.assert_close(cent_value, float(obj.evaluate(cent.sel_rows,
                                                        cent.sel_mask)),
                         "centralized value re-scored")
    t2 = time.perf_counter()
    E = obj.eval_set
    sel_p, _, gap, best = ref.greedy_select_trace(
        X, E, torch.sum(E * E, dim=-1),
        torch.ones((n,), dtype=torch.bool, device="cuda"), k)
    torch.cuda.synchronize()
    rows_p = X[torch.clamp_min(sel_p, 0)]
    same = torch.where(sel_p >= 0, torch.all(cent.sel_rows == rows_p, dim=-1)
                       & cent.sel_mask, ~cent.sel_mask)
    ok, n_tie = testing.selections_agree(torch.where(same, sel_p, -2), sel_p,
                                         gap, best)
    if not ok:
        fail("centralized greedy selects apart from the plain greedy before "
             "any near tie")
    if bool(torch.all(same)):
        testing.assert_close(cent_value, float(obj.evaluate(rows_p,
                                                            sel_p >= 0)),
                             "centralized value vs plain greedy")
    log(f"centralized vs plain greedy over {n} rows: {int(same.sum())}/{k} "
        f"steps select the same row, near-tie steps {n_tie} (plain "
        f"{time.perf_counter() - t2:.1f} s)")
    return {"X": X, "obj": obj, "cfg": cfg, "launches": counts}


def phase_times(scan: dict, main: dict) -> list[dict]:
    """Each kernel at its path's shapes: time, plain time, bound."""
    import torch
    from repro_torch import testing
    from repro_torch.core import TorchPlan
    from repro_torch.core import partition as part_lib
    from repro_torch.kernels import exemplar_gains as _eg
    from repro_torch.kernels import ops, ref
    rows = []
    # exemplar_gains at the scan path's block
    T, obj, cm = scan["T"], scan["obj"], scan["cur_min"]
    E = obj.eval_set
    n, d = T.shape
    m = E.shape[0]
    g, g_p = ops.exemplar_gains(T, E, cm), ref.exemplar_gains(T, E, cm)
    testing.assert_close(g, g_p, "exemplar_gains at the scan block")
    err = testing.max_abs_err(g, g_p)
    # the kernel alone, on operands padded once; the whole ops call beside
    Xb = T.unsqueeze(0).contiguous()
    Ep, cmp_ = ops._pad_eval(E, cm.reshape(1, m))
    ms = cuda_ms(lambda: _eg.launch(Xb, Ep, cmp_), runs=50)
    ms_ops = cuda_ms(lambda: ops.exemplar_gains(T, E, cm), runs=50)
    plain = cuda_ms(lambda: ref.exemplar_gains(T, E, cm), runs=50)
    log(f"exemplar_gains at the scan block: kernel {ms:.4f} ms, whole ops "
        f"call (padding, launch, division) {ms_ops:.4f} ms")
    b, by = bound_ms(n * m * (2 * d + 3), 4 * (n * d + m * d + m + n))
    rows.append({"name": "exemplar_gains", "route": "cuda",
                 "source": "src/repro_torch/kernels/csrc/exemplar_gains.cu",
                 "replaces": "src/repro/kernels/exemplar_gains.py:107",
                 "launches": scan["launches"], "max_abs_err": err, "ms": ms,
                 "plain_ms": plain, "bound_ms": b, "bound_by": by,
                 "library_ms": None})
    # greedy_select at round 0 of the main path
    X, obj, cfg = main["X"], main["obj"], main["cfg"]
    E = obj.eval_set
    N = X.shape[0]
    L = part_lib.n_parts(N, cfg.capacity)
    part = part_lib.balanced_partition(TorchPlan(SEED), 0, N, L,
                                       cap=cfg.capacity, device="cuda")
    blocks, bmask = part_lib.gather_partition(X, part)
    M, mu, d = blocks.shape
    m, k = E.shape[0], cfg.k
    seed = torch.sum(E * E, dim=-1)
    sel, cm_out = ops.greedy_select(blocks, E, seed, bmask, k)
    t0 = time.perf_counter()
    trace = ref.greedy_select_trace(blocks, E, seed, bmask, k)
    torch.cuda.synchronize()
    log(f"plain greedy at round 0 (M={M}): {time.perf_counter() - t0:.1f} s")
    n_tie, same, err = check_greedy(sel, cm_out, blocks, E, seed, trace,
                                    "greedy_select at round 0")
    log(f"greedy_select round 0 vs plain: {same}/{M} machines select as "
        f"plain, every machine's cur_min checked, near-tie steps {n_tie}, "
        f"max|dcm| {err:.3g}")
    ms = cuda_ms(lambda: ops.greedy_select(blocks, E, seed, bmask, k),
                 runs=10)
    plain = cuda_ms(lambda: ref.greedy_select(blocks, E, seed, bmask, k),
                    runs=3)
    n_avail = torch.sum(bmask.long(), dim=1, keepdim=True)
    steps = torch.arange(k, device="cuda")
    calls = int(torch.sum(torch.clamp_min(n_avail - steps, 0)))
    b, by = bound_ms(calls * m * (2 * d + 3),
                     4 * M * mu * d + 4 * m * d + 4 * m + M * mu
                     + 4 * M * k + 4 * M * m)
    rows.append({"name": "greedy_select", "route": "cuda",
                 "source": "src/repro_torch/kernels/csrc/greedy_select.cu",
                 "replaces": "src/repro/kernels/greedy_select.py:265",
                 "launches": main["launches"]["greedy_select"],
                 "max_abs_err": err, "ms": ms, "plain_ms": plain,
                 "bound_ms": b, "bound_by": by, "library_ms": None})
    for r in rows:
        log(f"time {r['name']}: {r['ms']:.4f} ms (plain {r['plain_ms']:.4f} "
            f"ms, bound {r['bound_ms']:.4f} ms by {r['bound_by']}, "
            f"{r['bound_ms'] / r['ms']:.1%} of bound), launches "
            f"{r['launches']}")
    return rows


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a card")
    if torch.cuda.device_count() < 1:
        fail("no CUDA device")
    phase_setup()
    phase_kernels()
    scan = phase_scan()
    main_path = phase_main()
    rows = phase_times(scan, main_path)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    log(smi.stdout.strip().splitlines()[0])
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
