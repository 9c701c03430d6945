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
   ``greedy_select`` under knapsack, partition and both (d ∈ {6, 17},
   M ∈ {1, 7}, G ∈ {1, 8}, budgets that bind); ``threshold_select``
   unconstrained and under knapsack ∩ partition at bn ∈ {16, 256}, ragged
   n and n < 256, mid-ladder state, a stop flag raised in an early block,
   M = 1 over more than 100 blocks, and the most partition groups a
   launch takes (one more raises); the HMMA instructions (the gain tile's
   TF32 products) in the SASS of the three libraries built on the tile;
3. scan path — ``run_algorithm("greedy", fused=False)`` on one 22,500-row
   block, launching ``exemplar_gains``; its selections and the fused
   path's against the plain greedy under the near-tie rule;
4. main path — TREE at the paper's Webscope deployment (Lucic et al. 2016
   §4.4: n = 45M, d = 6, μ = 22,500 = 0.05% of n, k = 50) and centralized
   greedy over the same ground set, on the card; the centralized
   selections against the plain greedy over all 45M rows;
5. constrained — the same deployment with per-row attributes (a weight
   ~ U(0.2, 1.0) and one of 8 groups) under Knapsack(0.45k) ∩
   PartitionMatroid(k/4 per group): GREEDY TREE against the constrained
   centralized greedy (ratio ≥ 0.9), THRESHOLD-BATCH TREE at ε = 0.5
   unconstrained and constrained (gap ≤ ε), every coreset feasible and
   re-scored, τ-ladder depth ≤ 1 + ⌈log(2k/ε)/ε⌉; the constrained
   centralized selections against the plain constrained greedy;
6. other objectives — ActiveSetSelection (Parkinsons analog, Webscope),
   FacilityLocation and the weighted exemplar objective at Webscope;
7. attention kernels (run after phase 2, as are 8 to 12) —
   ``flash_attention`` against its plain version in fp32 and bf16: D ∈
   {16, 64, 128, 256}, GQA groups 1/4/8, causal and not, the (T − S)
   offset, ragged S and T, the tensor-core prefill's tile edges on the
   model's strided views, decode with kv_valid_len (split over the keys
   and not), and the 32k prefill; each case's route held against the
   launch counters, ptxas's registers and spills of the new kernels, and
   the HGMMA instructions of the built library;
8. LM parity — Qwen3-8B at full width and 2 layers, prefill and decode on
   the card against the CPU's plain path on the same weights;
9. LM serving — Qwen3-8B at full width and depth through
   ``greedy_generate`` (8 prompts of 2,048 tokens, 32 new), every
   attention launch counted (every prefill launch on the tensor-core
   route), the last decode step against ``forward``,
   prefill and decode times, memory peak and attention's share;
10. wkv6 kernel (run after phase 7) — ``wkv6`` against its plain version
   in fp32 and bf16: Dk = Dv ∈ {16, 64}, Dk ≠ Dv, ragged T, B × H = 1 and
   256, strided views, a given state, T = 2,100, chaining over the halves
   of T, a decode step in place, the shapes it does not take;
11. RWKV parity — rwkv6-1.6b at full width and 2 layers, card against the
   CPU's plain path, as phase 8;
12. RWKV serving — rwkv6-1.6b at full width and depth (24 layers) as
   phase 9, every ``wkv6`` launch counted (24 prefill, 24 × 31 decode);
13. times — each kernel at its path's shapes, held against its plain
   version there, timed beside it and beside its bound (fp32 FMA rate,
   TF32 or bf16 tensor-core rate, memory rate), and ``flash_attention``
   beside PyTorch's ``scaled_dot_product_attention``; the gain tile
   against the plain gains on every round-0 machine after 0, 25 and 49
   plain greedy steps; one ``greedy_select`` call launching k kernels;
   the share of blocks the threshold pre-pass flags at each timed level.

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

# NVIDIA H100 SXM data sheet: fp32 outside the tensor cores, dense bf16 on
# the tensor cores, HBM3 rate
PEAK_FP32 = 67e12
PEAK_TF32 = 495e12
PEAK_BF16 = 989e12
PEAK_BYTES = 3.35e12
SEED = 0
WEBSCOPE = dict(n=45_000_000, d=6, k=50, mu=22_500, n_eval=512)
N_GROUPS = 8
EPS = 0.5
# share of machines whose accept sets must match the plain version's in
# full under the near-threshold rule
FULL_SHARE = 0.9
# LM logits, card against the CPU's plain path at full width (2 layers):
# bf16 matmuls round at other places in cuBLAS and on the CPU, as between
# the two packages on the CPU (testing.LM_ATOL: four bf16 ulps of a logit
# in [4, 8)); measured on an H100 over two weight draws: 0.039-0.047
# (Qwen3-8B), 0.046875 both times (rwkv6-1.6b)
LM_PARITY_TOL = 0.125
# the last decode step against forward at full depth: the gate of
# tests/test_models.py at 4 layers; measured on an H100 over two weight
# draws: 0.073-0.081 (Qwen3-8B, 36 layers); 0.176-0.180 (rwkv6-1.6b, 24
# layers, whose decode keeps the WKV output in fp32 where forward rounds it
# to bf16, as the JAX package's two paths do)
LM_SERVE_TOL = 0.25


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


def tile_bound(pairs: float, d: int, nbytes: float, epilogue: int
               ) -> tuple[float, str, float]:
    """The bound of a kernel on the gain tile, with the distances on the
    tensor cores: the larger of the 2d-flop products per (row, eval
    column) pair at the TF32 rate and the ``epilogue`` remaining operations
    a pair (3; 4 with eval weights) at the fp32 rate, against the bytes.
    Returns (bound ms, what bounds it, the fp32-only bound of the CUDA-core
    tile: all 2d + epilogue operations at the fp32 rate)."""
    t_ops = max(pairs * 2 * d / PEAK_TF32, pairs * epilogue / PEAK_FP32)
    t_bytes = nbytes / PEAK_BYTES
    fp32_only, _ = bound_ms(pairs * (2 * d + epilogue), nbytes)
    return (1e3 * max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes", fp32_only)


def check_step_launches(name: str, fn, k: int) -> None:
    """One greedy_select call launches its kernel once a step: k launches,
    counted under ``name``."""
    import torch
    from repro_torch.kernels import ops
    ops.reset_launch_counts()
    fn()
    torch.cuda.synchronize()
    got = ops.launch_counts[name]
    if got != k:
        fail(f"{name}: {got} launches for one call of k = {k} steps")
    log(f"{name}: one call of k = {k} launched {got} kernels (one a step)")


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
    hmma_counts()


def eval_weights(m: int, seed: int):
    """Eval weights as the serve layer draws them: U(0.5, 1.5), normalised
    to mean 1, fp32 on the card."""
    import numpy as np
    import torch
    w = np.random.default_rng(seed).uniform(0.5, 1.5, m)
    return torch.as_tensor((w / w.mean()).astype(np.float32), device="cuda")


def phase_kernels_rbf() -> None:
    """rbf_kernel against its plain version at ragged shapes, with the
    machine axis on either operand or both; K(x, x) within [1 − tol, 1]."""
    import numpy as np
    import torch
    from repro_torch import testing
    from repro_torch.kernels import ops, ref
    tol = testing.ATOL + testing.RTOL
    cases = [(Mx, My, n, m, d) for d, n, m in ((1, 37, 300), (6, 33, 129),
                                                (22, 70, 1000),
                                                (64, 129, 77))
             for Mx, My in ((1, 1), (3, 1), (1, 3), (3, 3))]
    worst = 0.0
    for Mx, My, n, m, d in cases:
        r = np.random.default_rng(n * d + Mx)
        X = torch.as_tensor(r.standard_normal((Mx, n, d)) / np.sqrt(d),
                            dtype=torch.float32, device="cuda")
        Y = torch.as_tensor(r.standard_normal((My, m, d)) / np.sqrt(d),
                            dtype=torch.float32, device="cuda")
        for h in (0.5, 1.0):
            K = ops.rbf_kernel(X, Y, h)
            torch.cuda.synchronize()
            testing.assert_close(K, ref.rbf_kernel(X, Y, h),
                                 f"rbf_kernel Mx={Mx} My={My} n={n} m={m} "
                                 f"d={d} h={h}")
            worst = max(worst, testing.max_abs_err(K, ref.rbf_kernel(X, Y,
                                                                     h)))
            Kxx = torch.diagonal(ops.rbf_kernel(Y, Y, h), dim1=-2, dim2=-1)
            if not bool(torch.all((Kxx >= 1 - tol) & (Kxx <= 1))):
                fail(f"rbf_kernel K(x, x) outside [1 - {tol}, 1] at d={d} "
                     f"h={h}: {float(Kxx.min())}")
    log(f"rbf_kernel vs plain: {len(cases) * 2} shapes agree within rtol="
        f"{testing.RTOL} atol={testing.ATOL} (max |dK| {worst:.3g}); K(x, x) "
        f"in [1 - {tol:g}, 1]")


def phase_kernels_weighted() -> None:
    """The weighted exemplar_gains, greedy_select (unconstrained and under
    knapsack ∩ partition) and threshold_select against their plain versions
    at phase 2's shapes, with weights U(0.5, 1.5) normalised to mean 1; and
    w ≡ 1.0 bit-identical to the unweighted launch."""
    import numpy as np
    import torch
    from repro_torch import testing
    from repro_torch.core.algorithms import _fused_constraint_kwargs
    from repro_torch.kernels import ops, ref
    k = 10
    cases = [(M, n, m, d, kind) for d, n, m in ((6, 1000, 300),
                                                 (17, 777, 130))
             for M in (1, 7) for kind in ("none", "both")]
    cases.append((1, 100_003, 300, 6, "none"))
    cons = webscope_constraint(k)
    ties = same_bits = 0
    for M, n, m, d, kind in cases:
        X = _dataset(d, M * n + m, seed=500 + d)
        E = torch.as_tensor(X[M * n:], device="cuda")
        T = torch.as_tensor(X[:M * n].reshape(M, n, d), device="cuda")
        r = np.random.default_rng(d * M + n)
        mask = torch.as_tensor(r.random((M, n)) < 0.85, device="cuda")
        a = torch.as_tensor(make_attrs(M * n, seed=d + M).reshape(M, n, 2),
                            device="cuda")
        kw = _fused_constraint_kwargs(cons, a) if kind == "both" else {}
        w = eval_weights(m, seed=m + M)
        ones = torch.ones((m,), dtype=torch.float32, device="cuda")
        e0 = torch.sum(E * E, dim=-1)
        what = f"weighted M={M} n={n} m={m} d={d} {kind}"
        trace = ref.greedy_select_trace(T, E, e0, mask, k, eval_weights=w,
                                        **kw)
        for cm in (e0, trace[1]):
            testing.assert_close(ops.exemplar_gains(T, E, cm, eval_weights=w),
                                 ref.exemplar_gains(T, E, cm, eval_weights=w),
                                 f"exemplar_gains {what}")
        sel, cm_out = ops.greedy_select(T, E, e0, mask, k, eval_weights=w,
                                        **kw)
        torch.cuda.synchronize()
        n_tie, same, err = check_greedy(sel, cm_out, T, E, e0, trace,
                                        f"greedy_select {what}")
        ties += n_tie
        # w ≡ 1.0 against the unweighted launch: the same bits
        for cm in (e0, trace[1]):
            if not torch.equal(ops.exemplar_gains(T, E, cm,
                                                  eval_weights=ones),
                               ops.exemplar_gains(T, E, cm)):
                fail(f"exemplar_gains {what}: w = 1 differs from unweighted")
        s1, c1 = ops.greedy_select(T, E, e0, mask, k, eval_weights=ones, **kw)
        s0, c0 = ops.greedy_select(T, E, e0, mask, k, **kw)
        if not (torch.equal(s1, s0) and torch.equal(c1, c0)):
            fail(f"greedy_select {what}: w = 1 differs from unweighted")
        same_bits += 1
        log(f"  {what} k={k}: gains, sel, cur_min agree ({same}/{M} machines "
            f"select as plain, max|dcm| {err:.3g}, near-tie steps {n_tie}); "
            f"w = 1 gives the unweighted bits")
    log(f"weighted exemplar_gains / greedy_select vs plain: {len(cases)} "
        f"shapes agree; near-tie steps {ties}; w = 1 bit-identical on "
        f"{same_bits}")

    k = 12
    tcases = [(3, 1000, 300, 6, 256, True), (7, 777, 130, 17, 16, True),
              (7, 201, 130, 17, 256, False), (1, 30_000, 300, 6, 256, False)]
    full_all = m_all = 0
    for M, n, m, d, bn, constrained in tcases:
        X = _dataset(d, M * n + m, seed=600 + d)
        E = torch.as_tensor(X[M * n:], device="cuda")
        T = torch.as_tensor(X[:M * n].reshape(M, n, d), device="cuda")
        r = np.random.default_rng(n + bn + 1)
        mask = torch.as_tensor(r.random((M, n)) < 0.85, device="cuda")
        a = torch.as_tensor(make_attrs(M * n, seed=n + 1).reshape(M, n, 2),
                            device="cuda")
        kw = _fused_constraint_kwargs(cons, a) if constrained else {}
        limit = ref.knapsack_limit(kw["budget"]) if constrained else None
        w = eval_weights(m, seed=m)
        e0 = torch.sum(E * E, dim=-1)
        cm_in = (e0 * torch.as_tensor(0.6 + 0.4 * r.random((M, m)),
                                      dtype=torch.float32, device="cuda"))
        g = ref.exemplar_gains(T, E, cm_in, eval_weights=w)
        tau = g.masked_fill(~mask, 0.0).amax(dim=1) * 0.4
        st = {"count": torch.full((M,), 3, dtype=torch.int32, device="cuda")}
        acc, cm = ops.threshold_select(T, E, cm_in, mask, tau, k, bn=bn,
                                       eval_weights=w, **st, **kw)
        torch.cuda.synchronize()
        trace = ref.threshold_select_trace(T, E, cm_in, mask, tau, k,
                                           bn=min(bn, max(8, n)),
                                           eval_weights=w, **st, **kw)
        what = (f"threshold_select weighted "
                f"{'knapsack ∩ partition' if constrained else 'unconstrained'}"
                f" M={M} n={n} m={m} d={d} bn={bn}")
        full, near, _ = check_threshold(acc, cm, trace, T, E, cm_in, tau,
                                        mask, k, limit, what)
        ones = torch.ones((m,), dtype=torch.float32, device="cuda")
        a1 = ops.threshold_select(T, E, cm_in, mask, tau, k, bn=bn,
                                  eval_weights=ones, **st, **kw)
        a0 = ops.threshold_select(T, E, cm_in, mask, tau, k, bn=bn, **st,
                                  **kw)
        if not (torch.equal(a1[0], a0[0]) and torch.equal(a1[1], a0[1])):
            fail(f"{what}: w = 1 differs from unweighted")
        full_all, m_all = full_all + full, m_all + M
        log(f"  {what}: {full}/{M} machines accept as plain, "
            f"{int(acc.sum())} rows accepted, near rows {near}; w = 1 gives "
            f"the unweighted bits")
    if full_all < FULL_SHARE * m_all:
        fail(f"weighted threshold_select: only {full_all}/{m_all} machines "
             f"compared in full")
    log(f"weighted threshold_select vs plain: {len(tcases)} shapes agree "
        f"under the near-threshold rule, {full_all}/{m_all} machines in full")


def make_attrs(n: int, seed: int):
    """Per-row attributes as the repo's benchmarks draw them
    (``benchmarks/adaptive_depth.py``): a weight ~ U(0.2, 1.0) and a group
    id uniform over ``N_GROUPS``, as two fp32 columns."""
    import numpy as np
    r = np.random.default_rng(seed)
    w = r.uniform(0.2, 1.0, n).astype(np.float32)
    g = r.integers(0, N_GROUPS, n).astype(np.float32)
    return np.stack([w, g], axis=1)


def webscope_constraint(k: int):
    """``benchmarks/constrained_tree.py``'s intersection: a knapsack of
    0.45k over column 0 and k/4 items per group of column 1."""
    from repro_torch.core import Intersection, Knapsack, PartitionMatroid
    return Intersection((Knapsack(budget=0.45 * k, col=0),
                         PartitionMatroid(caps=(k // 4,) * N_GROUPS, col=1)))


def fold_cur_min(X, E, cm_in, acc, kmax: int):
    """The plain fold of each machine's own accept set (at most ``kmax``
    rows) into ``cm_in``: the contraction-form distances' row-min."""
    import torch
    from repro_torch.kernels import ref
    idx = torch.argsort(acc.to(torch.int8), dim=1, descending=True,
                        stable=True)[:, :kmax]
    ok = torch.take_along_dim(acc, idx, dim=1)
    d2 = ref.pairwise_sqdist(torch.take_along_dim(X, idx[..., None], dim=1),
                             E)
    d2 = torch.where(ok[..., None], d2, torch.full_like(d2, float("inf")))
    return torch.minimum(cm_in, torch.amin(d2, dim=1))


def check_threshold(acc, cm, trace, X, E, cm_in, tau, avail, kmax, limit,
                    what: str) -> tuple[int, int, float]:
    """threshold_select's output against the plain trace under the
    near-threshold rule; every machine's cur_min against the plain fold of
    its own accept set.  Returns (machines matching in full, near rows,
    max |Δ cur_min|)."""
    import torch
    from repro_torch import testing
    acc_p, cm_p, gains, load = trace
    ok, full, near = testing.accepts_agree(acc, acc_p, gains, tau, load=load,
                                           limit=limit, avail=avail)
    if not ok:
        fail(f"{what}: accept set differs from the plain version before any "
             f"near-threshold or near-budget row")
    want = fold_cur_min(X, E, cm_in, acc, kmax)
    testing.assert_close(cm, want, f"{what}: cur_min, every machine")
    same = torch.all(acc == acc_p, dim=-1)
    testing.assert_close(cm[same], cm_p[same],
                         f"{what}: cur_min, machines accepting as plain")
    return full, near, max(testing.max_abs_err(cm, want),
                           testing.max_abs_err(cm[same], cm_p[same]))


def phase_kernels_constrained() -> None:
    """Constrained greedy_select and threshold_select against their plain
    versions at ragged shapes."""
    import numpy as np
    import torch
    from repro_torch import testing
    from repro_torch.core import (Intersection, Knapsack, PartitionMatroid,
                                  check_feasible)
    from repro_torch.core.algorithms import _fused_constraint_kwargs
    from repro_torch.kernels import ops, ref
    k = 10
    cases = [(M, n, m, d, G, "both") for d, n, m in ((6, 1000, 300),
                                                      (17, 777, 130))
             for M in (1, 7) for G in (1, 8)]
    cases += [(7, 1000, 300, 6, 8, "knapsack"),
              (7, 777, 130, 17, 8, "partition")]
    ties = 0
    for M, n, m, d, G, kind in cases:
        X = _dataset(d, M * n + m, seed=200 + d)
        E = torch.as_tensor(X[M * n:], device="cuda")
        T = torch.as_tensor(X[:M * n].reshape(M, n, d), device="cuda")
        mask = torch.as_tensor(
            np.random.default_rng(d + M).random((M, n)) < 0.85,
            device="cuda")
        a = make_attrs(M * n, seed=d * M + G).reshape(M, n, 2)
        a[..., 1] %= G
        kn = Knapsack(budget=0.35 * k, col=0) if kind != "partition" else None
        caps = (k // 2,) if G == 1 else (max(1, k // N_GROUPS),) * G
        pm = PartitionMatroid(caps=caps, col=1) if kind != "knapsack" else None
        cons = Intersection(tuple(p for p in (kn, pm) if p is not None))
        kw = _fused_constraint_kwargs(cons,
                                      torch.as_tensor(a, device="cuda"))
        e0 = torch.sum(E * E, dim=-1)
        trace = ref.greedy_select_trace(T, E, e0, mask, k, **kw)
        sel, cm_out = ops.greedy_select(T, E, e0, mask, k, **kw)
        torch.cuda.synchronize()
        what = f"greedy_select {kind} M={M} n={n} m={m} d={d} G={G}"
        n_tie, same, err = check_greedy(sel, cm_out, T, E, e0, trace, what)
        ties += n_tie
        sel_np = sel.cpu().numpy()
        for i in range(M):
            ok, detail = check_feasible(cons, a[i][np.maximum(sel_np[i], 0)],
                                        sel_np[i] >= 0)
            if not ok:
                fail(f"{what}: machine {i} infeasible: {detail}")
        log(f"  constrained kernels {kind} M={M} n={n} m={m} d={d} G={G} "
            f"k={k}: sel, cur_min agree ({same}/{M} machines select as "
            f"plain, {int((sel >= 0).sum())} of {M * k} slots filled: the "
            f"constraint binds; max|dcm| {err:.3g}, near-tie steps {n_tie})")
    log(f"constrained greedy_select vs plain: {len(cases)} shapes agree, "
        f"every selection feasible; near-tie steps {ties}")

    # threshold_select: (M, n, m, d, bn, state, constrained); n = 201 < 256
    # gives bn = 201, n = 30,000 at bn = 256 runs 118 blocks on one
    # machine.  Unconstrained, the kernel runs with no weights and no group
    # ids (the unconstrained THRESHOLD-BATCH TREE's launch): only k stops it.
    k = 12
    cons = webscope_constraint(k)
    tcases = [(3, 1000, 300, 6, 256, "fresh", True),
              (3, 1000, 300, 6, 16, "mid", True),
              (7, 201, 130, 17, 256, "mid", True),
              (7, 777, 130, 17, 16, "stop", True),
              (1, 30_000, 300, 6, 256, "mid", True),
              (2, 5_003, 64, 6, 16, "mid", True),
              (3, 1000, 300, 6, 256, "fresh", False),
              (7, 201, 130, 17, 256, "mid", False),
              (7, 777, 130, 17, 16, "stop", False),
              (1, 30_000, 300, 6, 256, "mid", False)]
    full_all = m_all = near_all = 0
    for M, n, m, d, bn, state, constrained in tcases:
        X = _dataset(d, M * n + m, seed=300 + d)
        E = torch.as_tensor(X[M * n:], device="cuda")
        T = torch.as_tensor(X[:M * n].reshape(M, n, d), device="cuda")
        r = np.random.default_rng(n + bn)
        mask = torch.as_tensor(r.random((M, n)) < 0.85, device="cuda")
        a = torch.as_tensor(make_attrs(M * n, seed=n).reshape(M, n, 2),
                            device="cuda")
        kw = _fused_constraint_kwargs(cons, a) if constrained else {}
        limit = ref.knapsack_limit(kw["budget"]) if constrained else None
        e0 = torch.sum(E * E, dim=-1)
        cm_in = (e0 * torch.as_tensor(0.6 + 0.4 * r.random((M, m)),
                                      dtype=torch.float32, device="cuda"))
        g = ref.exemplar_gains(T, E, cm_in).masked_fill(~mask, 0.0)
        tau = g.amax(dim=1) * (0.2 if state == "stop" else 0.4)
        st = {}
        if state in ("mid", "stop"):
            st["count"] = torch.full((M,), k - 1 if state == "stop" else 3,
                                     dtype=torch.int32, device="cuda")
        if state in ("mid", "stop") and constrained:
            st["used"] = torch.full((M,), 0.2 * limit, device="cuda")
            st["counts"] = torch.as_tensor(
                r.integers(0, 2, (M, N_GROUPS)), dtype=torch.int32,
                device="cuda")
        acc, cm = ops.threshold_select(T, E, cm_in, mask, tau, k, bn=bn,
                                       **st, **kw)
        torch.cuda.synchronize()
        trace = ref.threshold_select_trace(T, E, cm_in, mask, tau, k,
                                           bn=min(bn, max(8, n)), **st, **kw)
        what = (f"threshold_select {state} "
                f"{'knapsack ∩ partition' if constrained else 'unconstrained'}"
                f" M={M} n={n} m={m} d={d} bn={bn}")
        full, near, _ = check_threshold(acc, cm, trace, T, E, cm_in, tau,
                                        mask, k, limit, what)
        n_acc = acc.sum(dim=1)
        count0 = st.get("count", torch.zeros((M,), device="cuda")).long()
        if bool(torch.any(count0 + n_acc > k)):
            fail(f"{what}: accepted past k")
        if state == "stop" and bool(torch.any(n_acc > 1)):
            fail(f"{what}: accepted past the stop flag")
        full_all, m_all, near_all = full_all + full, m_all + M, \
            near_all + near
        log(f"  {what} ({-(-n // min(bn, max(8, n)))} blocks): {full}/{M} "
            f"machines accept as plain, {int(n_acc.sum())} rows accepted, "
            f"near rows {near}")
    if full_all < FULL_SHARE * m_all:
        fail(f"threshold_select: only {full_all}/{m_all} machines compared "
             f"in full")
    log(f"threshold_select vs plain: {len(tcases)} shapes agree under the "
        f"near-threshold rule; {full_all}/{m_all} machines in full, near "
        f"rows {near_all}")
    threshold_group_limit()


def threshold_group_limit() -> None:
    """threshold_select at the most partition groups one launch takes (the
    group counts fill the block's shared memory): it runs and agrees with
    the plain version, which runs on the CPU here because it loops over
    the groups; one group more raises."""
    import numpy as np
    import torch
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import threshold_select as _ts
    G = _ts.max_groups(torch.device("cuda"))
    M, n, m, d, k = 2, 64, 64, 6, 12
    X = _dataset(d, M * n + m, seed=400)
    E = torch.as_tensor(X[M * n:], device="cuda")
    T = torch.as_tensor(X[:M * n].reshape(M, n, d), device="cuda")
    r = np.random.default_rng(G)
    mask = torch.ones((M, n), dtype=torch.bool, device="cuda")
    gid = torch.as_tensor(r.integers(0, G, (M, n)), dtype=torch.int32,
                          device="cuda")
    e0 = torch.sum(E * E, dim=-1)
    tau = ref.exemplar_gains(T, E, e0).amax(dim=1) * 0.3
    caps = (1,) * G
    acc, cm = ops.threshold_select(T, E, e0, mask, tau, k, group_ids=gid,
                                   caps=caps)
    torch.cuda.synchronize()
    cpu = [t.cpu() for t in (T, E, e0, mask, tau, gid)]
    trace = ref.threshold_select_trace(*cpu[:5], k, group_ids=cpu[5],
                                       caps=caps)
    full, near, _ = check_threshold(
        acc.cpu(), cm.cpu(), trace, cpu[0], cpu[1], cpu[2].expand(M, m),
        cpu[4], cpu[3], k, None, f"threshold_select at G = {G}")
    try:
        ops.threshold_select(T, E, e0, mask, tau, k, group_ids=gid,
                             caps=caps + (1,))
    except ValueError:
        pass
    else:
        fail(f"threshold_select took G = {G + 1}, past its shared memory")
    log(f"threshold_select at its group limit G = {G}: {full}/{M} machines "
        f"accept as plain ({int(acc.sum())} rows, near rows {near}); "
        f"G = {G + 1} raises")


def phase_constrained(main: dict) -> dict:
    """Constrained GREEDY and THRESHOLD-BATCH TREE at the Webscope
    deployment, against the centralized greedy under the same
    constraint."""
    import torch
    from repro_torch import testing
    from repro_torch.core import TreeConfig
    from repro_torch.core.algorithms import _fused_constraint_kwargs
    from repro_torch.kernels import ref
    X, obj, cfg = main["X"], main["obj"], main["cfg"]
    n, d = X.shape
    k, mu = cfg.k, cfg.capacity
    t0 = time.perf_counter()
    attrs = torch.as_tensor(make_attrs(n, SEED), device="cuda")
    cons = webscope_constraint(k)
    log(f"constrained data: attrs (n, 2) from seed {SEED}, wide rows "
        f"{n * (d + 2) * 4 / 1e9:.2f} GB on the card, constraint "
        f"{cons} ({time.perf_counter() - t0:.1f} s)")

    cent, cent_value = run_central("constrained centralized greedy", obj, X,
                                   k, constraint=cons, attrs=attrs)

    tree_g, cnt_g = run_tree("GREEDY TREE, knapsack ∩ partition", obj, X,
                             cfg, ("greedy_select_constrained",),
                             constraint=cons, attrs=attrs)
    ratio = tree_g.value / cent_value
    log(f"GREEDY TREE / centralized, both constrained: {ratio!r}")
    if ratio < 0.9:
        fail(f"constrained TREE/centralized ratio {ratio} below 0.9")

    cfg_t = TreeConfig(k=k, capacity=mu, seed=SEED,
                       algorithm="threshold_batch", eps=EPS)
    depth_cap = 1 + math.ceil(math.log(2 * k / EPS) / EPS)
    gaps = {}
    runs = {}
    for label, constraint, central in (
            ("unconstrained", None, main["cent_value"]),
            ("knapsack ∩ partition", cons, cent_value)):
        name = f"THRESHOLD-BATCH TREE eps={EPS}, {label}"
        res, counts = run_tree(name, obj, X, cfg_t,
                               ("threshold_select", "threshold_select_prepass",
                                "threshold_select_tail", "exemplar_gains"),
                               constraint=constraint,
                               attrs=None if constraint is None else attrs)
        if max(res.depth_per_round) > depth_cap:
            fail(f"{name}: depth/round {res.depth_per_round} above "
                 f"{depth_cap}")
        gaps[label] = 1.0 - res.value / central
        log(f"{name}: gap 1 - tree/central = {gaps[label]!r} (ε = {EPS}); "
            f"depth {res.solve_depth} against GREEDY's k·rounds = "
            f"{k * res.rounds}")
        if gaps[label] > EPS:
            fail(f"{name}: gap {gaps[label]} above ε = {EPS}")
        runs[label] = counts

    # the constrained centralized run against the plain constrained greedy
    # over all n rows (chunked over rows), as phase_main does unconstrained
    t2 = time.perf_counter()
    E = obj.eval_set
    sel_p, _, gap, best = ref.greedy_select_trace(
        X, E, torch.sum(E * E, dim=-1),
        torch.ones((n,), dtype=torch.bool, device="cuda"), k,
        **_fused_constraint_kwargs(cons, attrs))
    torch.cuda.synchronize()
    rows_p = X[torch.clamp_min(sel_p, 0)]
    same = torch.where(sel_p >= 0, torch.all(cent.sel_rows == rows_p, dim=-1)
                       & cent.sel_mask, ~cent.sel_mask)
    ok, n_tie = testing.selections_agree(torch.where(same, sel_p, -2), sel_p,
                                         gap, best)
    if not ok:
        fail("constrained centralized greedy selects apart from the plain "
             "constrained greedy before any near tie")
    log(f"constrained centralized vs plain over {n} rows: "
        f"{int(same.sum())}/{k} steps select the same row, near-tie steps "
        f"{n_tie} (plain {time.perf_counter() - t2:.1f} s)")
    return {"attrs": attrs, "cons": cons, "launches": {
        "greedy_select_constrained": cnt_g.get("greedy_select_constrained",
                                               0),
        "threshold_select": runs["knapsack ∩ partition"].get(
            "threshold_select", 0),
        "threshold_select_prepass": runs["knapsack ∩ partition"].get(
            "threshold_select_prepass", 0),
        "threshold_select_tail": runs["knapsack ∩ partition"].get(
            "threshold_select_tail", 0),
        "threshold_select_unconstrained":
            runs["unconstrained"].get("threshold_select", 0)}}


def times_constrained(main: dict, constrained: dict, blocks, bmask, part
                      ) -> list[dict]:
    """The constrained greedy_select and one threshold_select level at
    round 0 of the constrained path: time, plain time, bound."""
    import torch
    from repro_torch import testing
    from repro_torch.core import partition as part_lib
    from repro_torch.core.algorithms import _fused_constraint_kwargs
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import threshold_select as _ts
    obj, cfg = main["obj"], main["cfg"]
    cons, attrs = constrained["cons"], constrained["attrs"]
    E = obj.eval_set
    M, mu, d = blocks.shape
    m, k = E.shape[0], cfg.k
    ablocks, _ = part_lib.gather_partition(attrs, part)
    kw = _fused_constraint_kwargs(cons, ablocks)
    seed = torch.sum(E * E, dim=-1)
    rows = []

    sel, cm_out = ops.greedy_select(blocks, E, seed, bmask, k, **kw)
    t0 = time.perf_counter()
    trace = ref.greedy_select_trace(blocks, E, seed, bmask, k, **kw)
    torch.cuda.synchronize()
    log(f"plain constrained greedy at round 0 (M={M}): "
        f"{time.perf_counter() - t0:.1f} s")
    n_tie, same, err = check_greedy(sel, cm_out, blocks, E, seed, trace,
                                    "constrained greedy_select at round 0")
    log(f"constrained greedy_select round 0 vs plain: {same}/{M} machines "
        f"select as plain, near-tie steps {n_tie}, max|dcm| {err:.3g}, "
        f"{int((sel >= 0).sum())} of {M * k} slots filled")
    ms = cuda_ms(lambda: ops.greedy_select(blocks, E, seed, bmask, k, **kw),
                 runs=5)
    plain = cuda_ms(lambda: ref.greedy_select(blocks, E, seed, bmask, k,
                                              **kw), runs=1, warmup=0)
    check_step_launches("greedy_select_constrained", lambda: ops.greedy_select(
        blocks, E, seed, bmask, k, **kw), k)
    calls = int(torch.sum(obj.fused_select(blocks, bmask, k, **kw)[3]))
    b, by, b32 = tile_bound(calls * m, d,
                            4 * M * mu * d + 4 * m * d + 4 * m + M * mu
                            + 8 * M * mu + 4 * M * k + 4 * M * m, 3)
    launches = constrained["launches"]["greedy_select_constrained"]
    rows.append({"name": "greedy_select (knapsack ∩ partition)",
                 "route": "cuda",
                 "source": "src/repro_torch/kernels/csrc/greedy_select.cu",
                 "replaces": "src/repro/kernels/greedy_select.py:265",
                 "launches": launches, "calls": launches // k,
                 "max_abs_err": err, "ms": ms, "plain_ms": plain,
                 "bound_ms": b, "bound_by": by, "bound_fp32_ms": b32,
                 "library_ms": None})

    # one τ-level under the intersection at round 0, at the first level's
    # τ = d_max, and the next level; the same two levels unconstrained (the
    # unconstrained THRESHOLD-BATCH TREE's launch: no weights, no group
    # ids).  d_max is itself a gain, and the kernel's and the plain
    # version's gains of that row round apart, so each side's own d_max
    # admits its top row and may refuse the other's by an ulp: the level
    # is held at the smaller of the two per machine, which both reach.
    enc = ref.Encoding(M, mu, blocks.device, **kw)
    cand = enc.feasible(bmask, torch.zeros((M,), device="cuda"),
                        torch.zeros((M, enc.G), dtype=torch.int32,
                                    device="cuda"))
    gains = (ops.exemplar_gains(blocks, E, seed),
             ref.exemplar_gains(blocks, E, seed))

    def first_tau(ok):
        dmax = [torch.clamp_min(torch.amax(torch.where(ok, g, 0.0), dim=1),
                                1e-12) for g in gains]
        return torch.minimum(*dmax), testing.max_abs_err(*dmax)

    tau0, dmax_err = first_tau(cand)
    tau0_u, _ = first_tau(bmask)
    log(f"threshold level 0 at round 0: max |d_max kernel - d_max plain| "
        f"{dmax_err:.3g}")
    limit = ref.knapsack_limit(kw["budget"])
    errs = []
    Xb = blocks.contiguous()
    Ep, cmp_ = ops._pad_eval(E, seed.expand(M, m))
    flags = torch.empty((M, -(-mu // 256)), dtype=torch.uint8, device="cuda")
    for label, lkw, lim, t0_ in (("knapsack ∩ partition", kw, limit, tau0),
                                 ("unconstrained", {}, None, tau0_u)):
        for level, tau in ((0, t0_), (1, t0_ * (1.0 - EPS))):
            # the pre-pass's block flags at this level (the kernel alone)
            lenc = ref.Encoding(M, mu, blocks.device, **lkw)
            _ts.launch(Xb, Ep, cmp_.clone(), bmask.to(torch.uint8),
                       tau.contiguous(), torch.zeros((M,), device="cuda"),
                       torch.zeros((M,), dtype=torch.int32, device="cuda"),
                       torch.zeros((M, lenc.G), dtype=torch.int32,
                                   device="cuda"),
                       torch.ones((M,), dtype=torch.uint8, device="cuda"),
                       k, 256, m, flags_out=flags, **ops._card_encoding(lenc))
            log(f"threshold_select {label} at round 0, level {level}: "
                f"{float(flags.float().mean()):.4%} of {flags.numel()} blocks "
                f"flagged by the pre-pass (the tail visits these only; the "
                f"head walked each machine's first blocks)")
            acc, cm = ops.threshold_select(blocks, E, seed, bmask, tau, k,
                                           **lkw)
            t0 = time.perf_counter()
            trace = ref.threshold_select_trace(blocks, E, seed, bmask, tau,
                                               k, **lkw)
            torch.cuda.synchronize()
            what = f"threshold_select {label} at round 0, level {level}"
            full, near, err = check_threshold(acc, cm, trace, blocks, E,
                                              seed.expand(M, m), tau, bmask,
                                              k, lim, what)
            errs.append(err)
            log(f"{what} vs plain: {full}/{M} machines accept as plain, "
                f"near rows {near}, {int(acc.sum())} rows accepted (plain "
                f"{time.perf_counter() - t0:.1f} s)")
            if full < FULL_SHARE * M:
                fail(f"{what}: only {full}/{M} machines compared in full")
    # the kernel alone on operands prepared once (cur_min restored before
    # each launch); the whole ops call beside it
    cm_run = cmp_.clone()
    ops_kw = ops._card_encoding(enc)
    args = (bmask.to(torch.uint8), tau0.contiguous(),
            torch.zeros((M,), device="cuda"),
            torch.zeros((M,), dtype=torch.int32, device="cuda"),
            torch.zeros((M, enc.G), dtype=torch.int32, device="cuda"),
            torch.ones((M,), dtype=torch.uint8, device="cuda"))

    def kernel_alone(tau=tau0):
        cm_run.copy_(cmp_)
        _ts.launch(Xb, Ep, cm_run, args[0], tau.contiguous(), *args[2:], k,
                   256, m, **ops_kw)

    ms = cuda_ms(kernel_alone, runs=10)
    ms1 = cuda_ms(lambda: kernel_alone(tau0 * (1.0 - EPS)), runs=10)
    ms_ops = cuda_ms(lambda: ops.threshold_select(blocks, E, seed, bmask,
                                                  tau0, k, **kw), runs=10)
    plain = cuda_ms(lambda: ref.threshold_select(blocks, E, seed, bmask,
                                                 tau0, k, **kw),
                    runs=1, warmup=0)
    ms_u = cuda_ms(lambda: ops.threshold_select(blocks, E, seed, bmask,
                                                tau0_u, k), runs=10)
    log(f"threshold_select level 0 at round 0: kernel {ms:.4f} ms, whole "
        f"ops call {ms_ops:.4f} ms; unconstrained, whole ops call "
        f"{ms_u:.4f} ms; level 1, kernel {ms1:.4f} ms")
    n_rows = int(bmask.sum())
    b, by, b32 = tile_bound(n_rows * m, d,
                            M * mu * (4 * d + 4 + 4 + 1 + 1) + 4 * m * d
                            + 8 * M * m + 16 * M, 3)
    rows.append({"name": "threshold_select", "route": "cuda",
                 "source": "src/repro_torch/kernels/csrc/threshold_select.cu",
                 "replaces": "src/repro/kernels/threshold_select.py:238",
                 "launches": constrained["launches"]["threshold_select"],
                 "prepass_launches": constrained["launches"][
                     "threshold_select_prepass"],
                 "tail_launches": constrained["launches"][
                     "threshold_select_tail"],
                 "max_abs_err": max(errs), "ms": ms, "plain_ms": plain,
                 "bound_ms": b, "bound_by": by, "bound_fp32_ms": b32,
                 "library_ms": None})
    return rows


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
    return {"X": X, "obj": obj, "cfg": cfg, "launches": counts,
            "cent_value": cent_value, "tree": tree}


def check_coreset(name: str, constraint, sel_attrs, sel_mask) -> None:
    """Fail unless the selection is feasible under ``constraint`` (the
    independent NumPy checker); nothing to check without one."""
    from repro_torch.core import check_feasible
    if constraint is None:
        return
    ok, detail = check_feasible(constraint, _numpy(sel_attrs),
                                _numpy(sel_mask))
    if not ok:
        fail(f"{name}: selection infeasible: {detail}")


def _numpy(x):
    return x.cpu().numpy() if hasattr(x, "cpu") else x


def run_tree(name: str, obj, X, cfg, kernels, constraint=None, attrs=None):
    """One TREE run on the card with the launch counts zeroed just before
    and read just after; fails if a kernel of ``kernels`` launched no time
    or the coreset breaks ``constraint``.  Logs rounds, machines per round,
    depth, round walls and value; the value is re-scored by
    ``obj.evaluate``.  Returns the result and the non-zero counts."""
    import torch
    from repro_torch import testing
    from repro_torch.core import TorchPlan, tree_maximize
    from repro_torch.kernels import ops
    ops.reset_launch_counts()
    res = tree_maximize(obj, X, cfg, device="cuda", plan=TorchPlan(SEED),
                        constraint=constraint, attrs=attrs)
    torch.cuda.synchronize()
    counts = {key: v for key, v in ops.launch_counts.items() if v}
    for kern in kernels:
        if counts.get(kern, 0) == 0:
            fail(f"{name} launched {kern} no time")
    check_coreset(name, constraint, res.sel_attrs, res.sel_mask)
    d = X.shape[1]
    if not math.isfinite(res.value) or res.sel_rows.shape != (cfg.k, d):
        fail(f"{name}: non-finite value or wrong shape")
    rescore = obj.evaluate(torch.as_tensor(res.sel_rows, device="cuda"),
                           torch.as_tensor(res.sel_mask, device="cuda"))
    testing.assert_close(float(rescore), res.value, f"{name} re-scored")
    log(f"{name}: rounds {res.rounds}, machines/round "
        f"{res.machines_per_round}, oracle calls {res.oracle_calls}, depth/"
        f"round {res.depth_per_round} (solve depth {res.solve_depth}), value "
        f"{res.value!r}, selected {int(res.sel_mask.sum())}")
    log(f"{name} round walls (CUDA events, s): {res.round_walls}; total "
        f"{res.total_wall_s:.3f} s; launches {counts}")
    return res, counts


def run_central(name: str, obj, X, k: int, constraint=None, attrs=None):
    """Centralized greedy on the card, launches counted; the selection
    checked against ``constraint`` and its value re-scored."""
    from repro_torch import testing
    from repro_torch.core import centralized_greedy
    from repro_torch.kernels import ops
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    res = centralized_greedy(obj, X, k, device="cuda", constraint=constraint,
                             attrs=attrs)
    value = float(res.value)
    wall = time.perf_counter() - t0
    counts = {key: v for key, v in ops.launch_counts.items() if v}
    check_coreset(name, constraint, res.sel_attrs, res.sel_mask)
    testing.assert_close(value, float(obj.evaluate(res.sel_rows,
                                                   res.sel_mask)),
                         f"{name} re-scored")
    log(f"{name}: value {value!r}, wall {wall:.3f} s, launches {counts}")
    return res, value


def phase_active_set_parkinsons() -> None:
    """ActiveSetSelection on the paper's own dataset, as
    ``examples/active_set_selection.py`` sets it: the Parkinsons analog
    (n = 5,800, d = 22) × 0.5, h = 0.5, σ = 1, k = 25, μ = 100 — TREE
    against centralized greedy, and centralized greedy under a knapsack of
    10.0 on costs U(0.5, 2.0)."""
    import numpy as np
    import torch
    from repro_torch.core import ActiveSetSelection, Knapsack, TreeConfig
    from repro_torch.data import datasets
    data = torch.as_tensor((datasets.parkinsons() * 0.5).astype(np.float32),
                           device="cuda")
    k, mu = 25, 100
    obj = ActiveSetSelection(k_max=k, h=0.5, sigma=1.0, device="cuda")
    tree, _ = run_tree("ActiveSetSelection TREE, Parkinsons", obj, data,
                       TreeConfig(k=k, capacity=mu, seed=SEED),
                       ("rbf_kernel",))
    _, cent = run_central("ActiveSetSelection centralized, Parkinsons", obj,
                          data, k)
    ratio = tree.value / cent
    log(f"ActiveSetSelection TREE / centralized, Parkinsons: {ratio!r}")
    if ratio < 0.9:
        fail(f"ActiveSetSelection Parkinsons ratio {ratio} below 0.9")
    costs = np.random.default_rng(SEED).uniform(
        0.5, 2.0, (data.shape[0], 1)).astype(np.float32)
    res, _ = run_central("ActiveSetSelection centralized, Parkinsons, "
                         "Knapsack(10.0)", obj, data, k,
                         constraint=Knapsack(budget=10.0), attrs=costs)
    log(f"ActiveSetSelection knapsack: {int(res.sel_mask.sum())} items, cost "
        f"{float(res.sel_attrs[res.sel_mask].sum())!r} ≤ 10.0, feasible")


def round0_blocks(main: dict):
    """Round 0's blocks of the Webscope TREE (the plan of every run here)
    and its partition."""
    from repro_torch.core import TorchPlan
    from repro_torch.core import partition as part_lib
    X, cfg = main["X"], main["cfg"]
    N = X.shape[0]
    part = part_lib.balanced_partition(
        TorchPlan(SEED), 0, N, part_lib.n_parts(N, cfg.capacity),
        cap=cfg.capacity, device="cuda")
    blocks, bmask = part_lib.gather_partition(X, part)
    return blocks, bmask, part


def phase_active_set_webscope(main: dict) -> dict:
    """ActiveSetSelection at the Webscope deployment (n = 45M, d = 6,
    μ = 22,500, k = k_max = 50, h = 0.5, σ = 1): TREE against the
    centralized greedy over all 45M rows; round 0 itself on the card, its
    first 16 machines held against the port's plain path on the CPU under
    the exact-tie rule."""
    import torch
    from repro_torch import testing
    from repro_torch.core import ActiveSetSelection, algorithms
    X, cfg = main["X"], main["cfg"]
    k = cfg.k
    obj = ActiveSetSelection(k_max=k, h=0.5, sigma=1.0, device="cuda")
    tree, counts = run_tree("ActiveSetSelection TREE, Webscope", obj, X, cfg,
                            ("rbf_kernel",))
    _, cent = run_central("ActiveSetSelection centralized, Webscope", obj, X,
                          k)
    ratio = tree.value / cent
    log(f"ActiveSetSelection TREE / centralized, Webscope: {ratio!r}")
    if ratio < 0.9:
        fail(f"ActiveSetSelection Webscope ratio {ratio} below 0.9")
    blocks, bmask, _ = round0_blocks(main)
    t0 = time.perf_counter()
    card = algorithms.greedy(obj, blocks, bmask, k)
    torch.cuda.synchronize()
    t_card = time.perf_counter() - t0
    n_check = 16
    obj_cpu = ActiveSetSelection(k_max=k, h=0.5, sigma=1.0, device="cpu")
    T16, m16 = blocks[:n_check].cpu(), bmask[:n_check].cpu()
    t0 = time.perf_counter()
    plain = algorithms.greedy(obj_cpu, T16, m16, k)
    gains = testing.gain_trace(obj_cpu, T16, m16, plain.sel_idx)
    t_cpu = time.perf_counter() - t0
    sel = card.sel_idx[:n_check].cpu()
    ok, ties, excused = testing.picks_agree(sel, plain.sel_idx, gains)
    if not ok:
        fail("ActiveSetSelection round 0: the card's picks part from the "
             "plain path's beyond the exact-tie rule")
    same = torch.all(sel == plain.sel_idx, dim=-1)
    testing.assert_close(card.value[:n_check].cpu()[same],
                         plain.value[same], "round-0 values, same picks")
    for i in torch.nonzero(~same).flatten().tolist():
        rows = T16[i, torch.clamp_min(sel[i], 0)]
        testing.assert_close(float(card.value[i]), float(obj_cpu.evaluate(
            rows, sel[i] >= 0)), f"round-0 machine {i} re-scored")
    log(f"ActiveSetSelection round 0 on the card (M = {blocks.shape[0]}, "
        f"{t_card:.2f} s) vs the plain path on the CPU, first {n_check} "
        f"machines ({t_cpu:.1f} s): picks agree under the exact-tie rule, "
        f"{int(same.sum())}/{n_check} machines pick alike, exact-tie steps "
        f"{ties}, excused steps {excused}")
    return {"launches": counts.get("rbf_kernel", 0), "sel": card.sel_idx,
            "tree": tree}


def phase_facility(main: dict) -> dict:
    """FacilityLocation at the Webscope deployment over the 512 eval rows
    of the earlier phases, h = 1.0: TREE against centralized greedy."""
    from repro_torch.core import FacilityLocation
    X, cfg = main["X"], main["cfg"]
    obj = FacilityLocation(main["obj"].eval_set, h=1.0)
    tree, counts = run_tree("FacilityLocation TREE, Webscope", obj, X, cfg,
                            ("rbf_kernel",))
    _, cent = run_central("FacilityLocation centralized, Webscope", obj, X,
                          cfg.k)
    ratio = tree.value / cent
    log(f"FacilityLocation TREE / centralized, Webscope: {ratio!r}")
    if ratio < 0.9:
        fail(f"FacilityLocation ratio {ratio} below 0.9")
    return {"launches": counts.get("rbf_kernel", 0), "obj": obj}


def phase_weighted(main: dict) -> dict:
    """WeightedExemplarClustering at the Webscope deployment, weights
    U(0.5, 1.5) normalised to mean 1 over the 512 eval rows: GREEDY and
    THRESHOLD-BATCH TREE against the weighted centralized greedy; and with
    w ≡ 1.0 the GREEDY TREE selects the unweighted TREE's rows with its
    value, to the bit."""
    import numpy as np
    import torch
    from repro_torch.core import TreeConfig, WeightedExemplarClustering
    X, cfg = main["X"], main["cfg"]
    E = main["obj"].eval_set
    w = eval_weights(E.shape[0], SEED)
    obj = WeightedExemplarClustering(E, eval_weights=w)
    _, cent = run_central("weighted centralized greedy, Webscope", obj, X,
                          cfg.k)
    tree, counts = run_tree("weighted GREEDY TREE, Webscope", obj, X, cfg,
                            ("greedy_select_weighted",))
    ratio = tree.value / cent
    log(f"weighted GREEDY TREE / centralized: {ratio!r}")
    if ratio < 0.9:
        fail(f"weighted GREEDY TREE ratio {ratio} below 0.9")
    cfg_t = TreeConfig(k=cfg.k, capacity=cfg.capacity, seed=SEED,
                       algorithm="threshold_batch", eps=EPS)
    res, _ = run_tree(f"weighted THRESHOLD-BATCH TREE eps={EPS}, Webscope",
                      obj, X, cfg_t, ("exemplar_gains_weighted",
                                      "threshold_select_weighted",
                                      "threshold_select_prepass",
                                      "threshold_select_tail"))
    gap = 1.0 - res.value / cent
    depth_cap = 1 + math.ceil(math.log(2 * cfg.k / EPS) / EPS)
    log(f"weighted THRESHOLD-BATCH TREE: gap 1 - tree/central = {gap!r} "
        f"(ε = {EPS}), depth/round {res.depth_per_round}")
    if gap > EPS or max(res.depth_per_round) > depth_cap:
        fail(f"weighted THRESHOLD-BATCH: gap {gap} or depth "
             f"{res.depth_per_round} out of bounds")
    unit = WeightedExemplarClustering(E, eval_weights=torch.ones_like(w))
    one, _ = run_tree("weighted GREEDY TREE, w = 1.0", unit, X, cfg,
                      ("greedy_select_weighted",))
    base = main["tree"]
    if not (np.array_equal(one.sel_rows, base.sel_rows)
            and np.float32(one.value).tobytes()
            == np.float32(base.value).tobytes()):
        fail("w = 1.0 TREE does not reproduce the unweighted TREE's rows "
             "and value to the bit")
    log(f"w = 1.0 GREEDY TREE: the unweighted TREE's {cfg.k} rows and value "
        f"{one.value!r}, to the bit")
    return {"w": w, "launches": counts.get("greedy_select_weighted", 0)}


def times_new(main: dict, active: dict, facility: dict, weighted: dict,
              blocks, bmask) -> list[dict]:
    """rbf_kernel at its two path shapes and the weighted greedy_select at
    round 0: each held against its plain version there, timed beside it
    and beside its bound; and rbf_kernel at the centralized update shape
    (one row against all 45M) held against its plain version."""
    import torch
    from repro_torch import testing
    from repro_torch.core.objectives import SIM_BYTES
    from repro_torch.kernels import ops, ref
    X, obj, cfg = main["X"], main["obj"], main["cfg"]
    E = obj.eval_set
    M, mu, d = blocks.shape
    m, k = E.shape[0], cfg.k
    tol = testing.ATOL + testing.RTOL
    rows = []

    # the ActiveSetSelection update at round 0: each machine's second pick
    # against its whole block
    idx = torch.clamp_min(active["sel"][:, 1], 0)
    x = torch.take_along_dim(blocks, idx[:, None, None], dim=1)
    K = ops.rbf_kernel(x, blocks, 0.5)
    K_p = ref.rbf_kernel(x, blocks, 0.5)
    testing.assert_close(K, K_p, "rbf_kernel at the round-0 update")
    err = testing.max_abs_err(K, K_p)
    self_k = torch.take_along_dim(K[:, 0], idx[:, None], dim=1)
    if not bool(torch.all((self_k >= 1 - tol) & (self_k <= 1))):
        fail("rbf_kernel K(x, x) outside [1 - tol, 1] at the round-0 update")
    del K, K_p
    ms = cuda_ms(lambda: ops.rbf_kernel(x, blocks, 0.5), runs=20)
    plain = cuda_ms(lambda: ref.rbf_kernel(x, blocks, 0.5), runs=5)
    # each operand read once, the output written once; dot (2d), norms of
    # the pair (3), scale, clamp and exp (3) per output element, fp32
    b, by = bound_ms(M * mu * (2 * d + 6), 4 * (M * d + M * mu * d + M * mu))
    rows.append({"name": "rbf_kernel (ActiveSetSelection update)",
                 "route": "cuda",
                 "source": "src/repro_torch/kernels/csrc/rbf_kernel.cu",
                 "replaces": "src/repro/kernels/rbf_kernel.py:44",
                 "launches": active["launches"], "max_abs_err": err,
                 "ms": ms, "plain_ms": plain, "bound_ms": b, "bound_by": by,
                 "library_ms": None})

    # one FacilityLocation gain chunk at round 0: the shared eval set
    # against a candidate chunk of every machine
    c = max(1, SIM_BYTES // (4 * m * M))
    Y = blocks[:, :c]
    K = ops.rbf_kernel(E, Y, 1.0)
    K_p = ref.rbf_kernel(E, Y, 1.0)
    testing.assert_close(K, K_p, "rbf_kernel at a FacilityLocation chunk")
    err = testing.max_abs_err(K, K_p)
    del K, K_p
    ms = cuda_ms(lambda: ops.rbf_kernel(E, Y, 1.0), runs=10)
    plain = cuda_ms(lambda: ref.rbf_kernel(E, Y, 1.0), runs=3)
    b, by = bound_ms(M * m * c * (2 * d + 6),
                     4 * (m * d + M * c * d + M * m * c))
    log(f"rbf_kernel FacilityLocation chunk: (M, n_eval, chunk) = "
        f"({M}, {m}, {c}), {4 * M * m * c / 1e9:.2f} GB out")
    rows.append({"name": "rbf_kernel (FacilityLocation gains)",
                 "route": "cuda",
                 "source": "src/repro_torch/kernels/csrc/rbf_kernel.cu",
                 "replaces": "src/repro/kernels/rbf_kernel.py:44",
                 "launches": facility["launches"], "max_abs_err": err,
                 "ms": ms, "plain_ms": plain, "bound_ms": b, "bound_by": by,
                 "library_ms": None})

    # the centralized update: one row against all n rows
    x1 = X[1:2]
    K = ops.rbf_kernel(x1, X, 0.5)
    testing.assert_close(K, ref.rbf_kernel(x1, X, 0.5),
                         "rbf_kernel at the centralized update")
    if not 1 - tol <= float(K[0, 1]) <= 1:
        fail("rbf_kernel K(x, x) outside [1 - tol, 1] at the centralized "
             "update")
    log(f"rbf_kernel at the centralized update (1 x {X.shape[0]}): agrees "
        f"with plain, {cuda_ms(lambda: ops.rbf_kernel(x1, X, 0.5), 10):.4f} "
        f"ms")
    del K

    # the weighted greedy_select at round 0
    w = weighted["w"]
    seed = torch.sum(E * E, dim=-1)
    sel, cm_out = ops.greedy_select(blocks, E, seed, bmask, k, eval_weights=w)
    t0 = time.perf_counter()
    trace = ref.greedy_select_trace(blocks, E, seed, bmask, k,
                                    eval_weights=w)
    torch.cuda.synchronize()
    log(f"plain weighted greedy at round 0 (M={M}): "
        f"{time.perf_counter() - t0:.1f} s")
    n_tie, same, err = check_greedy(sel, cm_out, blocks, E, seed, trace,
                                    "weighted greedy_select at round 0")
    log(f"weighted greedy_select round 0 vs plain: {same}/{M} machines "
        f"select as plain, near-tie steps {n_tie}, max|dcm| {err:.3g}")
    ms = cuda_ms(lambda: ops.greedy_select(blocks, E, seed, bmask, k,
                                           eval_weights=w), runs=5)
    plain = cuda_ms(lambda: ref.greedy_select(blocks, E, seed, bmask, k,
                                              eval_weights=w),
                    runs=1, warmup=0)
    check_step_launches("greedy_select_weighted", lambda: ops.greedy_select(
        blocks, E, seed, bmask, k, eval_weights=w), k)
    n_avail = torch.sum(bmask.long(), dim=1, keepdim=True)
    calls = int(torch.sum(torch.clamp_min(
        n_avail - torch.arange(k, device="cuda"), 0)))
    b, by, b32 = tile_bound(calls * m, d,
                            4 * M * mu * d + 4 * m * d + 8 * m + M * mu
                            + 4 * M * k + 4 * M * m, 4)
    rows.append({"name": "greedy_select (eval weights)", "route": "cuda",
                 "source": "src/repro_torch/kernels/csrc/greedy_select.cu",
                 "replaces": "src/repro/kernels/greedy_select.py:265",
                 "launches": weighted["launches"],
                 "calls": weighted["launches"] // k, "max_abs_err": err,
                 "ms": ms, "plain_ms": plain, "bound_ms": b, "bound_by": by,
                 "bound_fp32_ms": b32, "library_ms": None})
    return rows


#: plain greedy steps after which the split tile is held against the plain
#: gains at round 0 (the first, the middle and the last step of k = 50)
TILE_STEPS = (0, 25, 49)


def tile_precision(blocks, E, seed, sel) -> dict:
    """The gain tile (split TF32 on the tensor cores, through
    ``exemplar_gains``' kernel) against the plain ``exemplar_gains`` on
    every machine of round 0, at the cur_min the plain greedy ``sel`` left
    after each of ``TILE_STEPS`` steps, under the unchanged RTOL/ATOL.
    Returns {steps: max |Δ gain|}."""
    from repro_torch import testing
    from repro_torch.kernels import ops, ref
    errs = {}
    for s in TILE_STEPS:
        cm = ref.refresh_cur_min(blocks, E, seed, sel[:, :s])
        g, g_p = ops.exemplar_gains(blocks, E, cm), ref.exemplar_gains(
            blocks, E, cm)
        testing.assert_close(g, g_p, f"gain tile at round 0 after {s} steps")
        errs[s] = testing.max_abs_err(g, g_p)
        del g, g_p
    after = ", ".join(f"{s} steps {e!r}" for s, e in errs.items())
    log(f"gain tile (split TF32) vs plain at round 0, M = {blocks.shape[0]}: "
        f"max |Δ gain| after {after} (rtol={testing.RTOL} "
        f"atol={testing.ATOL})")
    return errs


def phase_times(scan: dict, main: dict, constrained: dict, active: dict,
                facility: dict, weighted: dict) -> list[dict]:
    """Each kernel at its path's shapes: time, plain time, bound."""
    import torch
    from repro_torch import testing
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
    b, by, b32 = tile_bound(n * m, d, 4 * (n * d + m * d + m + n), 3)
    rows.append({"name": "exemplar_gains", "route": "cuda",
                 "source": "src/repro_torch/kernels/csrc/exemplar_gains.cu",
                 "replaces": "src/repro/kernels/exemplar_gains.py:107",
                 "launches": scan["launches"], "max_abs_err": err, "ms": ms,
                 "plain_ms": plain, "bound_ms": b, "bound_by": by,
                 "bound_fp32_ms": b32, "library_ms": None})
    # greedy_select at round 0 of the main path
    obj, cfg = main["obj"], main["cfg"]
    E = obj.eval_set
    blocks, bmask, part = round0_blocks(main)
    M, mu, d = blocks.shape
    m, k = E.shape[0], cfg.k
    seed = torch.sum(E * E, dim=-1)
    sel, cm_out = ops.greedy_select(blocks, E, seed, bmask, k)
    t0 = time.perf_counter()
    trace = ref.greedy_select_trace(blocks, E, seed, bmask, k)
    torch.cuda.synchronize()
    log(f"plain greedy at round 0 (M={M}): {time.perf_counter() - t0:.1f} s")
    tile_precision(blocks, E, seed, trace[0])
    n_tie, same, err = check_greedy(sel, cm_out, blocks, E, seed, trace,
                                    "greedy_select at round 0")
    log(f"greedy_select round 0 vs plain: {same}/{M} machines select as "
        f"plain, every machine's cur_min checked, near-tie steps {n_tie}, "
        f"max|dcm| {err:.3g}")
    ms = cuda_ms(lambda: ops.greedy_select(blocks, E, seed, bmask, k),
                 runs=10)
    plain = cuda_ms(lambda: ref.greedy_select(blocks, E, seed, bmask, k),
                    runs=3)
    check_step_launches("greedy_select", lambda: ops.greedy_select(
        blocks, E, seed, bmask, k), k)
    n_avail = torch.sum(bmask.long(), dim=1, keepdim=True)
    steps = torch.arange(k, device="cuda")
    calls = int(torch.sum(torch.clamp_min(n_avail - steps, 0)))
    b, by, b32 = tile_bound(calls * m, d,
                            4 * M * mu * d + 4 * m * d + 4 * m + M * mu
                            + 4 * M * k + 4 * M * m, 3)
    launches = main["launches"]["greedy_select"]
    rows.append({"name": "greedy_select", "route": "cuda",
                 "source": "src/repro_torch/kernels/csrc/greedy_select.cu",
                 "replaces": "src/repro/kernels/greedy_select.py:265",
                 "launches": launches, "calls": launches // k,
                 "max_abs_err": err, "ms": ms, "plain_ms": plain,
                 "bound_ms": b, "bound_by": by, "bound_fp32_ms": b32,
                 "library_ms": None})
    rows += times_constrained(main, constrained, blocks, bmask, part)
    rows += times_new(main, active, facility, weighted, blocks, bmask)
    for r in rows:
        per = (f" a call ({r['calls']} calls a run)" if "calls" in r else "")
        b32 = (f"; fp32-only bound {r['bound_fp32_ms']:.4f} ms, "
               f"{r['bound_fp32_ms'] / r['ms']:.1%}"
               if "bound_fp32_ms" in r else "")
        log(f"time {r['name']}: {r['ms']:.4f} ms{per} (plain "
            f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms by "
            f"{r['bound_by']}, {r['bound_ms'] / r['ms']:.1%} of bound{b32}), "
            f"launches {r['launches']}")
    return rows



# ---------------------------------------------------------------------------
# LM serving: the dense transformer (Qwen3-8B) and flash_attention
# ---------------------------------------------------------------------------

# hf:Qwen/Qwen3-8B at full width; the serving cell and the parity run
LM_ARCH = "qwen3-8b"
# arXiv:2404.05892 (Finch) at full width and depth: the same two phases
RWKV_ARCH = "rwkv6-1.6b"
#: the hand-written kernel each family's serving runs; its launch counters
#: are "<name>_prefill" and "<name>_decode"
FAMILY_KERNEL = {"dense": "flash_attention", "ssm": "wkv6"}
LM_SERVE = dict(batch=8, prompt=2048, new=32, cache_len=2080)
LM_PARITY = dict(layers=2, batch=1, prompt=256, new=8)
ATTN_32K = dict(B=1, H=32, Hkv=8, S=32_768, D=128)   # prefill_32k, batch 1


def _qkv(B, H, Hkv, S, T, D, dtype, seed, strided=False):
    """q, k, v ~ N(0, 1) on the card (logits of unit spread); strided, as
    the model passes its projections: (B, S, H, D) memory seen as
    (B, H, S, D)."""
    import torch
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    if strided:
        return tuple(torch.randn((b, n, h, d), generator=g, device="cuda")
                     .to(dtype).transpose(1, 2)
                     for b, h, n, d in ((B, H, S, D), (B, Hkv, T, D),
                                        (B, Hkv, T, D)))
    return tuple(torch.randn(shape, generator=g, device="cuda").to(dtype)
                 for shape in ((B, H, S, D), (B, Hkv, T, D), (B, Hkv, T, D)))


def visible_pairs(S: int, T: int, causal: bool, kv) -> int:
    """(query, key) pairs that take part: each query row sees the keys
    below kv_valid_len and, causal, at or before its own position."""
    kv = T if kv is None else min(kv, T)
    if not causal:
        return S * kv
    return sum(min(kv, r + 1 + T - S) for r in range(S))


def attention_bound(B, H, Hkv, S, T, D, causal, kv, itemsize):
    """(bound ms, by): the products (4 operations per visible pair and
    feature) on the bf16 tensor cores, or the bytes of q, the valid K/V
    and the output, each moved once."""
    flops = 4 * B * H * D * visible_pairs(S, T, causal, kv)
    kvn = T if kv is None else min(kv, T)
    nbytes = itemsize * D * (2 * B * H * S + 2 * B * Hkv * kvn)
    t_ops, t_bytes = flops / PEAK_BF16, nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


def _ptxas_report(log: str, marker: str) -> list[str]:
    """ptxas's registers, shared memory and spills of each kernel in
    ``log`` whose mangled name holds ``marker``."""
    out, name = [], None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1] if "'" in line else line
        elif name and marker in name and ("spill" in line
                                          or "registers" in line):
            out.append(f"{name[name.find(marker):][:56]}: "
                       f"{line.replace('ptxas info    :', '').strip()}")
    return out


def sass_count(lib: str, op: str) -> int | None:
    """Instructions whose opcode holds ``op`` in the SASS of the built
    library ``lib``, or None where cuobjdump is missing."""
    import os
    import shutil
    from repro_torch.kernels import _build
    tool = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / \
        "cuobjdump"
    tool = str(tool) if tool.exists() else shutil.which("cuobjdump")
    if tool is None:
        return None
    _build.load(lib)
    sass = subprocess.run([tool, "-sass", str(_build.lib_path(lib))],
                          capture_output=True, text=True, timeout=300)
    if sass.returncode != 0:
        fail(f"cuobjdump: {sass.stderr.strip()[:500]}")
    return sum(line.count(op) for line in sass.stdout.splitlines())


def hgmma_count() -> int | None:
    """HGMMA instructions in the built flash_attention library's SASS (the
    tensor-core prefill's products), or None where cuobjdump is missing."""
    return sass_count("flash_attention", "HGMMA")


def hmma_counts() -> dict:
    """HMMA instructions (mma.sync, the gain tile's TF32 products) in the
    SASS of the three libraries built on exemplar_tile.cuh, next to
    flash_attention's HGMMA; fails where cuobjdump shows a library without
    one.  Returns {library: count}, empty where cuobjdump is missing."""
    from repro_torch.kernels import _build
    counts = {lib: sass_count(lib, "HMMA") for lib in
              ("exemplar_gains", "greedy_select", "threshold_select")}
    if None in counts.values():
        log("  cuobjdump not found: HMMA not counted")
        return {}
    for lib, n in counts.items():
        if n == 0:
            fail(f"{lib}: no HMMA instruction in the built library's SASS "
                 f"(the gain tile runs no tensor-core product)")
    log(f"HMMA in the SASS of the gain tile's libraries: {counts}; HGMMA in "
        f"flash_attention's: {hgmma_count()}")
    for lib in counts:
        for line in _ptxas_report(_build.build_log.get(lib, ""), "kernel"):
            log(f"  ptxas {lib} {line}")
    return counts


def phase_kernels_attention() -> None:
    """flash_attention against its plain version on the card, fp32 and
    bf16: D ∈ {16, 64, 128, 256} × group ∈ {1, 4, 8}, causal and not, S = T
    and S < T (the offset) at ragged S and T; the tensor-core prefill's
    tile edges (S, T ∈ {127, 128, 129}, D ∈ {64, 128, 256}, groups 1/4/8)
    on the model's strided (B, S, H, D) views; decode (S = 1) with
    kv_valid_len ∈ {1, T/2 + 3, T}, split over the keys (B × Hkv = 1) and
    not (B × Hkv = 320), and at the serving shape across the 16-key tile's
    edges; prefill with kv_valid_len; the 32k prefill; a head dim it has no
    instantiation of raises.  Each case's route (``prefill_route``, or
    decode) is logged and held against the launch counters; the worst |Δ|
    per route, the new kernels' registers, shared memory and spills, and
    the HGMMA instructions of the built library (none fails the phase,
    where cuobjdump exists)."""
    import torch
    from repro_torch import testing
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops, ref
    worst: dict[str, float] = {}
    cases: dict[str, int] = {}

    def check(B, H, Hkv, S, T, D, dtype, causal, kv, seed, strided=False):
        q, k, v = _qkv(B, H, Hkv, S, T, D, dtype, seed, strided)
        route = "decode" if S == 1 else fa.prefill_route(dtype, D)
        ops.reset_launch_counts()
        o = ops.flash_attention(q, k, v, causal=causal, kv_valid_len=kv)
        torch.cuda.synchronize()
        counts = dict(ops.launch_counts)
        o_p = ref.flash_attention(q, k, v, causal=causal, kv_valid_len=kv)
        what = (f"flash_attention {dtype} B={B} H={H} Hkv={Hkv} S={S} T={T} "
                f"D={D} causal={causal} kv_valid_len={kv} strided={strided}")
        want = {"decode": (0, 0, 1), "wgmma": (1, 1, 0),
                "cuda_cores": (1, 0, 0)}[route]
        got = (counts["flash_attention_prefill"],
               counts["flash_attention_prefill_wgmma"],
               counts["flash_attention_decode"])
        if got != want:
            fail(f"{what}: route {route} but launches (prefill, wgmma, "
                 f"decode) {got}")
        if o.shape != q.shape or o.dtype != q.dtype:
            fail(f"{what}: output {o.dtype} {tuple(o.shape)}")
        testing.assert_attention_close(o, o_p, dtype == torch.bfloat16, what)
        err = testing.max_abs_err(o, o_p)
        key = f"{route} {str(dtype).split('.')[-1]}"
        worst[key] = max(worst.get(key, 0.0), err)
        cases[key] = cases.get(key, 0) + 1
        log(f"  {route:10s} {what[16:]}: max |do| {err:.3g}")

    seed = 0
    for dtype in (torch.float32, torch.bfloat16):
        for D in fa.HEAD_DIMS:
            for group in (1, 4, 8):
                for causal in (True, False):
                    for S, T in ((100, 100), (37, 300)):
                        seed += 1
                        check(2, 2 * group, 2, S, T, D, dtype, causal, None,
                              seed)
                T = 1000
                for kv in (1, T // 2 + 3, T):
                    seed += 1
                    check(1, group, 1, 1, T, D, dtype, False, kv, seed)
            seed += 1
            check(40, 8, 8, 1, 300, D, dtype, True, 250, seed)   # one split
            check(2, 8, 2, 70, 200, D, dtype, True, 150, seed)   # prefill
    # the tensor-core prefill's tile edges (128 queries, 128 or 64 keys)
    for D in fa.WGMMA_HEAD_DIMS:
        for group in (1, 4, 8):
            for S, T in ((127, 127), (128, 128), (129, 129), (127, 129),
                         (129, 257)):
                seed += 1
                check(2, 2 * group, 2, S, T, D, torch.bfloat16, True, None,
                      seed, strided=True)
    # decode at the serving shape across the 16-key tile's edges
    for kv in (15, 16, 17, 2079, 2080):
        seed += 1
        check(8, 32, 8, 1, 2080, 128, torch.bfloat16, False, kv, seed)
    log(f"  decode splits (nsplit, chunk) at 132 SMs, 2 CTAs an SM: "
        f"B x Hkv = 1 at T = 1000 -> {fa.decode_splits(1, 1, 8, 1000, 132)}"
        f", B x Hkv = 320 -> {fa.decode_splits(40, 8, 1, 250, 132)}, the "
        f"serving shape -> {fa.decode_splits(8, 8, 4, 2080, 132)}")
    c = ATTN_32K
    t0 = time.perf_counter()
    check(c["B"], c["H"], c["Hkv"], c["S"], c["S"], c["D"], torch.bfloat16,
          True, None, 99, strided=True)
    log(f"  32k prefill ({c}, causal, bf16) against plain: "
        f"{time.perf_counter() - t0:.1f} s")
    q, k, v = _qkv(1, 2, 1, 3, 9, 32, torch.bfloat16, 0)
    try:
        ops.flash_attention(q, k, v)
    except ValueError:
        pass
    else:
        fail("flash_attention took a head dim it has no instantiation of")
    smem = {D: {kind: fa.smem_bytes(D, kind) for kind in fa.SMEM_KINDS}
            for D in fa.HEAD_DIMS}
    log(f"  shared memory per CTA by D (bf16; decode at G = 4), from the "
        f"built kernel: {smem}")
    build_log = _build.build_log.get("flash_attention", "")
    for marker in ("flash_prefill_wgmma_kernel", "flash_decode_kernel"):
        for line in _ptxas_report(build_log, marker):
            log(f"  ptxas {line}")
    n_hgmma = hgmma_count()
    if n_hgmma is None:
        log("  cuobjdump not found: HGMMA not counted")
    elif n_hgmma == 0:
        fail("flash_attention: no HGMMA instruction in the built library's "
             "SASS (the tensor-core prefill runs no wgmma)")
    else:
        log(f"  HGMMA instructions in the built library's SASS: {n_hgmma}")
    log(f"flash_attention vs plain: {sum(cases.values())} shapes agree "
        f"(fp32 within rtol={testing.RTOL} atol={testing.ATOL}; bf16 within "
        f"rtol={testing.BF16_RTOL:.5g} atol={testing.ATOL}); cases and max "
        f"|do| by route: " + ", ".join(
            f"{key} {cases[key]} {worst[key]:.3g}" for key in sorted(cases)))


def _lm_prompt(cfg, batch: int, seq: int, device: str):
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    return SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                                  global_batch=batch, seed=SEED),
                       device).batch(0)["tokens"]


def phase_lm_parity(arch: str = LM_ARCH) -> None:
    """``arch`` (Qwen3-8B, rwkv6-1.6b) at full width and 2 layers, one set
    of weights: prefill a SyntheticLM prompt and decode on the card, and the
    same on the CPU through the plain versions, fed the card's tokens;
    logits within LM_PARITY_TOL at every step, and the card's pick the
    CPU's or within LM_PARITY_TOL of the CPU's best (the near-tie rule);
    the family's kernel launched once per layer and call."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import get_model
    from repro_torch.serve import make_serve_fns
    from repro_torch.serve.serve_step import next_token
    c = LM_PARITY
    cfg = dataclasses.replace(get_config(arch), n_layers=c["layers"])
    kern = FAMILY_KERNEL[cfg.family]
    params = get_model(cfg).init_params(cfg, device="cuda", seed=SEED)
    prompt = _lm_prompt(cfg, c["batch"], c["prompt"], "cuda")
    cache_len = c["prompt"] + c["new"]

    def run(p, toks_in, device):
        pf, df = make_serve_fns(cfg, cache_len)
        lg, cache = pf(p, prompt.to(device))
        logits, toks = [lg[:, -1].float().cpu()], [next_token(lg)]
        for t in range(c["new"] - 1):
            feed = toks[-1] if toks_in is None else toks_in[t].to(device)
            lg, cache = df(p, cache, feed)
            logits.append(lg[:, -1].float().cpu())
            toks.append(next_token(lg))
        return torch.stack(logits, 1), [t.cpu() for t in toks]

    ops.reset_launch_counts()
    card_logits, card_toks = run(params, None, "cuda")
    torch.cuda.synchronize()
    counts = dict(ops.launch_counts)
    if (counts[f"{kern}_prefill"] != c["layers"]
            or counts[f"{kern}_decode"] != c["layers"] * (c["new"] - 1)):
        fail(f"LM parity ({arch}): {kern} launches {counts}")
    cpu_params = {name: ({key: t.cpu() for key, t in val.items()}
                         if isinstance(val, dict) else val.cpu())
                  for name, val in params.items()}
    del params
    t0 = time.perf_counter()
    cpu_logits, cpu_toks = run(cpu_params, card_toks, "cpu")
    t_cpu = time.perf_counter() - t0
    err = float(torch.max(torch.abs(card_logits - cpu_logits)))
    card_tok = torch.cat(card_toks, 1)
    best = cpu_logits.max(dim=-1).values
    picked = torch.take_along_dim(cpu_logits, card_tok[..., None].long(),
                                  dim=-1)[..., 0]
    differ = card_tok != torch.cat(cpu_toks, 1)
    gap = float(torch.max(best - picked))
    log(f"LM parity, {arch} at full width and {c['layers']} layers "
        f"(B={c['batch']}, prompt {c['prompt']}, {c['new']} tokens): card vs "
        f"CPU max |dlogit| {err!r} over {c['new']} steps (logits up to "
        f"{float(cpu_logits.abs().max()):.3f}); picks differing "
        f"{int(differ.sum())}, CPU's best minus its logit at the card's "
        f"pick up to {gap!r}; CPU side {t_cpu:.1f} s; launches {counts}")
    if err > LM_PARITY_TOL:
        fail(f"LM parity ({arch}): card and CPU logits differ by {err} > "
             f"{LM_PARITY_TOL}")
    if gap > LM_PARITY_TOL:
        fail(f"LM parity ({arch}): a card pick is {gap} below the CPU's "
             f"best (> {LM_PARITY_TOL})")


def phase_lm_serve(arch: str = LM_ARCH) -> dict:
    """``arch`` (Qwen3-8B, rwkv6-1.6b) at full width and depth on the card
    through greedy_generate: 8 SyntheticLM prompts of 2,048 tokens, 32 new
    tokens, cache 2,080.  Every launch counter of the family's kernel moved
    (one prefill launch per layer, one decode launch per layer and step);
    the last decode step's logits agree with forward over the prompt and
    the generated tokens within LM_SERVE_TOL.  Times prefill and each
    decode step (CUDA events), the memory peak, the kernel's share of both
    (events around each call of it, a run of its own), and the device time
    of one prefill and one decode step replayed from a CUDA graph (so
    1 − device / wall is the share the device idles while the host
    launches)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import get_model
    from repro_torch.serve import greedy_generate, make_serve_fns
    from repro_torch.serve.serve_step import next_token
    c = LM_SERVE
    cfg = get_config(arch)
    model, kern = get_model(cfg), FAMILY_KERNEL[cfg.family]
    B, S, n_new = c["batch"], c["prompt"], c["new"]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = model.init_params(cfg, device="cuda", seed=SEED)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    init_peak = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    w_bytes = sum(t.numel() * t.element_size()
                  for val in params.values()
                  for t in (val.values() if isinstance(val, dict) else [val]))
    prompt = _lm_prompt(cfg, B, S, "cuda")
    ops.reset_launch_counts()
    out = greedy_generate(cfg, params, prompt, n_new,
                          cache_len=c["cache_len"])
    torch.cuda.synchronize()
    counts = dict(ops.launch_counts)
    want = {f"{kern}_prefill": cfg.n_layers,
            f"{kern}_decode": cfg.n_layers * (n_new - 1)}
    for name, n in want.items():
        if counts[name] != n:
            fail(f"LM serve ({arch}): {name} launched {counts[name]} times, "
                 f"not {n}")
    if (kern == "flash_attention" and counts["flash_attention_prefill_wgmma"]
            != counts["flash_attention_prefill"]):
        fail(f"LM serve ({arch}): {counts['flash_attention_prefill_wgmma']} "
             f"of {counts['flash_attention_prefill']} prefill launches took "
             "the tensor-core route")
    if (out.shape != (B, n_new) or int(out.min()) < 0
            or int(out.max()) >= cfg.padded_vocab):
        fail(f"LM serve ({arch}): tokens {tuple(out.shape)} out of range")

    pf, df = make_serve_fns(cfg, c["cache_len"])

    def serve_once():
        """(prefill ms, decode ms per step, last logits, tokens, cache)."""
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(n_new + 1)]
        torch.cuda.synchronize()
        ev[0].record()
        lg, cache = pf(params, prompt)
        ev[1].record()
        toks = [next_token(lg)]
        for t in range(n_new - 1):
            lg, cache = df(params, cache, toks[-1])
            ev[t + 2].record()
            toks.append(next_token(lg))
        torch.cuda.synchronize()
        steps = [ev[t + 1].elapsed_time(ev[t + 2]) for t in range(n_new - 1)]
        return ev[0].elapsed_time(ev[1]), steps, lg, torch.cat(toks, 1), cache

    def device_ms(fn) -> float:
        """Device time of ``fn``'s work alone: captured once in a CUDA graph
        and replayed, so no host launch overhead is in it."""
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):      # warm up off the capture
            fn()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            fn()
        return cuda_ms(graph.replay, runs=3)

    prefill_ms, steps, last, toks, cache = serve_once()
    peak = torch.cuda.max_memory_allocated()
    # one more decode step (position 2,079 of 2,080) and one more prefill,
    # each timed on the device alone
    pos, tok = cache["pos"], toks[:, -1:]

    def decode_at_pos():
        df(params, cache, tok)
        cache["pos"] = pos

    dev_decode = device_ms(decode_at_pos)
    del cache
    dev_prefill = device_ms(lambda: pf(params, prompt))
    torch.cuda.empty_cache()
    if not torch.equal(toks, out):
        fail(f"LM serve ({arch}): a second run through the serve fns picked "
             "other tokens than greedy_generate")
    # the kernel's share: events around every call of it
    calls = []
    orig = getattr(ops, kern)

    def timed(*a, **kw):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        o = orig(*a, **kw)
        e1.record()
        calls.append((a[0].shape[2], e0, e1))
        return o

    setattr(ops, kern, timed)
    try:
        prefill_ms2, steps2, _, toks2, _ = serve_once()
    finally:
        setattr(ops, kern, orig)
    k_prefill = sum(e0.elapsed_time(e1) for s, e0, e1 in calls if s > 1)
    k_decode = sum(e0.elapsed_time(e1) for s, e0, e1 in calls if s == 1)
    if not torch.equal(toks2, out):
        fail(f"LM serve ({arch}): the timed run picked other tokens")

    full = model.forward(params, cfg, torch.cat([prompt, out[:, :-1]], 1))
    err = float(torch.max(torch.abs(full[:, -1].float()
                                    - last[:, -1].float())))
    del full
    decode_ms = statistics.median(steps)
    total_ms = prefill_ms + sum(steps)
    res = {"prefill_ms": prefill_ms, "decode_ms_per_token": decode_ms,
           "decode_ms_mean": sum(steps) / len(steps),
           "tokens_per_s": B * n_new / (total_ms / 1e3),
           "decode_tokens_per_s": B / (decode_ms / 1e3),
           "peak_bytes": peak, "init_peak_bytes": init_peak,
           "weight_bytes": w_bytes,
           "kernel": kern,
           "kernel_share_prefill": k_prefill / prefill_ms2,
           "kernel_share_decode": k_decode / sum(steps2),
           "kernel_prefill_ms": k_prefill,
           "kernel_decode_ms_per_token": k_decode / (n_new - 1),
           "prefill_device_ms": dev_prefill, "decode_device_ms": dev_decode,
           "decode_device_idle_share": 1.0 - dev_decode / decode_ms,
           "prefill_device_idle_share": 1.0 - dev_prefill / prefill_ms,
           "decode_vs_forward": err, "launches": counts,
           "init_s": t_init}
    log(f"LM serve, {arch} ({cfg.n_layers} layers, d_model "
        f"{cfg.d_model}, {w_bytes / 1e9:.2f} GB of weights, init "
        f"{t_init:.1f} s): B={B}, prompt {S}, {n_new} new tokens, cache "
        f"{c['cache_len']}; launches {counts}; tokens[0, :8] "
        f"{out[0, :8].tolist()}")
    log(f"LM serve: {json.dumps(res)}")
    if err > LM_SERVE_TOL:
        fail(f"LM serve ({arch}): last decode step vs forward {err} > "
             f"{LM_SERVE_TOL}")
    del params
    torch.cuda.empty_cache()
    return res


def times_attention(serve: dict) -> list[dict]:
    """flash_attention at the serving cell's prefill and decode shapes and
    at the 32k prefill, bf16: held against its plain version there, timed
    beside it, beside its bound and beside PyTorch's
    scaled_dot_product_attention on the same inputs."""
    import torch
    import torch.nn.functional as F
    from repro_torch import testing
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops, ref
    c, a = LM_SERVE, ATTN_32K
    cfg = get_config(LM_ARCH)
    H, Hkv, D = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    shapes = [("prefill", c["batch"], H, Hkv, c["prompt"], c["prompt"], D,
               True, None, serve["launches"]["flash_attention_prefill"], 10,
               3),
              ("decode", c["batch"], H, Hkv, 1, c["cache_len"], D, False,
               c["cache_len"], serve["launches"]["flash_attention_decode"],
               50, 10),
              ("prefill 32k", a["B"], a["H"], a["Hkv"], a["S"], a["S"],
               a["D"], True, None,
               serve["launches"]["flash_attention_prefill"], 3, 1)]
    rows = []
    for (what, B, H, Hkv, S, T, D, causal, kv, launches, runs,
         plain_runs) in shapes:
        q, k, v = _qkv(B, H, Hkv, S, T, D, torch.bfloat16, 7)
        o = ops.flash_attention(q, k, v, causal=causal, kv_valid_len=kv)
        o_p = ref.flash_attention(q, k, v, causal=causal, kv_valid_len=kv)
        testing.assert_attention_close(o, o_p, True,
                                       f"flash_attention at the {what} shape")
        err = testing.max_abs_err(o, o_p)
        del o, o_p
        ms = cuda_ms(lambda: ops.flash_attention(q, k, v, causal=causal,
                                                 kv_valid_len=kv), runs=runs)
        plain = cuda_ms(lambda: ref.flash_attention(
            q, k, v, causal=causal, kv_valid_len=kv), runs=plain_runs)
        if kv is None:
            lib = cuda_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=causal, enable_gqa=True), runs=runs)
        else:
            mask = (torch.arange(T, device="cuda") < kv)[None, None, None]
            lib = cuda_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, attn_mask=mask, enable_gqa=True), runs=runs)
        b, by = attention_bound(B, H, Hkv, S, T, D, causal, kv, 2)
        log(f"flash_attention {what}: B={B} H={H} Hkv={Hkv} S={S} T={T} "
            f"D={D} causal={causal} kv_valid_len={kv}, bf16")
        rows.append({"name": f"flash_attention ({what})", "route": "cuda",
                     "source": "src/repro_torch/kernels/csrc/"
                               "flash_attention.cu",
                     "replaces": "src/repro/kernels/flash_attention.py:91",
                     "launches": launches, "max_abs_err": err, "ms": ms,
                     "plain_ms": plain, "bound_ms": b, "bound_by": by,
                     "library_ms": lib})
        del q, k, v
    torch.cuda.empty_cache()
    return rows


# ---------------------------------------------------------------------------
# RWKV-6 serving (rwkv6-1.6b) and wkv6
# ---------------------------------------------------------------------------

WKV_32K = dict(B=1, T=32_768)   # prefill_32k's length, batch 1


def _wkv_inputs(B, H, T, Dk, Dv, dtype, seed, decay="model", strided=True):
    """r, k, v ~ N(0, 1) and u ~ 0.1·N(0, 1) in ``dtype``, w fp32 in (0, 1)
    on the card: ``decay`` "model" is the decay of the model at its init,
    exp(−exp(−6 + N(0, 1)/2)) ≈ 0.9975 (a state that remembers ~400
    steps), "fast" is sigmoid(N(0, 1) + 2), as tests/test_kernels.py draws
    it.  ``strided``: each a (B, H, T, D) view of a (B, T, H, D) tensor, as
    the model passes them."""
    import torch
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)

    def draw(D, dt):
        x = torch.randn((B, T, H, D), generator=g, device="cuda").to(dt)
        return x.transpose(1, 2) if strided else x.transpose(1, 2).contiguous()

    r, k, v = draw(Dk, dtype), draw(Dk, dtype), draw(Dv, dtype)
    n = draw(Dk, torch.float32)
    w = (torch.exp(-torch.exp(-6.0 + 0.5 * n)) if decay == "model"
         else torch.sigmoid(n + 2.0))
    u = (0.1 * torch.randn((H, Dk), generator=g, device="cuda")).to(dtype)
    return r, k, v, w, u


def wkv6_bound(B, H, T, Dk, Dv, itemsize, state_in, y_itemsize):
    """(bound ms, by): 5·Dk·Dv + 3·Dk + 2·Dv fp32 operations per step and
    head (the state update w·S + k·v, r·S, the bonus (r·u)·k and v·a), or
    the bytes of r, k, v and u (``itemsize``), w (fp32), y
    (``y_itemsize``) and the fp32 state, read where given and written,
    each moved once."""
    steps = B * H * T
    flops = steps * (5 * Dk * Dv + 3 * Dk + 2 * Dv)
    nbytes = (steps * ((2 * Dk + Dv) * itemsize + 4 * Dk + Dv * y_itemsize)
              + H * Dk * itemsize + 4 * B * H * Dk * Dv * (1 + int(state_in)))
    return bound_ms(flops, nbytes)


def phase_kernels_wkv6() -> None:
    """wkv6 against its plain version on the card, fp32 and bf16: Dk = Dv
    = 64 and 16, Dk ≠ Dv, ragged T, B × H = 1 and 256, r/k/v/w as the
    model's strided views and contiguous, from zeros and from a given
    state, T = 2,100; two launches over the halves of T against one over
    all of it; one decode step (T = 1) from a state written in place; the
    shapes it does not take raise.  The kernel repeats its plain version's
    arithmetic op for op, so they agree to the bit: the check is
    testing's tolerance, and the bitwise agreements are counted."""
    import torch
    from repro_torch import testing
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import wkv6 as wk
    worst = {torch.float32: 0.0, torch.bfloat16: 0.0}
    n = same = 0

    def check(y, st, y_p, st_p, bf16, what):
        nonlocal n, same
        testing.assert_attention_close(y, y_p, bf16, f"{what}: y")
        testing.assert_close(st, st_p, f"{what}: state")
        worst[torch.bfloat16 if bf16 else torch.float32] = max(
            worst[torch.bfloat16 if bf16 else torch.float32],
            testing.max_abs_err(y, y_p), testing.max_abs_err(st, st_p))
        n += 1
        same += int(torch.equal(y, y_p) and torch.equal(st, st_p))

    seed = 0
    for dtype in (torch.float32, torch.bfloat16):
        small = 4 if dtype == torch.float32 else 8
        cases = [(2, 3, 37, 16, 16, "fast", True),
                 (1, 1, 100, 64, 64, "model", True),
                 (8, 32, 70, 64, 64, "model", True),
                 (2, 2, 45, 16, 64, "fast", True),
                 (2, 2, 33, 64, 16, "fast", False),
                 (1, 2, 20, small, 2 * small, "fast", False),
                 (2, 4, 2100, 64, 64, "model", True)]
        for B, H, T, Dk, Dv, decay, strided in cases:
            for given in (False, True):
                seed += 1
                r, k, v, w, u = _wkv_inputs(B, H, T, Dk, Dv, dtype, seed,
                                            decay, strided)
                s0 = (torch.randn((B, H, Dk, Dv), device="cuda")
                      if given else None)
                y, st = ops.wkv6(r, k, v, w, u, s0)
                torch.cuda.synchronize()
                y_p, st_p = ref.wkv6(r, k, v, w, u, s0)
                check(y, st, y_p, st_p, dtype == torch.bfloat16,
                      f"wkv6 {dtype} B={B} H={H} T={T} Dk={Dk} Dv={Dv} "
                      f"{decay} strided={strided} state={given}")
    # state chaining: [0, 150) then [150, 300) from its state, in place
    r, k, v, w, u = _wkv_inputs(2, 4, 300, 64, 64, torch.bfloat16, 91)
    y, st = ops.wkv6(r, k, v, w, u)
    st2 = torch.empty_like(st)
    y1, _ = ops.wkv6(*(a[:, :, :150] for a in (r, k, v, w)), u,
                     state_out=st2)
    y2, _ = ops.wkv6(*(a[:, :, 150:] for a in (r, k, v, w)), u, st2,
                     state_out=st2)
    torch.cuda.synchronize()
    if not (torch.equal(torch.cat([y1, y2], 2), y) and torch.equal(st2, st)):
        fail("wkv6: two launches over the halves of T differ from one")
    # one decode step from a state, written in place, y in fp32 as the model
    r, k, v, w, u = _wkv_inputs(8, 32, 1, 64, 64, torch.bfloat16, 92)
    state = torch.randn((8, 32, 64, 64), device="cuda")
    before = state.clone()
    y, st = ops.wkv6(r, k, v, w, u, state, state_out=state,
                     out_dtype=torch.float32)
    torch.cuda.synchronize()
    y_p, st_p = ref.wkv6(r, k, v, w, u, before, out_dtype=torch.float32)
    if st is not state or y.dtype != torch.float32:
        fail("wkv6 decode: the state was not updated in place")
    check(y, st, y_p, st_p, False, "wkv6 decode in place")
    for Dk, dtype in ((128, torch.bfloat16), (4, torch.bfloat16)):
        r, k, v, w, u = _wkv_inputs(1, 1, 3, Dk, 16, dtype, 0)
        try:
            ops.wkv6(r, k, v, w, u)
        except ValueError:
            pass
        else:
            fail(f"wkv6 took Dk={Dk} in {dtype}, which it has no "
                 "instantiation of")
    smem = {Dk: (wk.smem_bytes(Dk, False), wk.smem_bytes(Dk, True))
            for Dk in (16, 32, 64)}
    log(f"  shared memory per CTA (fp32, bf16 operands) by Dk, from the "
        f"built kernel: {smem}")
    log(f"wkv6 vs plain: {n} cases agree (fp32 within rtol={testing.RTOL} "
        f"atol={testing.ATOL}, max |d| {worst[torch.float32]!r}; bf16 y "
        f"within rtol={testing.BF16_RTOL:.5g}, max |d| "
        f"{worst[torch.bfloat16]!r}), {same} of them to the bit; chaining "
        f"over halves of T and the in-place decode step checked")


def times_wkv6(serve: dict) -> list[dict]:
    """wkv6 at the RWKV serving cell's prefill (B = 8, T = 2,048, the
    final state written) and decode (B = 8, T = 1, state in and out, y in
    fp32) shapes and at the 32k prefill (B = 1), bf16 r/k/v/u and fp32 w
    as the model passes them: held against its plain version there, timed
    beside it and beside its bound.  No PyTorch call computes the
    recurrence (library_ms null)."""
    import torch
    from repro_torch import testing
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops, ref
    c = LM_SERVE
    cfg = get_config(RWKV_ARCH)
    H, D = cfg.n_heads, cfg.rwkv_head_dim
    launches = serve["launches"]
    shapes = [("prefill", c["batch"], c["prompt"], False,
               launches["wkv6_prefill"], 20, 2),
              ("decode", c["batch"], 1, True, launches["wkv6_decode"], 50,
               10),
              ("prefill 32k", WKV_32K["B"], WKV_32K["T"], False,
               launches["wkv6_prefill"], 5, 1)]
    rows = []
    for what, B, T, given, n_launch, runs, plain_runs in shapes:
        r, k, v, w, u = _wkv_inputs(B, H, T, D, D, torch.bfloat16, 17)
        s0 = torch.randn((B, H, D, D), device="cuda") if given else None
        st = torch.empty((B, H, D, D), device="cuda")
        out_dtype = torch.float32 if given else None

        def kernel():
            return ops.wkv6(r, k, v, w, u, s0, state_out=st,
                            out_dtype=out_dtype)

        def plain():
            return ref.wkv6(r, k, v, w, u, s0, out_dtype=out_dtype)

        y, _ = kernel()
        t0 = time.perf_counter()
        y_p, st_p = plain()
        torch.cuda.synchronize()
        t_plain = time.perf_counter() - t0
        testing.assert_attention_close(y, y_p, not given,
                                       f"wkv6 at the {what} shape: y")
        testing.assert_close(st, st_p, f"wkv6 at the {what} shape: state")
        err = max(testing.max_abs_err(y, y_p), testing.max_abs_err(st, st_p))
        del y, y_p, st_p
        ms = cuda_ms(kernel, runs=runs)
        plain_ms = cuda_ms(plain, runs=plain_runs, warmup=0)
        b, by = wkv6_bound(B, H, T, D, D, 2, given, 4 if given else 2)
        log(f"wkv6 {what}: B={B} H={H} T={T} Dk=Dv={D}, bf16 r/k/v/u, fp32 "
            f"w, state {'in and out' if given else 'out'}; the check's "
            f"plain run {t_plain:.1f} s")
        rows.append({"name": f"wkv6 ({what})", "route": "cuda",
                     "source": "src/repro_torch/kernels/csrc/wkv6.cu",
                     "replaces": "src/repro/kernels/wkv6.py:69",
                     "launches": n_launch, "max_abs_err": err, "ms": ms,
                     "plain_ms": plain_ms, "bound_ms": b, "bound_by": by,
                     "library_ms": None})
        del r, k, v, w, u, s0, st
    torch.cuda.empty_cache()
    return rows


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a card")
    if torch.cuda.device_count() < 1:
        fail("no CUDA device")
    phase_setup()
    phase_kernels()
    phase_kernels_constrained()
    phase_kernels_rbf()
    phase_kernels_weighted()
    phase_kernels_attention()
    phase_kernels_wkv6()
    phase_lm_parity()
    serve = phase_lm_serve()
    attn_rows = times_attention(serve)
    phase_lm_parity(RWKV_ARCH)
    rwkv = phase_lm_serve(RWKV_ARCH)
    wkv_rows = times_wkv6(rwkv)
    scan = phase_scan()
    main_path = phase_main()
    constrained = phase_constrained(main_path)
    phase_active_set_parkinsons()
    active = phase_active_set_webscope(main_path)
    facility = phase_facility(main_path)
    weighted = phase_weighted(main_path)
    rows = phase_times(scan, main_path, constrained, active, facility,
                       weighted)
    rows += attn_rows + wkv_rows
    for r in attn_rows + wkv_rows:
        lib = ("no library call" if r["library_ms"] is None
               else f"SDPA {r['library_ms']:.4f} ms")
        log(f"time {r['name']}: {r['ms']:.4f} ms (plain {r['plain_ms']:.4f} "
            f"ms, {lib}, bound {r['bound_ms']:.4f} ms by {r['bound_by']}, "
            f"{r['bound_ms'] / r['ms']:.1%} of bound), launches "
            f"{r['launches']}")
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
