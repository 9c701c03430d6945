#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py      # every phase, one CUDA card

Phases, each failing the run (non-zero exit, no ``ok`` line) on any error:

1. setup — the card's name and power limit, torch's version, a digest of
   the port's sources, the kernels' build from
   ``src/repro_torch/kernels/csrc`` (one nvcc per source);
2. kernels — ``exemplar_gains`` and ``greedy_select`` against their plain
   PyTorch versions on the card, d ∈ {6, 17, 64, 3072}, ragged n and m,
   M ∈ {1, 7}, one M = 1 machine of more than 512 candidate tiles, and
   more (machine, tile) pairs than the persistent grid has CTAs (M = 7
   and 3 at d = 6, d = 17 and m = 1,100: CTAs that walk several tiles and
   cross machines, on the resident and the chunked layout);
   ``greedy_select`` under knapsack, partition and both (d ∈ {6, 17},
   M ∈ {1, 7}, G ∈ {1, 8}, budgets that bind); ``threshold_select``
   unconstrained and under knapsack ∩ partition at bn ∈ {16, 256}, ragged
   n and n < 256, mid-ladder state, a stop flag raised in an early block,
   M = 1 over more than 100 blocks, and the most partition groups a
   launch takes (one more raises); the HMMA instructions (the gain tile's
   TF32 products) in the SASS of the three libraries built on the tile;
   then the narrow instantiations of the three (bf16 rows, int8 rows with
   per-row scales that are not powers of two, the bf16 x·e contraction,
   and the two combined) at d ∈ {6, 17, 64}, M ∈ {1, 7}, one constrained
   and one weighted greedy, threshold levels at bn ∈ {16, 256}: each
   against its plain version, to the bits of the fp32 kernel on the rows
   it dequantizes to, and counted under its own launch counter;
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
   centralized selections against the plain constrained greedy; then
   streaming round 0 of the same deployment from phase 4's host array and
   plan, waves under a 256 MiB byte budget: fp32 with dense and with
   Feistel slots, each bit for bit as its resident TREE; bf16 and int8
   (q_block_rows 4,096) sources bit for bit as a resident TREE on their
   dequantized rows, their fp32 re-check / centralized ≥ 0.9;
   THRESHOLD-BATCH on bf16 with score_dtype = bfloat16, and on int8 under
   the knapsack ∩ partition with the attributes in the meta columns; the
   streaming centralized greedy (chunks of 2^20 rows) against phase 4's;
   score_dtype = bfloat16 on phase 3's block (fused and step-wise alike)
   and in a TREE (/ centralized ≥ 0.9); every wave's gather, H2D and
   solve seconds and bytes; then the round-0 engine on the same array,
   plan and budget: the pipelined fp32 TREE (2 wave buffers) bit for bit
   as the sync streaming run and the resident TREE, the same
   ``greedy_select`` launches, its overlap, buffer high-water mark,
   memory peak beside the sync run's, and round 0's wall beside the
   engine's (the set-up before the first wave; the slot permutation
   timed alone); fp32 and bf16 pipelined over 4 ingestion hosts as their
   sync runs (per-host rows summing to each wave's); 4 hosts under a
   ``FaultPolicy`` with transient faults (rate 0.2) and host 2 lost from
   wave 1, as the fault-free run with one lossless eviction; wave 1
   killed, as the resident TREE with its machines failed, with exactly
   their oracle calls fewer, within the dropped-fraction budget; async
   round checkpoints (deltas every 2 rounds) as the unchecked run, and a
   run stopped after its round-1 checkpoint and resumed, as the whole;
   then the wave autotuner and telemetry on the same array, plan and
   budget (ladder 1, 2, 4, …, 256, 497): a pipelined autotuned run with a
   ``Tracer``, an autotune cache and checkpoints, the same run seeded from
   the cache (traced, and untraced from the same seed), and a forced
   schedule of rungs and ragged widths inside a ``torch.profiler``
   session, each bit for bit as the sync fixed-width run, the autotuned
   widths rungs and no more distinct than ``shape_bound``, the Chrome
   trace and JSONL parsed (a gather, stage and solve span per wave) and
   giving the engine's overlap back to 1e-9, each manifest valid and its
   report printed; stochastic-greedy TREE (ε = 0.5, a sample of 312) and
   threshold-greedy TREE (ε = 0.5, 11 τ-levels), resident, each with
   round 0's first 8 machines on the card held against the plain gains on
   the card (the same draws; the near-tie and near-threshold rules) and
   to the algorithm's definition (k·s oracle calls a full machine; each
   threshold take within 1 − ε of the best gain left), and its value at
   least 0.9 of the centralized greedy's; RandGreedI at m = 2,000
   from the card's array and from a host source in chunks of 45
   machines, the two equal bit for bit;
6. other objectives — ActiveSetSelection (Parkinsons analog, Webscope),
   FacilityLocation and the weighted exemplar objective at Webscope;
   then selection serving at Webscope: ``serve.ingest`` of phase 4's host
   array and phase 5's attributes into 2,000 resident machines (sync
   engine, 256 MiB waves), 9 requests (k ∈ {50, 25} × {none,
   Knapsack(0.45k), PartitionMatroid(⌈k/4⌉ per group), a query row}, and
   THRESHOLD-BATCH at ε = 0.5) served cold, then warm through the
   CUDA-graph entries with the cold bits and no recapture, new budget and
   query on warm entries (replays, the offline bits), a ``Dispatcher``
   burst, each answer equal to ``offline_solve`` bit for bit, value /
   centralized ≥ 0.9 and the threshold gap ≤ ε, one warm tail's replay
   against its eager run, then 64 deletes and 64 inserts re-served
   through the partial re-solve, equal to the rebuilt session's answers
   (one re-ingest, round 0 replayed on the blocks restaged in place);
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
9. LM serving — Qwen3-8B at full width, 18 of its 36 layers
   (``LM_CUTS``, PR 26), through ``greedy_generate`` (8 prompts of 2,048
   tokens, 32 new), every
   attention launch counted (every prefill launch on the tensor-core
   route), the last decode step against ``forward``,
   prefill and decode times, memory peak and attention's share;
10. wkv6 kernels (run after phase 7) — ``wkv6`` against its plain
   version in fp32 and bf16: Dk = Dv ∈ {16, 64}, Dk ≠ Dv, ragged T, B × H
   = 1 and 256, strided views, a given state, T = 2,100, the strong decays
   0.5, 0.05, 1e-6 over 300 steps, chaining over parts of T, a decode step
   in place, the shapes it does not take; each case through the routed
   (recurrent) kernel and through the chunked one, which is held by the
   error model of ``testing.WKV_TERMS_RTOL`` (its elements outside the
   recurrent kernel's tolerance counted); the HMMA in the chunked
   kernel's SASS; every T = 1 call of ``ops.wkv6`` on the decode kernel
   (112 cases: fp32/bf16, D 16/64, Dk ≠ Dv, Dk = 40 with Dv = 72, u and y
   in both types, a given state in place) equal to the plain version and
   to the recurrent kernel with ``torch.equal``, counted under
   wkv6_decode, ptxas's registers and spills of the decode kernel; then
   the wkv6 backward against the plain version (``ref.wkv6_backward``,
   the recurrence's order of sums) in 65 cases, each on the route
   ``wkv6.bwd_route`` names (the model's states on the chunked kernel,
   ``csrc/wkv6_bwd_chunked.cu``; the rest on the recurrent one,
   ``csrc/wkv6_bwd.cu``), held to that route's launch counters: fp32
   and bf16, Dk = Dv ∈ {16, 64}, Jamba's 16 × 128 scan with u = 0, Dk ≠
   Dv both ways, B × H = 1 and 256, T = 1, T on and past either kernel's
   chunk boundary, ragged T and T = 2,100, every decay,
   strided views, from zeros and from S_0 with dS_T, dy in fp32; each to
   the bit where it agrees so (counted; the recurrent kernel), else
   within ``testing.WKV_GRAD_TOL``, a second call to the bit, at T ≤ 100
   also against autograd of ``ref.wkv6`` (and the recurrent kernel at
   the chunked cases' states to the bit); the shapes neither takes
   raise; ptxas's registers and spills of their instantiations; the HMMA
   in the chunked library's SASS;
11. RWKV parity — rwkv6-1.6b at full width and 2 layers, card against the
   CPU's plain path, as phase 8;
12. RWKV serving — rwkv6-1.6b at full width, 12 of its 24 layers
   (``LM_CUTS``, PR 26), as phase 9, every ``wkv6`` launch counted (12
   prefill on the recurrent kernel, 12 × 31 on the decode kernel);
   then phases 11 and 12 once more with every prefill call on the chunked
   kernel (three launches a call);
13. CLI (run after phase 6) — ``repro_torch.launch.submod.main`` on the
   card at its largest dataset (200,000 × 64, k = 50, μ = 200 = 0.1% of
   n), flag sets: resident GREEDY with the centralized and RandGreedI
   columns; chunked + pipelined over 2 hosts under 64 MiB, autotuned and
   traced; int8; knapsack ∩ partition; THRESHOLD-BATCH; transient faults;
   ``--serve-smoke``: each run's kernels counted, the streamed, pipelined,
   autotuned and fault-injected TREE lines byte for byte the resident
   run's, TREE / centralized ≥ 0.9, the THRESHOLD-BATCH gap ≤ ε, round
   0's greedy_select (resident, int8, intersection), exemplar_gains and
   threshold_select (THRESHOLD-BATCH) held against their plain versions
   on the run's own operands, the recheck PASS, feasibility OK; ``python -m
   repro_torch.launch.tracetool`` on the traced run (cross-check PASS);
   the three examples;
14. MoE (run after phase 9) — deepseek-moe-16b and olmoe-1b-7b at full
   width and 2 layers, card against the CPU's plain path as phase 8, the
   CPU's router held on the card's router input (a token whose experts
   differ must have its K-th and (K+1)-th logits within one bf16 ulp,
   ``testing.route_flips``) and the CPU run dispatching the card's
   experts; then
   deepseek-moe-16b at full width, 14 of its 28 layers (``LM_CUTS``, PR
   26; 64 routed experts + 2 shared, top 6, capacity factor 1.25) serving
   8 × 2,048 + 32 tokens as phase 9: 14 prefill launches on the
   tensor-core route and 14 × 31 decode launches, the share of assignments dropped per layer, the
   dispatch and combine products timed apart from the expert products,
   the last decode step against forward at a capacity factor under which
   nothing drops, forward's router held on the served run's router input
   and forward dispatching the served experts;
15. VLM, hybrid and encoder-decoder (run after phase 12) — each as
   phases 8 and 9: internvl2-76b at full width (2 layers against the
   CPU, 256 patch embeddings before a 256-token prompt; 8 of its 80
   layers serving 8 × (256 + 2,048) + 32, cache 2,080 + 256: 80 layers
   would be 141 GB of bf16); jamba-1.5-large-398b at full width, one
   period (7 Mamba layers, 1 attention, 4 MoE, 4 dense) with 4 of its 16
   experts top-2 (33 GB; 16 would be 91 GB), against the CPU on a
   128-token prompt, 4 new tokens, then serving 8 × 2,048 + 32 (1 + 31
   flash_attention launches, 7 prefill launches of the recurrent wkv6 and
   7 × 31 of the decode kernel, the last decode step against forward at
   a capacity factor with no drops, forward following the served
   routes); whisper-tiny whole, 1,500 frames, against the CPU and then
   serving 8 × 4 + 32 with cache 1,500 (12 prefill launches: encoder,
   self, cross; 8 × 31 decode launches, the cross ones under
   kv_valid_len = 1,500); their attention and Mamba-scan shapes held
   against plain in phases 7 and 10 and timed in phase 16;
16. times — each kernel at its path's shapes, held against its plain
   version there, timed beside it and beside its bound (fp32 FMA rate,
   TF32 or bf16 tensor-core rate, memory rate; ``wkv6`` the tensor-core
   bound with the fp32-only one beside it, its chunked kernel at both
   prefill shapes and both kernels by T), and ``flash_attention``
   beside PyTorch's ``scaled_dot_product_attention``; the gain tile
   against the plain gains on every round-0 machine after 0, 25 and 49
   plain greedy steps; one ``greedy_select`` call launching k kernels;
   ``rbf_kernel``'s update shapes on its row vector;
   the share of blocks the threshold pre-pass flags at each timed level;
   ``exemplar_gains`` at round 0's d_max pass (unweighted and weighted)
   and at one 2²⁰-row chunk of the streaming centralized greedy; the
   narrow instantiations at round 0 beside the fp32 kernel there; the
   ``wkv6`` decode kernel beside the recurrent kernel at T = 1;
17. training (run after phase 15) — the ``flash_attention`` backward
   (``csrc/flash_attention_bwd.cu``, run after phase 7) against autograd
   of the plain version: D ∈ {16, 64, 128, 256}, fp32 and bf16, groups
   1/4/8, causal S = T, the (T − S) offset, non-causal S ≠ T, ragged, the
   model's strided views, S = 1, the training shapes; each case twice to
   the bit and its launches counted; a train step on the card against the
   CPU's plain path (Qwen3-8B and rwkv6-1.6b at full width and 2 layers
   in bf16, rwkv6-1.6b's once more in fp32, the MoE, VLM,
   encoder-decoder, RWKV-6 and hybrid families at ``reduced()`` in fp32,
   the hybrid also at Jamba's 16 × 128 scan tile, there against the same
   step on the card with the plain backward within the fp32 bound and
   twice to the bit): loss, grad_norm, lr, every gradient (none
   missing), the update and moments, the wkv6 backward once a layer and
   microbatch on its route's kernels; whisper-tiny whole for a step;
   the training cell (Qwen3-8B at full width, 4 of 36 layers, 8 ×
   2,048 tokens in 8 microbatches, remat, bf16 moments): step time,
   tokens/s, share of the bf16 peak, memory peak, launches a step, a
   checkpoint every 2 steps and steps 3-4 resumed from step 2 equal to the
   uninterrupted run to the bit; ``python -m repro_torch.launch.train
   --reduced`` with checkpoints and ``--resume``; the select-then-train
   example at its defaults; the launcher on RWKV-6 ``--reduced`` for 10
   steps; the RWKV-6 training cell (rwkv6-1.6b whole, 24 layers, 8 ×
   2,048 tokens in 2 microbatches, remat, bf16 moments): step time,
   tokens/s, share of the bf16 peak, memory peak, launches a step; the
   attention backward timed at the training shapes beside its bound, its
   plain version and SDPA's backward, and the wkv6 backward at
   rwkv6-1.6b's training microbatch and Jamba's scan, on both routes,
   beside its bound and plain version.

Ends with one JSON line per kernel table and the ``ok`` line.  Imports
nothing of the JAX package.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import math
import os
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
# stochastic- and threshold-greedy TREE / centralized greedy: 0.984 and
# 0.973 at Webscope on an H100 80GB HBM3 at 700 W, far above the
# guarantee 1 − 1/e − ε = 0.132, which near-random picks would pass
ALG_FLOOR = 0.9
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
# jamba-1.5-large-398b's parity runs one whole period, 8 layers (7 Mamba,
# 4 MoE), where the others run 2: card against CPU measured 0.134765625
# (max over 4 steps; the same twice), and each bf16 evaluation alone sits
# 0.157 (card) and 0.189 (CPU) from the fp32 evaluation of the same
# weights (chip_smoke.lm_drift; H100 80GB HBM3, 700 W): the card computes
# the model as closely as the CPU's plain path does, and LM_PARITY_TOL is
# below the model's own bf16 rounding at this depth.  The bound is
# LM_SERVE_TOL's, that of the other comparison of two bf16 paths through
# a deep model
HYBRID_PARITY_TOL = LM_SERVE_TOL


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


_T0 = time.perf_counter()


def log(msg: str) -> None:
    """``msg`` on stdout after the run's elapsed seconds, so that a log
    shows where the time goes inside a phase."""
    print(f"[{time.perf_counter() - _T0:7.1f}] {msg}", flush=True)


def eval_rows(data, n_eval: int):
    """The eval subsample, drawn as the repo's benchmarks draw it."""
    import numpy as np
    r = np.random.default_rng(0)
    return data[r.choice(len(data), min(n_eval, len(data)), replace=False)]


def cuda_ms(fn, runs: int, warmup: int = 1) -> float:
    """Median device milliseconds of ``runs`` calls, timed with CUDA events
    behind a device sleep (:func:`repro_torch.timing.device_ms`)."""
    from repro_torch.timing import device_ms
    return device_ms(fn, runs, warmup)


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
    print(smi.stdout.strip().splitlines()[0], flush=True)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")
    with open("/proc/meminfo") as f:
        log(f"host: {os.cpu_count()} CPUs, "
            f"{next(line for line in f if line.startswith('MemTotal'))}"
            .strip())
    digest = hashlib.sha256()
    for f in sorted([ROOT / Path(__file__).name,
                     *(ROOT / "src" / "repro_torch").rglob("*.py"),
                     *(ROOT / "src" / "repro_torch").rglob("*.cu*")]):
        digest.update(f.relative_to(ROOT).as_posix().encode())
        digest.update(f.read_bytes())
    log(f"source digest (chip_smoke.py + src/repro_torch): "
        f"{digest.hexdigest()[:16]}")
    t = _build.build_all()
    log(f"kernel build: {t:.2f} s ({', '.join(_build.SOURCES)}); seconds "
        f"to each library's end: " + ", ".join(
            f"{k} {v:.1f}" for k, v in _build.build_seconds.items()))
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
    # more (machine, tile) pairs than the persistent grid has CTAs, with
    # ragged machines: CTAs that walk several tiles and cross machines, on
    # the resident layout and on the chunked one (d = 17; mp = 1,152)
    cases += [(7, 20_011, 300, 6, 5), (7, 30_011, 130, 17, 5),
              (3, 30_011, 1100, 6, 3)]
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
    machine axis on either operand or both, in both instantiations (the
    row vector for n ≤ 4 at ragged m around its 1,024-row span, the tile
    above), each case's instantiation held against the launch counts;
    K(x, x) within [1 − tol, 1] in both."""
    import numpy as np
    import torch
    from repro_torch import testing
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import rbf_kernel as rbf_mod
    tol = testing.ATOL + testing.RTOL
    cases = [(Mx, My, n, m, d) for d, n, m in ((1, 37, 300), (6, 33, 129),
                                                (22, 70, 1000),
                                                (64, 129, 77))
             for Mx, My in ((1, 1), (3, 1), (1, 3), (3, 3))]
    cases += [(Mx, 3, n, m, d) for d in (6, 22) for n in (1, 2, 3, 5)
              for m in (1023, 1025, 2100) for Mx in (1, 3)]
    worst = 0.0
    routes = {True: 0, False: 0}
    for Mx, My, n, m, d in cases:
        r = np.random.default_rng(n * d + Mx)
        X = torch.as_tensor(r.standard_normal((Mx, n, d)) / np.sqrt(d),
                            dtype=torch.float32, device="cuda")
        Y = torch.as_tensor(r.standard_normal((My, m, d)) / np.sqrt(d),
                            dtype=torch.float32, device="cuda")
        vec = rbf_mod.rowvec(n, d)
        routes[vec] += 1
        for h in (0.5, 1.0):
            ops.reset_launch_counts()
            K = ops.rbf_kernel(X, Y, h)
            torch.cuda.synchronize()
            if ops.launch_counts["rbf_kernel_rowvec"] != int(vec):
                fail(f"rbf_kernel n={n} d={d}: the row vector launched "
                     f"{ops.launch_counts['rbf_kernel_rowvec']} times, the "
                     f"rule says {int(vec)}")
            K_p = ref.rbf_kernel(X, Y, h)
            testing.assert_close(K, K_p, f"rbf_kernel Mx={Mx} My={My} n={n} "
                                 f"m={m} d={d} h={h}")
            worst = max(worst, testing.max_abs_err(K, K_p))
            # K(x, x): the tile on Y against itself, and (the row vector
            # where n <= 4) Y's first rows against Y
            for Kd in (ops.rbf_kernel(Y, Y, h),
                       ops.rbf_kernel(Y[:, :min(n, m)], Y, h)):
                Kxx = torch.diagonal(Kd, dim1=-2, dim2=-1)
                if not bool(torch.all((Kxx >= 1 - tol) & (Kxx <= 1))):
                    fail(f"rbf_kernel K(x, x) outside [1 - {tol}, 1] at "
                         f"n={n} d={d} h={h}: {float(Kxx.min())}")
    log(f"rbf_kernel vs plain: {len(cases) * 2} shapes agree within rtol="
        f"{testing.RTOL} atol={testing.ATOL} (max |dK| {worst:.3g}); "
        f"{routes[True]} cases on the row vector, {routes[False]} on the "
        f"tile; K(x, x) in [1 - {tol:g}, 1]")


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


def fold_cur_min(X, E, cm_in, acc, kmax: int, cd=None):
    """The plain fold of each machine's own accept set (at most ``kmax``
    rows) into ``cm_in``: the contraction-form distances' row-min (x·e in
    bf16 where ``cd`` says so, as the kernels fold)."""
    import torch
    from repro_torch.kernels import ref
    idx = torch.argsort(acc.to(torch.int8), dim=1, descending=True,
                        stable=True)[:, :kmax]
    ok = torch.take_along_dim(acc, idx, dim=1)
    d2 = ref._sqdist(torch.take_along_dim(X, idx[..., None], dim=1), E, cd)
    d2 = torch.where(ok[..., None], d2, torch.full_like(d2, float("inf")))
    return torch.minimum(cm_in, torch.amin(d2, dim=1))


def check_threshold(acc, cm, trace, X, E, cm_in, tau, avail, kmax, limit,
                    what: str, cd=None, terms=None) -> tuple[int, int, float]:
    """threshold_select's output against the plain trace under the
    near-threshold rule; every machine's cur_min against the plain fold of
    its own accept set, within RTOL / ATOL, or where ``terms`` (M, m) are
    given within ``testing.assert_within_terms`` of them (the magnitude
    of the summands of the contraction-form distances: |x|² + |e|² of a
    row and an eval column cancel to near 0 where the row is the eval
    point, and round at that magnitude).  Returns (machines matching in
    full, near rows, max |Δ cur_min|)."""
    import torch
    from repro_torch import testing
    acc_p, cm_p, gains, load = trace
    ok, full, near = testing.accepts_agree(acc, acc_p, gains, tau, load=load,
                                           limit=limit, avail=avail)
    if not ok:
        fail(f"{what}: accept set differs from the plain version before any "
             f"near-threshold or near-budget row")

    def held(a, b, t, msg):
        if terms is None:
            testing.assert_close(a, b, msg)
        else:
            testing.assert_within_terms(a, b, t, what=msg)

    want = fold_cur_min(X, E, cm_in, acc, kmax, cd)
    held(cm, want, terms, f"{what}: cur_min, every machine")
    same = torch.all(acc == acc_p, dim=-1)
    held(cm[same], cm_p[same], None if terms is None else terms[same],
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


#: the narrow instantiations of the gain-tile kernels: (rows, bf16 dot)
NARROW = (("bf16", False), ("q8", False), ("fp32", True), ("bf16", True),
          ("q8", True))


def narrow_rows(T, rows: str, dot: bool, seed: int):
    """``T`` (M, n, d) fp32 as the operand of one instantiation: bf16 rows,
    int8 rows with per-row scales that are not powers of two (the span /
    254 times U(1, 1.3)) and zero-points at the midrange, or the fp32 rows;
    the kwargs of the kernels (``compute_dtype`` for the bf16 dot), and the
    fp32 rows the kernels dequantize them to.  Returns (X, kwargs, fp32
    rows, launch counters the instantiation adds to)."""
    import numpy as np
    import torch
    from repro_torch.kernels import ref
    kw = {}
    X = T
    if rows == "bf16":
        X = T.bfloat16()
    elif rows == "q8":
        lo, hi = T.amin(dim=-1), T.amax(dim=-1)
        stretch = torch.as_tensor(
            np.random.default_rng(seed).uniform(1.0, 1.3, tuple(lo.shape)),
            dtype=torch.float32, device=T.device)
        scale = torch.clamp_min(hi - lo, 1e-3) / 254.0 * stretch
        zp = (lo + hi) * 0.5
        if bool(torch.all(torch.frexp(scale).mantissa == 0.5)):
            fail("narrow_rows: every scale is a power of two")
        X = torch.clamp(torch.round((T - zp[..., None]) / scale[..., None]),
                        -127, 127).to(torch.int8)
        kw.update(x_scale=scale, x_zp=zp)
    if dot:
        kw["compute_dtype"] = torch.bfloat16
    deq = ref.dequantize_rows(X, kw.get("x_scale"), kw.get("x_zp"))
    counters = ([] if rows == "fp32" else [f"_{rows}"]) + (
        ["_bf16dot"] if dot else [])
    return X, kw, deq, counters


def narrow_name(rows: str, dot: bool) -> str:
    return rows + ("+bf16dot" if dot else "")


def counted(fn, expect: dict):
    """``fn()`` with the launch counts zeroed before it; fails unless each
    counter of ``expect`` reads its value after it."""
    import torch
    from repro_torch.kernels import ops
    ops.reset_launch_counts()
    out = fn()
    torch.cuda.synchronize()
    for name, want in expect.items():
        if ops.launch_counts[name] != want:
            fail(f"{name}: {ops.launch_counts[name]} launches, {want} "
                 f"expected")
    return out


def phase_kernels_narrow() -> None:
    """The narrow instantiations of exemplar_gains, greedy_select and
    threshold_select (bf16 rows, int8 rows with per-row scale and
    zero-point, the bf16 x·e contraction, and the two combined) against
    their plain versions at ragged shapes, d ∈ {6, 17, 64} (int8 and bf16
    machine bases that are not 4-byte aligned at d = 17), M ∈ {1, 7}, one
    constrained and one weighted greedy, threshold levels at bn ∈ {16, 256}
    in mid-ladder state; each launch counted under its instantiation; and
    each held to the bits of the fp32 kernel on the rows it dequantizes
    to."""
    import numpy as np
    import torch
    from repro_torch import testing
    from repro_torch.core.algorithms import _fused_constraint_kwargs
    from repro_torch.kernels import ops, ref
    k = 10
    cons = webscope_constraint(k)
    cases = [(M, n, m, d, "none") for d, n, m in ((6, 1000, 300),
                                                   (17, 777, 130),
                                                   (64, 501, 99))
             for M in (1, 7)]
    cases += [(7, 1000, 300, 6, "both"), (7, 777, 130, 17, "weighted")]
    ties = n_inst = 0
    for M, n, m, d, kind in cases:
        X32 = _dataset(d, M * n + m, seed=700 + d)
        E = torch.as_tensor(X32[M * n:], device="cuda")
        T = torch.as_tensor(X32[:M * n].reshape(M, n, d), device="cuda")
        mask = torch.as_tensor(
            np.random.default_rng(d * M + 7).random((M, n)) < 0.85,
            device="cuda")
        a = torch.as_tensor(make_attrs(M * n, seed=d + M + 7).reshape(
            M, n, 2), device="cuda")
        ckw = _fused_constraint_kwargs(cons, a) if kind == "both" else {}
        if kind == "weighted":
            ckw = {"eval_weights": eval_weights(m, seed=m + 7)}
        e0 = torch.sum(E * E, dim=-1)
        for rows, dot in NARROW:
            X, kw, deq, ctr = narrow_rows(T, rows, dot, seed=n + d + M)
            cd = kw.get("compute_dtype")
            what = (f"{narrow_name(rows, dot)} M={M} n={n} m={m} d={d} "
                    f"{kind}")
            trace = ref.greedy_select_trace(X, E, e0, mask, k, **kw, **ckw)
            ew = ckw.get("eval_weights")
            for cm in (e0, trace[1]):
                g = counted(lambda: ops.exemplar_gains(
                    X, E, cm, eval_weights=ew, **kw),
                    {f"exemplar_gains{c}": 1 for c in ctr})
                testing.assert_close(g, ref.exemplar_gains(
                    X, E, cm, eval_weights=ew, **kw),
                    f"exemplar_gains {what}")
                if not torch.equal(g, ops.exemplar_gains(
                        deq, E, cm, eval_weights=ew, compute_dtype=cd)):
                    fail(f"exemplar_gains {what}: differs from the fp32 "
                         f"kernel on the dequantized rows")
            sel, cm_out = counted(
                lambda: ops.greedy_select(X, E, e0, mask, k, **kw, **ckw),
                {f"greedy_select{c}": k for c in ctr})
            n_tie, same, err = check_greedy(sel, cm_out, deq, E, e0, trace,
                                            f"greedy_select {what}")
            s32, c32 = ops.greedy_select(deq, E, e0, mask, k,
                                         compute_dtype=cd, **ckw)
            if not (torch.equal(sel, s32) and torch.equal(cm_out, c32)):
                fail(f"greedy_select {what}: differs from the fp32 kernel "
                     f"on the dequantized rows")
            ties += n_tie
            n_inst += 1
            log(f"  narrow {what} k={k}: gains, sel, cur_min agree ({same}/"
                f"{M} machines select as plain, max|dcm| {err:.3g}, near-tie "
                f"steps {n_tie}); the fp32 kernel's bits on the dequantized "
                f"rows; launches counted under {ctr}")
    log(f"narrow exemplar_gains / greedy_select vs plain: {n_inst} cases "
        f"agree; near-tie steps {ties}")

    k = 12
    cons = webscope_constraint(k)
    tcases = [(3, 1000, 300, 6, 256, True, "q8", False),
              (3, 1000, 300, 6, 16, True, "fp32", True),
              (7, 777, 130, 17, 16, False, "bf16", False),
              (7, 201, 130, 17, 256, False, "q8", True),
              (2, 5_003, 64, 6, 16, True, "bf16", True),
              (1, 2_001, 99, 64, 256, False, "q8", False),
              (1, 30_000, 300, 6, 256, True, "bf16", False)]
    full_all = m_all = 0
    for M, n, m, d, bn, constrained, rows, dot in tcases:
        X32 = _dataset(d, M * n + m, seed=800 + d)
        E = torch.as_tensor(X32[M * n:], device="cuda")
        T = torch.as_tensor(X32[:M * n].reshape(M, n, d), device="cuda")
        r = np.random.default_rng(n + bn + 8)
        mask = torch.as_tensor(r.random((M, n)) < 0.85, device="cuda")
        a = torch.as_tensor(make_attrs(M * n, seed=n + 8).reshape(M, n, 2),
                            device="cuda")
        ckw = _fused_constraint_kwargs(cons, a) if constrained else {}
        limit = ref.knapsack_limit(ckw["budget"]) if constrained else None
        X, kw, deq, ctr = narrow_rows(T, rows, dot, seed=n + d)
        cd = kw.get("compute_dtype")
        e0 = torch.sum(E * E, dim=-1)
        cm_in = (e0 * torch.as_tensor(0.6 + 0.4 * r.random((M, m)),
                                      dtype=torch.float32, device="cuda"))
        g = ref.exemplar_gains(X, E, cm_in, **kw)
        tau = g.masked_fill(~mask, 0.0).amax(dim=1) * 0.4
        st = {"count": torch.full((M,), 3, dtype=torch.int32, device="cuda")}
        if constrained:
            st["used"] = torch.full((M,), 0.2 * limit, device="cuda")
            st["counts"] = torch.as_tensor(r.integers(0, 2, (M, N_GROUPS)),
                                           dtype=torch.int32, device="cuda")
        acc, cm = counted(lambda: ops.threshold_select(
            X, E, cm_in, mask, tau, k, bn=bn, **kw, **st, **ckw),
            {f"threshold_select{c}": 1 for c in ctr})
        trace = ref.threshold_select_trace(X, E, cm_in, mask, tau, k,
                                           bn=min(bn, max(8, n)), **kw, **st,
                                           **ckw)
        what = (f"threshold_select {narrow_name(rows, dot)} "
                f"{'knapsack ∩ partition' if constrained else 'unconstrained'}"
                f" M={M} n={n} m={m} d={d} bn={bn}")
        full, near, _ = check_threshold(acc, cm, trace, deq, E, cm_in, tau,
                                        mask, k, limit, what, cd)
        a32, c32 = ops.threshold_select(deq, E, cm_in, mask, tau, k, bn=bn,
                                        compute_dtype=cd, **st, **ckw)
        if not (torch.equal(acc, a32) and torch.equal(cm, c32)):
            fail(f"{what}: differs from the fp32 kernel on the dequantized "
                 f"rows")
        full_all, m_all = full_all + full, m_all + M
        log(f"  {what}: {full}/{M} machines accept as plain, "
            f"{int(acc.sum())} rows accepted, near rows {near}; the fp32 "
            f"kernel's bits on the dequantized rows")
    if full_all < FULL_SHARE * m_all:
        fail(f"narrow threshold_select: only {full_all}/{m_all} machines "
             f"compared in full")
    log(f"narrow threshold_select vs plain: {len(tcases)} shapes agree under "
        f"the near-threshold rule, {full_all}/{m_all} machines in full")


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
            runs["unconstrained"].get("threshold_select", 0),
        "exemplar_gains_threshold": sum(
            cnt.get("exemplar_gains", 0) for cnt in runs.values())}}


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
    # the plain version is timed once, by the run its check makes
    trace, plain = timed_once(lambda: ref.greedy_select_trace(
        blocks, E, seed, bmask, k, **kw))
    log(f"plain constrained greedy at round 0 (M={M}): "
        f"{plain / 1e3:.1f} s")
    n_tie, same, err = check_greedy(sel, cm_out, blocks, E, seed, trace,
                                    "constrained greedy_select at round 0")
    log(f"constrained greedy_select round 0 vs plain: {same}/{M} machines "
        f"select as plain, near-tie steps {n_tie}, max|dcm| {err:.3g}, "
        f"{int((sel >= 0).sum())} of {M * k} slots filled")
    ms = cuda_ms(lambda: ops.greedy_select(blocks, E, seed, bmask, k, **kw),
                 runs=3)
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
            trace, plain_ms = timed_once(lambda: ref.threshold_select_trace(
                blocks, E, seed, bmask, tau, k, **lkw))
            if lkw and level == 0:    # the timed level's plain version
                plain = plain_ms
            what = f"threshold_select {label} at round 0, level {level}"
            full, near, err = check_threshold(acc, cm, trace, blocks, E,
                                              seed.expand(M, m), tau, bmask,
                                              k, lim, what)
            errs.append(err)
            log(f"{what} vs plain: {full}/{M} machines accept as plain, "
                f"near rows {near}, {int(acc.sum())} rows accepted (plain "
                f"{plain_ms / 1e3:.1f} s)")
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
    log(f"main path data: webscope n={n} d={d} ({X.numel() * 4 / 1e9:.2f} GB "
        f"on the card, the host array kept for the streaming phase) in "
        f"{time.perf_counter() - t0:.1f} s")
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
    return {"X": X, "host": data, "obj": obj, "cfg": cfg, "launches": counts,
            "cent_value": cent_value, "tree": tree, "cent": cent,
            "plain_trace": (sel_p, gap, best)}


# the streaming phase's device-byte budget of a round-0 wave
STREAM_BYTES = 256 << 20
# q_block_rows of the int8 source (its block affine's grid)
Q_BLOCK_ROWS = 4096
# the engine phase's fault injector seed: at a rate of 0.2 its transient
# draws fire on waves 0 and 4 of the 5 fp32 waves (seed 0's fire on none)
FAULT_SEED = 2


def same_tree(name: str, res, ref) -> None:
    """Fail unless two TREE results agree bit for bit: rows, mask, value,
    oracle calls, rounds, machines per round and depth per round."""
    import numpy as np
    diffs = [what for what, ok in (
        ("rows", np.array_equal(res.sel_rows, ref.sel_rows)),
        ("mask", np.array_equal(res.sel_mask, ref.sel_mask)),
        ("value", res.value == ref.value),
        ("oracle calls", res.oracle_calls == ref.oracle_calls),
        ("rounds", res.rounds == ref.rounds),
        ("machines per round",
         res.machines_per_round == ref.machines_per_round),
        ("depth per round", res.depth_per_round == ref.depth_per_round))
        if not ok]
    if diffs:
        fail(f"{name}: {', '.join(diffs)} differ from the resident run "
             f"(value {res.value!r} vs {ref.value!r}, calls "
             f"{res.oracle_calls} vs {ref.oracle_calls})")


def run_stream(name: str, obj, source, cfg, kernels, W: int, waves: int,
               constraint=None, attrs=None):
    """One streaming TREE on the card from a host source, launches counted
    from zero; fails unless each kernel of ``kernels`` launched, W and the
    wave count are as stated and no wave passed ``cfg.capacity_bytes``.
    Logs each wave's gather, H2D and solve seconds and bytes."""
    import torch
    from repro_torch.core import TorchPlan, tree_maximize
    from repro_torch.kernels import ops
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    res = tree_maximize(obj, source, cfg, device="cuda", plan=TorchPlan(SEED),
                        constraint=constraint, attrs=attrs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {key: v for key, v in ops.launch_counts.items() if v}
    for kern in kernels:
        if counts.get(kern, 0) == 0:
            fail(f"{name} launched {kern} no time")
    st = res.ingest
    if st is None or st.wave_machines != W or st.waves != waves:
        fail(f"{name}: W = {None if st is None else st.wave_machines}, "
             f"{None if st is None else st.waves} waves; expected W = {W}, "
             f"{waves} waves")
    if st.peak_wave_bytes > cfg.capacity_bytes:
        fail(f"{name}: a wave took {st.peak_wave_bytes} bytes, over "
             f"{cfg.capacity_bytes}")
    check_coreset(name, constraint, res.sel_attrs, res.sel_mask)
    log(f"{name}: W = {st.wave_machines}, {st.waves} waves, peak wave "
        f"{st.peak_wave_bytes} B of {cfg.capacity_bytes}, {st.total_bytes} B "
        f"moved; rounds {res.rounds}, machines/round "
        f"{res.machines_per_round}, depth/round {res.depth_per_round}, "
        f"oracle calls {res.oracle_calls}, value {res.value!r}; round walls "
        f"{res.round_walls}; whole run {wall:.3f} s; launches {counts}")
    for t in st.traces:
        log(f"  {name} wave {t.wave}: {t.machines} machines, gather "
            f"{t.gather_s:.4f} s, H2D {t.h2d_s:.4f} s, solve {t.solve_s:.4f} "
            f"s, {t.bytes_moved} B")
    return res, counts


def resident_on(name: str, obj, rows, cfg, constraint=None, attrs=None):
    """A resident TREE on the card over host ``rows`` (a source's
    dequantized rows), the card's copy freed after."""
    import torch
    from repro_torch.core import TorchPlan, tree_maximize
    X = torch.as_tensor(rows, device="cuda")
    res = tree_maximize(obj, X, cfg, device="cuda", plan=TorchPlan(SEED),
                        constraint=constraint, attrs=attrs)
    del X
    torch.cuda.empty_cache()
    log(f"{name} (resident): value {res.value!r}, round walls "
        f"{res.round_walls}")
    return res


def phase_streaming(scan: dict, main: dict, constrained: dict) -> dict:
    """Streaming round 0 at the Webscope deployment on phase 4's host array
    and plan, under a 256 MiB wave budget: fp32 (dense and Feistel slots)
    bit for bit as the resident TREE; bf16 and int8 bit for bit as a
    resident TREE on their dequantized rows, with their fp32 re-check
    within 0.9 of the centralized value; THRESHOLD-BATCH on int8 under
    phase 5's knapsack ∩ partition (the attributes in the meta columns);
    the streaming centralized greedy; and score_dtype = bfloat16 on phase
    3's block and in a TREE."""
    import numpy as np
    import torch
    from repro_torch import testing
    from repro_torch.core import (ArraySource, ExemplarClustering,
                                  QuantizedSource, TreeConfig,
                                  streaming_centralized_greedy)
    from repro_torch.core.algorithms import run_algorithm
    from repro_torch.data.selection import fp32_recheck
    from repro_torch.kernels import ops, ref
    host, obj, cfg = main["host"], main["obj"], main["cfg"]
    k, mu = cfg.k, cfg.capacity
    L = main["tree"].machines_per_round[0]
    out = {"walls": {"resident": main["tree"].round_walls[0]}, "waves": {}}

    def wave_count(W):
        return -(-L // W)

    scfg = dataclasses.replace(cfg, capacity_bytes=STREAM_BYTES)
    src = ArraySource(host)
    W = STREAM_BYTES // (mu * 6 * 4)
    torch.cuda.reset_peak_memory_stats()
    res, cnt = run_stream("streaming TREE, fp32", obj, src, scfg,
                          ("greedy_select",), W, wave_count(W))
    out["peak_mem"] = torch.cuda.max_memory_allocated()
    same_tree("streaming TREE, fp32", res, main["tree"])
    out["result"] = {"fp32": res}
    out["walls"]["fp32"], out["waves"]["fp32"] = res.round_walls[0], res.ingest
    out["launches"] = {"fp32": cnt}

    fcfg = dataclasses.replace(cfg, permutation="feistel")
    feistel_res = resident_on("TREE, Feistel slots", obj, host, fcfg)
    res, _ = run_stream("streaming TREE, fp32, Feistel slots", obj, src,
                        dataclasses.replace(fcfg,
                                            capacity_bytes=STREAM_BYTES),
                        ("greedy_select",), W, wave_count(W))
    same_tree("streaming TREE, Feistel slots", res, feistel_res)

    quant = {}
    for store, itemsize, meta in (("bf16", 2, 0), ("int8", 1, 2)):
        t0 = time.perf_counter()
        q = QuantizedSource(src, store, Q_BLOCK_ROWS)
        deq = q.dequantized()
        log(f"{store} source: parameters and dequantized rows "
            f"{time.perf_counter() - t0:.1f} s")
        W = STREAM_BYTES // (mu * (6 * itemsize + 4 * meta))
        tag = "q8" if store == "int8" else store
        res, cnt = run_stream(f"streaming TREE, {store}", obj, q, scfg,
                              (f"greedy_select_{tag}",), W, wave_count(W))
        same_tree(f"streaming TREE, {store}",
                  res, resident_on(f"TREE on the {store} source's "
                                   f"dequantized rows", obj, deq, cfg))
        re = fp32_recheck(obj, q, res.sel_rows, res.sel_mask, res.value)
        ratio = re.value / main["cent_value"]
        log(f"streaming TREE, {store}: fp32 re-check {re.value!r} (solve "
            f"{re.solve_value!r}), / centralized {ratio!r}")
        if ratio < 0.9:
            fail(f"{store} fp32 re-check / centralized {ratio} below 0.9")
        out["walls"][store], out["waves"][store] = (res.round_walls[0],
                                                    res.ingest)
        out["launches"][store] = cnt
        out["result"][store] = res
        quant[store] = (q, deq)

    # THRESHOLD-BATCH on bf16 rows with the bf16 x·e contraction
    q, deq = quant["bf16"]
    obj_b = ExemplarClustering(obj.eval_set, score_dtype="bfloat16")
    tcfg = dataclasses.replace(cfg, algorithm="threshold_batch", eps=EPS)
    W = STREAM_BYTES // (mu * 6 * 2)
    res, cnt = run_stream(
        "streaming THRESHOLD-BATCH TREE, bf16, score_dtype bfloat16", obj_b,
        q, dataclasses.replace(tcfg, capacity_bytes=STREAM_BYTES),
        ("threshold_select_bf16", "threshold_select_bf16dot",
         "exemplar_gains_bf16", "exemplar_gains_bf16dot"), W, wave_count(W))
    same_tree("streaming THRESHOLD-BATCH TREE, bf16, score_dtype", res,
              resident_on("THRESHOLD-BATCH TREE on the bf16 source's "
                          "dequantized rows, score_dtype bfloat16", obj_b,
                          deq, tcfg))
    out["launches"]["bf16 threshold"] = cnt

    # THRESHOLD-BATCH on int8 with phase 5's attributes in the meta columns
    q, deq = quant["int8"]
    attrs, cons = constrained["attrs"], constrained["cons"]
    W = STREAM_BYTES // (mu * (6 + 4 * 4))
    res, cnt = run_stream("streaming THRESHOLD-BATCH TREE, int8, knapsack ∩ "
                          "partition", obj, q,
                          dataclasses.replace(tcfg,
                                              capacity_bytes=STREAM_BYTES),
                          ("threshold_select_q8", "exemplar_gains_q8"), W,
                          wave_count(W), constraint=cons, attrs=attrs)
    same_tree("streaming THRESHOLD-BATCH TREE, int8, constrained", res,
              resident_on("THRESHOLD-BATCH TREE on the int8 source's "
                          "dequantized rows, constrained", obj, deq, tcfg,
                          constraint=cons, attrs=attrs))
    ladder = 1 + math.ceil(math.log(2 * k / EPS) / EPS)
    if max(res.depth_per_round) > ladder:
        fail(f"streaming THRESHOLD-BATCH depth {res.depth_per_round} past "
             f"1 + ⌈log(2k/ε)/ε⌉ = {ladder}")
    out["launches"]["int8 threshold"] = cnt
    del quant, deq

    # streaming centralized greedy over the fp32 source, chunks of 2^20
    t0 = time.perf_counter()
    ops.reset_launch_counts()
    sc = streaming_centralized_greedy(obj, src, k, chunk_rows=1 << 20,
                                      device="cuda")
    sc_value = float(sc.value)
    sc_wall = time.perf_counter() - t0
    cent = main["cent"]
    same = torch.all(sc.sel_rows == cent.sel_rows, dim=-1) & sc.sel_mask
    sel_p, gap, best = main["plain_trace"]
    rows_p = main["X"][torch.clamp_min(sel_p, 0)]
    as_plain = torch.where(sel_p >= 0, torch.all(sc.sel_rows == rows_p,
                                                 dim=-1) & sc.sel_mask,
                           ~sc.sel_mask)
    ok, n_tie = testing.selections_agree(torch.where(as_plain, sel_p, -2),
                                         sel_p, gap, best)
    if not ok:
        fail("streaming centralized greedy selects apart from the plain "
             "greedy before any near tie")
    ok, _ = testing.selections_agree(torch.where(same, sel_p, -2), sel_p,
                                     gap, best)
    if not ok:
        fail("streaming centralized greedy selects apart from the resident "
             "one before any near tie of the plain greedy")
    testing.assert_close(sc_value, main["cent_value"],
                         "streaming centralized value")
    log(f"streaming centralized greedy (chunks of 2^20 rows): {int(same.sum())}"
        f"/{k} steps select the resident centralized row, value {sc_value!r} "
        f"(resident {main['cent_value']!r}), near-tie steps {n_tie}, wall "
        f"{sc_wall:.3f} s, launches "
        f"{ {key: v for key, v in ops.launch_counts.items() if v} }")
    out["central_launches"] = dict(ops.launch_counts)

    # score_dtype = bfloat16: the phase 3 block, fused and step-wise
    T = scan["T"]
    mask = torch.ones((T.shape[0],), dtype=torch.bool, device="cuda")
    ops.reset_launch_counts()
    step = run_algorithm("greedy", obj_b, T, mask, k, fused=False)
    fused = run_algorithm("greedy", obj_b, T, mask, k)
    torch.cuda.synchronize()
    if (ops.launch_counts["exemplar_gains_bf16dot"] != k
            or ops.launch_counts["greedy_select_bf16dot"] != k):
        fail(f"score_dtype: launches {dict(ops.launch_counts)}")
    out["launches"]["score_dtype scan"] = {
        key: v for key, v in ops.launch_counts.items() if v}
    seed = torch.sum(obj.eval_set ** 2, dim=-1)
    _, _, gap, best = ref.greedy_select_trace(
        T, obj.eval_set, seed, mask, k, compute_dtype=torch.bfloat16)
    ok, n_tie = testing.selections_agree(step.sel_idx, fused.sel_idx, gap,
                                         best)
    if not ok:
        fail("score_dtype: the step-wise and fused paths select apart "
             "before any near tie")
    testing.assert_close(step.value, fused.value, "score_dtype values")
    log(f"score_dtype bfloat16, {T.shape[0]}-row block: step-wise and fused "
        f"select alike ({int((step.sel_idx == fused.sel_idx).sum())}/{k} "
        f"steps, near-tie steps {n_tie}), value {float(fused.value)!r}")
    tree_b, cnt = run_tree("TREE, score_dtype bfloat16", obj_b, main["X"],
                           cfg, ("greedy_select_bf16dot",))
    ratio = tree_b.value / main["cent_value"]
    log(f"TREE with score_dtype bfloat16 / centralized: {ratio!r}")
    if ratio < 0.9:
        fail(f"score_dtype TREE/centralized ratio {ratio} below 0.9")
    out["launches"]["score_dtype"] = cnt
    summary = {store: {"round0_wall_s": out["walls"][store],
                       "waves": st.waves, "wave_machines": st.wave_machines,
                       "bytes": st.total_bytes,
                       "gather_s": [t.gather_s for t in st.traces],
                       "h2d_s": [t.h2d_s for t in st.traces],
                       "solve_s": [t.solve_s for t in st.traces]}
               for store, st in out["waves"].items()}
    summary["resident_round0_wall_s"] = out["walls"]["resident"]
    log("streaming round 0 by dtype: " + json.dumps(summary))
    return out


def run_engine(name: str, obj, source, cfg, kernels, **kw):
    """One streaming TREE through the round-0 engine on the card, launch
    counts zeroed just before and read just after; fails unless each kernel
    of ``kernels`` launched.  Logs each wave's gather, H2D, solve and stall
    seconds and the engine's summary.  Returns the result, the non-zero
    counts and the device memory peak of the run."""
    import torch
    from repro_torch.core import TorchPlan, tree_maximize
    from repro_torch.kernels import ops
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    res = tree_maximize(obj, source, cfg, device="cuda", plan=TorchPlan(SEED),
                        **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {key: v for key, v in ops.launch_counts.items() if v}
    peak = torch.cuda.max_memory_allocated()
    for kern in kernels:
        if counts.get(kern, 0) == 0:
            fail(f"{name} launched {kern} no time")
    es = res.engine_stats
    if es is None or es.engine != cfg.engine or es.hosts != cfg.hosts:
        fail(f"{name}: engine stats {es and (es.engine, es.hosts)}, asked "
             f"{cfg.engine}, {cfg.hosts} hosts")
    if not 1 <= es.max_in_flight <= cfg.max_in_flight:
        fail(f"{name}: {es.max_in_flight} live wave buffers, bound "
             f"{cfg.max_in_flight}")
    if res.ingest.peak_wave_bytes > cfg.capacity_bytes:
        fail(f"{name}: a wave took {res.ingest.peak_wave_bytes} bytes")
    summary = {key: v for key, v in es.summary().items() if key != "faults"}
    log(f"{name}: rounds {res.rounds}, machines/round "
        f"{res.machines_per_round}, depth/round {res.depth_per_round}, "
        f"oracle calls {res.oracle_calls}, value {res.value!r}; round walls "
        f"(CUDA events) {res.round_walls}; round 0 by the engine "
        f"{es.wall_s!r} s, before its first wave "
        f"{res.round_walls[0] - es.wall_s!r} s; whole run {wall:.3f} s; "
        f"device memory peak {peak} B; launches {counts}")
    log(f"  {name} engine: {json.dumps(summary)}")
    for t in es.traces:
        log(f"  {name} wave {t.wave}: {t.machines} machines, gather "
            f"{t.gather_s:.4f} s, H2D {t.h2d_s:.4f} s, solve {t.solve_s:.4f} "
            f"s, stall {t.stall_s:.4f} s, per host {t.per_host_rows}")
    return res, counts, peak


def phase_engine(main: dict, streaming: dict) -> dict:
    """The round-0 engine at the Webscope deployment, on phase 4's host
    array and plan under phase 5's 256 MiB wave budget: the pipelined fp32
    TREE as phase 5's sync streaming run and the resident TREE; fp32 and
    bf16 pipelined over 4 ingestion hosts as their sync runs; 4 hosts under
    a fault policy with transient faults (rate 0.2) and host 2 lost from
    wave 1, as the fault-free run; wave 1 killed, as the resident TREE with
    that wave's machines failed, with exactly their oracle calls fewer;
    async round checkpoints (deltas every 2 rounds) as the unchecked run,
    and a run stopped after its round-1 checkpoint and resumed."""
    import tempfile

    import numpy as np
    import torch
    from repro_torch.core import (ArraySource, QuantizedSource, TorchPlan,
                                  run_round, tree_maximize)
    from repro_torch.core import partition as part_lib
    from repro_torch.core import tree as tree_lib
    from repro_torch.engine import (FaultInjector, FaultPolicy,
                                    FaultProfile, list_round_checkpoints)
    host, obj, cfg = main["host"], main["obj"], main["cfg"]
    n, mu = len(host), cfg.capacity
    L = main["tree"].machines_per_round[0]
    sync = streaming["result"]
    scfg = dataclasses.replace(cfg, capacity_bytes=STREAM_BYTES)
    pcfg = dataclasses.replace(scfg, engine="pipelined", max_in_flight=2)
    src = ArraySource(host)
    out = {"walls": {"sync": sync["fp32"].round_walls[0]}, "launches": {}}

    # the set-up before round 0's first wave: the plan's slot permutation
    t0 = time.perf_counter()
    tree_lib._round0_slot_blocks(TorchPlan(SEED), n, L, mu, "dense")
    log(f"round 0's slot assignment alone (the {L * mu}-slot permutation on "
        f"the host): {time.perf_counter() - t0:.4f} s")

    res, cnt, peak = run_engine("pipelined streaming TREE, fp32", obj, src,
                                pcfg, ("greedy_select",))
    same_tree("pipelined streaming TREE, fp32 vs sync", res, sync["fp32"])
    same_tree("pipelined streaming TREE, fp32 vs resident", res,
              main["tree"])
    if cnt.get("greedy_select") != streaming["launches"]["fp32"].get(
            "greedy_select"):
        fail(f"pipelined fp32: greedy_select launches {cnt} against the "
             f"sync run's {streaming['launches']['fp32']}")
    es = res.engine_stats
    log(f"pipelined fp32: overlap {es.overlap_ratio!r} (span "
        f"{es.span_wall_s!r} s), high-water mark {es.max_in_flight} of "
        f"{pcfg.max_in_flight}; device memory peak {peak} B against the "
        f"sync run's {streaming['peak_mem']} B; round 0 {res.round_walls[0]!r}"
        f" s against sync {sync['fp32'].round_walls[0]!r} s")
    out["walls"]["pipelined"] = res.round_walls[0]
    out["engine"] = {"pipelined": es}
    out["launches"]["pipelined"] = cnt
    out["peak_mem"] = peak

    hcfg = dataclasses.replace(pcfg, hosts=4)
    res, cnt, _ = run_engine("pipelined streaming TREE, fp32, 4 hosts", obj,
                             src, hcfg, ("greedy_select",))
    same_tree("pipelined fp32, 4 hosts", res, sync["fp32"])
    out["walls"]["hosts4"] = res.round_walls[0]
    out["engine"]["hosts4"] = res.engine_stats
    q = QuantizedSource(src, "bf16", Q_BLOCK_ROWS)
    res, cnt, _ = run_engine("pipelined streaming TREE, bf16, 4 hosts", obj,
                             q, hcfg, ("greedy_select_bf16",))
    same_tree("pipelined bf16, 4 hosts", res, sync["bf16"])
    for t in res.engine_stats.traces:
        if len(t.per_host_rows) != 4 or sum(t.per_host_rows) != t.rows:
            fail(f"bf16, 4 hosts: wave {t.wave} per-host rows "
                 f"{t.per_host_rows} do not sum to its {t.rows} rows")
    out["walls"]["bf16 hosts4"] = res.round_walls[0]
    out["launches"]["bf16 hosts4"] = cnt

    policy = FaultPolicy(backoff_s=0.01)
    inj = FaultInjector(FaultProfile(transient_rate=0.2, dead_host=2,
                                     dead_host_wave=1, seed=FAULT_SEED))
    fcfg = dataclasses.replace(hcfg, fault_policy=policy)
    res, cnt, _ = run_engine("pipelined fp32, 4 hosts, faults", obj, src,
                             fcfg, ("greedy_select",), fault_injector=inj)
    same_tree("fp32 with transient faults and a lost host", res,
              sync["fp32"])
    fs = res.fault_stats
    if (fs is None or fs.evictions != 1 or fs.retries == 0
            or fs.dropped_rows != 0):
        fail(f"faults: {fs and fs.summary()}; want retries, one eviction "
             f"and no drop")
    log(f"faults: {json.dumps(fs.summary())}; replay signature "
        f"{json.dumps(fs.replay_signature())}")
    out["faults"] = fs

    W = res.ingest.wave_machines
    killed = list(range(W, min(2 * W, L)))
    res, cnt, _ = run_engine(
        "pipelined fp32, wave 1 killed", obj, src,
        dataclasses.replace(pcfg, fault_policy=FaultPolicy(
            max_retries=1, backoff_s=0.01)), ("greedy_select",),
        fault_injector=FaultInjector(FaultProfile(kill_waves=(1,))))
    fs = res.fault_stats
    ref = tree_maximize(obj, main["X"], cfg, device="cuda",
                        plan=TorchPlan(SEED), fail_machines={0: killed})
    part = tree_lib._round0_partition(TorchPlan(SEED), n, L, mu, "dense",
                                      torch.device("cuda"))
    blocks, bmask = part_lib.gather_partition(
        main["X"], part_lib.Partition(part.idx[killed], part.mask[killed]))
    calls = int(run_round(obj, blocks, bmask, k=cfg.k).oracle_calls.sum())
    del blocks, bmask, part
    if (not np.array_equal(res.sel_rows, ref.sel_rows)
            or not np.array_equal(res.sel_mask, ref.sel_mask)
            or res.value != ref.value or res.rounds != ref.rounds):
        fail(f"wave 1 killed: value {res.value!r} against the resident "
             f"TREE with machines {killed[0]}..{killed[-1]} failed "
             f"{ref.value!r}")
    if ref.oracle_calls - res.oracle_calls != calls:
        fail(f"wave 1 killed: {res.oracle_calls} oracle calls, resident "
             f"with the machines failed {ref.oracle_calls}, their calls "
             f"{calls}")
    if (fs.dropped_waves, fs.dropped_machines) != (1, len(killed)) or (
            fs.dropped_fraction > FaultPolicy().max_dropped_fraction):
        fail(f"wave 1 killed: {fs.summary()}")
    log(f"wave 1 killed: {fs.dropped_machines} machines, "
        f"{fs.dropped_rows} rows dropped ({fs.dropped_fraction!r} of round "
        f"0); value {res.value!r} as the resident TREE with them failed; "
        f"oracle calls {res.oracle_calls} = {ref.oracle_calls} − {calls}")

    ROOT.joinpath("build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        ccfg = dataclasses.replace(pcfg, checkpoint_dir=f"{tmp}/full",
                                   async_checkpoint=True,
                                   checkpoint_delta_every=2)
        res, _, _ = run_engine("pipelined fp32, async checkpoints", obj, src,
                               ccfg, ("greedy_select",))
        same_tree("checkpointed run", res, sync["fp32"])
        cs = res.checkpoint_stats
        log(f"checkpoints: {json.dumps(cs.summary())}")
        real = tree_lib._save_round

        def crash_after_round_1(d, round_idx, *a):
            real(d, round_idx, *a)
            if round_idx == 1:
                raise KeyboardInterrupt("stopped after round 1")

        kcfg = dataclasses.replace(ccfg, checkpoint_dir=f"{tmp}/cut")
        tree_lib._save_round = crash_after_round_1
        try:
            tree_maximize(obj, src, kcfg, device="cuda", plan=TorchPlan(SEED))
            fail("the run meant to stop after round 1 did not stop")
        except KeyboardInterrupt:
            pass
        finally:
            tree_lib._save_round = real
        kept = [r for r, _ in list_round_checkpoints(f"{tmp}/cut")]
        if kept != [1]:
            fail(f"stopped run left checkpoints {kept}, want [1]")
        resumed = tree_maximize(
            obj, src, dataclasses.replace(kcfg, resume=True), device="cuda",
            plan=TorchPlan(SEED))
        full = sync["fp32"]
        if (not np.array_equal(resumed.sel_rows, full.sel_rows)
                or resumed.value != full.value
                or resumed.oracle_calls != full.oracle_calls
                or resumed.rounds != full.rounds
                or resumed.round_values != full.round_values[1:]):
            fail(f"resumed run: value {resumed.value!r}, calls "
                 f"{resumed.oracle_calls}, rounds {resumed.rounds}; "
                 f"uninterrupted {full.value!r}, {full.oracle_calls}, "
                 f"{full.rounds}")
        log(f"resumed at round 1: value {resumed.value!r}, rounds "
            f"{resumed.rounds}, machines/round {resumed.machines_per_round},"
            f" as the uninterrupted run; checkpoints "
            f"{json.dumps(resumed.checkpoint_stats.summary())}")
        out["checkpoints"] = cs
    log("engine round-0 walls (CUDA events, s): " + json.dumps(out["walls"]))
    return out


# the forced wave schedule of the autotune phase: rungs and ragged widths
WAVE_SCHEDULE = [1, 497, 3, 256, 64]
# round-0 machines whose card solve is held against the plain version
N_ALG_CHECK = 8
# RandGreedI's machines at Webscope: cap = ⌈45M / 2,000⌉ = 22,500 = μ
RANDGREEDI_M = 2000


def check_trace_files(name: str, tracer, res, tmp: str) -> None:
    """The Chrome trace and the JSONL of a traced streaming run parse, hold
    one gather, stage and solve span per wave, and give the engine's
    overlap back to 1e-9; the manifest validates and its report prints."""
    from repro_torch.engine import (format_report, read_jsonl_events,
                                    wave_overlap_from_spans)
    es = res.engine_stats
    chrome, jsonl = f"{tmp}/{name}.trace.json", f"{tmp}/{name}.jsonl"
    tracer.export_chrome_trace(chrome)
    tracer.export_jsonl(jsonl)
    doc = json.load(open(chrome))["traceEvents"]
    recs = read_jsonl_events(jsonl)

    def chrome_spans(what):
        return [(e["ts"] / 1e6, (e["ts"] + e["dur"]) / 1e6) for e in doc
                if e["ph"] == "X" and e["cat"] == "wave"
                and e["name"] == what]

    for what in ("gather", "stage", "solve"):
        n_chrome = len(chrome_spans(what))
        n_jsonl = sum(1 for r in recs if r["type"] == "span"
                      and r["cat"] == "wave" and r["name"] == what)
        if not n_chrome == n_jsonl == es.waves:
            fail(f"{name}: {n_chrome} / {n_jsonl} {what} spans (Chrome / "
                 f"JSONL) for {es.waves} waves")
    _, ov = wave_overlap_from_spans(chrome_spans("gather"),
                                    chrome_spans("stage")
                                    + chrome_spans("solve"))
    if abs(ov - es.overlap_ratio) > 1e-9:
        fail(f"{name}: overlap from the trace {ov!r}, the engine's "
             f"{es.overlap_ratio!r}")
    m = res.manifest
    if m is None or m.validate():
        fail(f"{name}: manifest {m and m.validate()}")
    for line in format_report(m):
        log(f"  {name} report: {line}")
    log(f"{name}: trace {len(doc)} Chrome events, {len(recs)} JSONL "
        f"records; overlap from the trace {ov!r} = engine "
        f"{es.overlap_ratio!r}")


def phase_autotune(main: dict, streaming: dict) -> dict:
    """The wave autotuner and telemetry at Webscope on phase 5's host
    array, plan and 256 MiB budget (one card: ladder 1, 2, 4, …, 256,
    497): a pipelined autotuned run with a tracer, an autotune cache and
    checkpoints; the same run seeded from the cache, traced, and once more
    from the same seed untraced; a forced schedule mixing rungs and ragged
    widths inside a ``torch.profiler`` session.  Each run equals the sync
    fixed-width run bit for bit; the autotuned widths are rungs, no more
    distinct than ``shape_bound``; the traces parse and give the engine's
    overlap back; the manifests validate."""
    import shutil
    import tempfile

    from repro_torch.core import ArraySource
    from repro_torch.engine import (AutotuneCache, Tracer, bucket_ladder,
                                    profiler_session, shape_bound)
    from repro_torch.engine.telemetry import PROFILE_TRACE_NAME
    host, obj, cfg = main["host"], main["obj"], main["cfg"]
    sync = streaming["result"]["fp32"]
    W = sync.ingest.wave_machines
    ladder = bucket_ladder(1, W)
    bound = shape_bound(1, W)
    pcfg = dataclasses.replace(cfg, capacity_bytes=STREAM_BYTES,
                               engine="pipelined")
    src = ArraySource(host)
    out = {"walls": {}, "widths": {}, "launches": {}}
    ROOT.joinpath("build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        cache = f"{tmp}/autotune.json"

        def run(name, tracer, cache_path, **kw):
            acfg = dataclasses.replace(
                pcfg, wave_autotune=True, telemetry=tracer,
                autotune_cache=cache_path,
                checkpoint_dir=f"{tmp}/{name}")
            res, cnt, _ = run_engine(name, obj, src, acfg,
                                     ("greedy_select",), **kw)
            same_tree(f"{name} vs the sync fixed-width run", res, sync)
            widths = res.engine_stats.width_trajectory
            if not set(widths) <= set(ladder) or len(set(widths)) > bound:
                fail(f"{name}: widths {widths} off the ladder {ladder} or "
                     f"over the bound {bound}")
            out["walls"][name] = res.round_walls[0]
            out["widths"][name] = widths
            out["launches"][name] = cnt
            log(f"{name}: widths {widths} (ladder {ladder}, bound {bound});"
                f" cache {json.dumps(AutotuneCache(cache_path)._load())}")
            return res

        tr = Tracer()
        res = run("autotuned", tr, cache)
        check_trace_files("autotuned", tr, res, tmp)
        shutil.copy(cache, f"{tmp}/seed.json")
        tr = Tracer()
        res = run("autotuned, seeded", tr, cache)
        seeded = AutotuneCache(f"{tmp}/seed.json")._load()
        if res.engine_stats.width_trajectory[0] != min(
                list(seeded.values())[0], W):
            fail(f"seeded run started at "
                 f"{res.engine_stats.width_trajectory[0]}, cache {seeded}")
        check_trace_files("autotuned-seeded", tr, res, tmp)
        run("autotuned, seeded, untraced", None, f"{tmp}/seed.json")
        prof_dir = f"{tmp}/profile"
        tr = Tracer()
        scfg = dataclasses.replace(pcfg, telemetry=tr,
                                   checkpoint_dir=f"{tmp}/schedule")
        with profiler_session(prof_dir):
            res, cnt, _ = run_engine("scheduled", obj, src, scfg,
                                     ("greedy_select",),
                                     wave_schedule=WAVE_SCHEDULE)
        same_tree("scheduled vs the sync fixed-width run", res, sync)
        check_trace_files("scheduled", tr, res, tmp)
        widths = res.engine_stats.width_trajectory
        if widths[:len(WAVE_SCHEDULE)] != WAVE_SCHEDULE[:len(widths)]:
            fail(f"scheduled widths {widths}, asked {WAVE_SCHEDULE}")
        prof = Path(prof_dir) / PROFILE_TRACE_NAME
        if not prof.exists() or not json.load(open(prof)).get("traceEvents"):
            fail(f"profiler_session left no trace in {prof_dir}")
        out["walls"]["scheduled, profiled"] = res.round_walls[0]
        out["widths"]["scheduled"] = widths
        out["launches"]["scheduled"] = cnt
        log(f"profiler_session: {prof.stat().st_size} B of Chrome trace")
    log("autotune round-0 walls (CUDA events, s): "
        + json.dumps(out["walls"]))
    log("autotune width trajectories: " + json.dumps(out["widths"]))
    return out


class _PlainGains:
    """``ExemplarClustering`` with its gains from the plain PyTorch version
    on the card's tensors (the kernel's reference, same inputs)."""

    def __init__(self, obj):
        self._obj = obj

    def __getattr__(self, name):
        return getattr(self._obj, name)

    def gains(self, state, T, mask):
        from repro_torch.core.objectives import _masked
        from repro_torch.kernels import ref
        return _masked(ref.exemplar_gains(T, self._obj.eval_set,
                                          state["cur_min"]), mask)


def phase_stochastic(main: dict) -> dict:
    """Stochastic-greedy TREE at Webscope (ε = 0.5: a sample of s = 312 of
    each machine's 22,500 candidates a step, scored by ``exemplar_gains``
    at (M, s) rows), resident, draws from ``TorchPlan``; round 0's first
    machines on the card held against the plain gains on the card with the
    same draws under the near-tie rule, and to k·s oracle calls each."""
    import torch
    from repro_torch import testing
    from repro_torch.core import TorchPlan, algorithms, round_draws
    X, obj, cfg = main["X"], main["obj"], main["cfg"]
    k, mu = cfg.k, cfg.capacity
    scfg = dataclasses.replace(cfg, algorithm="stochastic_greedy", eps=EPS)
    tree, counts = run_tree("stochastic-greedy TREE", obj, X, scfg,
                            ("exemplar_gains",))
    s = algorithms.sample_size(mu, k, EPS)
    if tree.depth_per_round != [k] * tree.rounds:
        fail(f"stochastic TREE: depth {tree.depth_per_round}")
    log(f"stochastic greedy: a sample of s = {s} of {mu} candidates a step")
    ratio = tree.value / main["cent_value"]
    log(f"stochastic-greedy TREE / centralized greedy: {ratio!r} (floor "
        f"{ALG_FLOOR}; the algorithm's per-machine guarantee 1 − 1/e − ε = "
        f"{1 - 1 / math.e - EPS:.4f})")
    if ratio < ALG_FLOOR:
        fail(f"stochastic TREE ratio {ratio} below {ALG_FLOOR}")
    blocks, bmask, _ = round0_blocks(main)
    T, mk = blocks[:N_ALG_CHECK].contiguous(), bmask[:N_ALG_CHECK]
    del blocks, bmask
    draws = round_draws(TorchPlan(SEED), 0, 0, N_ALG_CHECK, mu, "cuda")
    card = algorithms.stochastic_greedy(obj, T, mk, k, draws, eps=EPS)
    # a full block keeps ≥ s candidates at every step: s oracle calls each
    if not (bool(torch.all(mk.sum(-1) >= s + k))
            and bool(torch.all(card.oracle_calls == k * s))):
        fail(f"stochastic greedy: oracle calls {card.oracle_calls.tolist()}"
             f", the definition gives k·s = {k * s} a full machine")
    plain_obj = _PlainGains(obj)
    plain = algorithms.stochastic_greedy(plain_obj, T, mk, k, draws, eps=EPS)
    trace = testing.sample_gain_trace(plain_obj, T, mk, plain.sel_idx, draws,
                                      EPS)
    ok, ties, excused = testing.picks_agree(card.sel_idx.cpu(),
                                            plain.sel_idx.cpu(), trace.cpu())
    same = torch.all(card.sel_idx == plain.sel_idx, dim=-1)
    if not ok or not torch.equal(card.oracle_calls[same],
                                 plain.oracle_calls[same]):
        fail("stochastic greedy on the card parts from the plain gains "
             "beyond the near-tie rule")
    testing.assert_close(card.value[same], plain.value[same],
                         "stochastic round-0 values, same picks")
    log(f"stochastic greedy, round 0's first {N_ALG_CHECK} machines: card "
        f"(exemplar_gains at ({N_ALG_CHECK}, {s}) rows) vs plain gains on "
        f"the card, same draws: {int(same.sum())}/{N_ALG_CHECK} machines "
        f"pick alike, exact ties {ties}, excused {excused}")
    return {"tree": tree, "launches": counts}


def phase_threshold_greedy(main: dict) -> dict:
    """Threshold-greedy TREE at Webscope (ε = 0.5: 11 τ-levels, depth 12 a
    round), resident; round 0's first machines on the card held against
    the plain gains on the card under the near-threshold rule, and each of
    their takes within 1 − ε of the best gain left."""
    import torch
    from repro_torch import testing
    from repro_torch.core import algorithms
    X, obj, cfg = main["X"], main["obj"], main["cfg"]
    k = cfg.k
    tcfg = dataclasses.replace(cfg, algorithm="threshold_greedy", eps=EPS)
    tree, counts = run_tree("threshold-greedy TREE", obj, X, tcfg,
                            ("exemplar_gains",))
    n_levels = math.ceil(math.log(2 * k / EPS) / EPS)
    if tree.depth_per_round != [1 + n_levels] * tree.rounds:
        fail(f"threshold TREE: {n_levels} levels, depth "
             f"{tree.depth_per_round}")
    log(f"threshold greedy: {n_levels} τ-levels, depth {1 + n_levels} a "
        f"round")
    ratio = tree.value / main["cent_value"]
    log(f"threshold-greedy TREE / centralized greedy: {ratio!r} (floor "
        f"{ALG_FLOOR}; the algorithm's guarantee 1 − 1/e − ε = "
        f"{1 - 1 / math.e - EPS:.4f})")
    if ratio < ALG_FLOOR:
        fail(f"threshold TREE ratio {ratio} below {ALG_FLOOR}")
    blocks, bmask, _ = round0_blocks(main)
    T, mk = blocks[:N_ALG_CHECK].contiguous(), bmask[:N_ALG_CHECK]
    del blocks, bmask
    card = algorithms.threshold_greedy(obj, T, mk, k, eps=EPS)
    plain_obj = _PlainGains(obj)
    plain = algorithms.threshold_greedy(plain_obj, T, mk, k, eps=EPS)
    trace = testing.gain_trace(plain_obj, T, mk, plain.sel_idx)
    d_max = torch.amax(trace[..., 0, :], dim=-1)
    ratio_t = torch.tensor(1.0 - EPS, dtype=torch.float32, device="cuda")
    taus = torch.stack([d_max * torch.pow(ratio_t, torch.tensor(
        float(lv), device="cuda")) for lv in range(n_levels)], dim=-1)
    ok, excused = testing.sweep_agree(card.sel_idx.cpu(),
                                      plain.sel_idx.cpu(), trace.cpu(),
                                      taus.cpu())
    if not ok:
        fail("threshold greedy on the card parts from the plain gains "
             "beyond the near-threshold rule")
    same = torch.all(card.sel_idx == plain.sel_idx, dim=-1)
    if not torch.equal(card.oracle_calls[same], plain.oracle_calls[same]):
        fail("threshold greedy: the same takes with other oracle calls")
    # the definition, independent of the sweep's code: a take at level τ
    # meets τ, and every row left was below τ/(1 − ε) at the level before,
    # so each of the card's takes is within 1 − ε of the best gain left
    ctrace = testing.gain_trace(plain_obj, T, mk, card.sel_idx)
    took = card.sel_idx >= 0
    g_take = torch.take_along_dim(
        ctrace, torch.clamp_min(card.sel_idx, 0)[..., None], dim=-1)[..., 0]
    g_best = torch.amax(ctrace, dim=-1)
    low = took & (g_take < (1 - EPS) * g_best * (1 - testing.RTOL)
                  - testing.ATOL)
    if bool(torch.any(low)):
        fail(f"threshold greedy: {int(low.sum())} takes below (1 − ε) of "
             f"the best gain left")
    log(f"threshold greedy: each of {int(took.sum())} takes on the card "
        f"within 1 − ε of the best gain left (least share "
        f"{float(torch.amin(torch.where(took, g_take / g_best, 1.0))):.4f})")
    testing.assert_close(card.value[same], plain.value[same],
                         "threshold round-0 values, same takes")
    log(f"threshold greedy, round 0's first {N_ALG_CHECK} machines: card vs "
        f"plain gains on the card: {int(same.sum())}/{N_ALG_CHECK} machines "
        f"take alike, excused partings {excused}")
    return {"tree": tree, "launches": counts}


def phase_randgreedi(main: dict) -> dict:
    """RandGreedI at Webscope with m = 2,000 machines (cap = 22,500; the
    union 100,000 rows): from the card's array and from a host source in
    chunks of ⌈√m⌉ = 45 machines, the two equal bit for bit; each run's
    launches counted; the value against the centralized greedy's."""
    import torch
    from repro_torch import testing
    from repro_torch.core import ArraySource, TorchPlan, randgreedi
    from repro_torch.kernels import ops
    X, host, obj, cfg = main["X"], main["host"], main["obj"], main["cfg"]
    k = cfg.k
    out = {"walls": {}, "launches": {}}
    res = {}
    for name, data in (("array", X), ("source", ArraySource(host))):
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        r = randgreedi(obj, data, k, RANDGREEDI_M, TorchPlan(SEED),
                       device="cuda")
        value = float(r.value)
        out["walls"][name] = time.perf_counter() - t0
        counts = {key: v for key, v in ops.launch_counts.items() if v}
        if counts.get("greedy_select", 0) == 0:
            fail(f"RandGreedI ({name}) launched greedy_select no time")
        out["launches"][name] = counts
        testing.assert_close(value, float(obj.evaluate(r.sel_rows,
                                                       r.sel_mask)),
                             f"RandGreedI ({name}) re-scored")
        res[name] = r
        log(f"RandGreedI from the {name}, m = {RANDGREEDI_M}: value "
            f"{value!r}, wall {out['walls'][name]:.3f} s (host clock, "
            f"synchronized), launches {counts}")
    a, b = res["array"], res["source"]
    if not (torch.equal(a.sel_rows, b.sel_rows)
            and torch.equal(a.sel_mask, b.sel_mask)
            and float(a.value) == float(b.value)):
        fail("RandGreedI: the source path's result differs from the "
             "array path's")
    ratio = float(a.value) / main["cent_value"]
    log(f"RandGreedI / centralized greedy: {ratio!r}; TREE / centralized "
        f"{main['tree'].value / main['cent_value']!r}")
    if ratio < 0.9:
        fail(f"RandGreedI ratio {ratio} below 0.9")
    out["ratio"] = ratio
    return out


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
                            ("rbf_kernel", "rbf_kernel_rowvec"))
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
    res, cnt_t = run_tree(f"weighted THRESHOLD-BATCH TREE eps={EPS}, "
                          f"Webscope", obj, X, cfg_t, (
                              "exemplar_gains_weighted",
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
    return {"w": w, "launches": counts.get("greedy_select_weighted", 0),
            "exemplar_gains_weighted": cnt_t.get("exemplar_gains_weighted",
                                                 0)}


# the serving phase: requests, second parameters on warm entries, the delta
SERVE_QUERY_ROWS = (12_345, 4_321_001)
SERVE_DELTA = 64
# the kernels every warm serving pass launches (through graph replays and
# THRESHOLD-BATCH's eager tail)
SERVE_KERNELS = ("greedy_select", "greedy_select_constrained",
                 "greedy_select_weighted", "threshold_select",
                 "threshold_select_prepass", "threshold_select_tail",
                 "exemplar_gains")


def serving_requests(host, k_values=(50, 25)) -> list:
    """The 9 requests of the serving phase: k ∈ {50, 25} × {none,
    Knapsack(0.45k), PartitionMatroid(⌈k/4⌉ per group), a query row}, and
    THRESHOLD-BATCH at ε = 0.5 (k = 50)."""
    from repro_torch.core import Knapsack, PartitionMatroid
    from repro_torch.serve import SelectionRequest
    reqs = []
    for k in k_values:
        reqs += [SelectionRequest(k=k),
                 SelectionRequest(k=k, constraint=Knapsack(0.45 * k, col=0)),
                 SelectionRequest(k=k, constraint=PartitionMatroid(
                     (math.ceil(k / 4),) * N_GROUPS, col=1)),
                 SelectionRequest(k=k, query=host[SERVE_QUERY_ROWS[0]
                                                  % len(host)])]
    reqs.append(SelectionRequest(k=k_values[0], algorithm="threshold_batch",
                                 eps=EPS))
    return reqs


def same_answer(name: str, a, b) -> None:
    """Fail unless two served answers agree bit for bit: rows, attrs, mask,
    value, oracle calls and depth."""
    import numpy as np
    if not (np.array_equal(a.rows, b.rows) and np.array_equal(a.attrs, b.attrs)
            and np.array_equal(a.mask, b.mask)
            and np.float32(a.value).tobytes() == np.float32(b.value).tobytes()
            and a.oracle_calls == b.oracle_calls
            and a.solve_depth == b.solve_depth):
        fail(f"{name}: answers differ (value {a.value!r} vs {b.value!r}, "
             f"calls {a.oracle_calls} vs {b.oracle_calls})")


def phase_serving(main: dict, constrained: dict) -> dict:
    """Selection serving at the Webscope deployment: ingest the 45M rows
    and their attributes into 2,000 resident machines, serve 9 requests
    cold then warm through CUDA-graph entries, new parameters on warm
    entries, a dispatcher burst, every answer against ``offline_solve``,
    a delta of 64 deletes and 64 inserts through the partial re-solve
    against the rebuilt session."""
    import numpy as np
    import torch
    from repro_torch.core import Knapsack, TreeConfig, check_feasible
    from repro_torch.kernels import ops
    from repro_torch.serve import (Dispatcher, SelectionRequest,
                                   SelectionService, ingest, offline_solve)
    from repro_torch.serve import service as service_mod
    host, cfg, obj = main["host"], main["cfg"], main["obj"]
    n, k, mu = host.shape[0], cfg.k, cfg.capacity
    attrs = constrained["attrs"].cpu().numpy()
    E = obj.eval_set.cpu().numpy()
    out = {}

    # ingest: the host array through the sync engine, waves under the
    # streaming phase's byte budget, the main path's plan (TorchPlan(SEED))
    t0 = time.perf_counter()
    st = ingest(host, TreeConfig(k=k, capacity=mu, seed=SEED,
                                 capacity_bytes=STREAM_BYTES), attrs=attrs)
    out["ingest_s"] = time.perf_counter() - t0
    if (st.Mp, st.n_items, st.free_slots) != (n // mu, n, 0):
        fail(f"serving ingest: Mp {st.Mp}, {st.n_items} items, "
             f"{st.free_slots} free slots (want {n // mu}, {n}, 0)")
    log(f"serving ingest: {n} rows into Mp = {st.Mp} machines × μ = {mu} "
        f"in {st.ingest_stats.waves} waves of ≤ {st.ingest_stats.wave_machines}"
        f" machines, {out['ingest_s']!r} s (host arrays {st.blocks.nbytes + st.attrs.nbytes} B)")

    reqs = serving_requests(host, (k, k // 2))
    statics = [service_mod._static_constraint(r.constraint) for r in reqs]

    def check_answers(name, answers):
        for r, c, res in zip(reqs, statics, answers):
            ok, detail = check_feasible(c, res.attrs, res.mask)
            if not (ok and res.feasible):
                fail(f"{name}: k={r.k} {c}: infeasible: {detail}")
            if not (math.isfinite(res.value) and res.rows.shape == (r.k, 6)):
                fail(f"{name}: k={r.k} {c}: value {res.value} rows "
                     f"{res.rows.shape}")

    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    svc = SelectionService(st, E, device="cuda")
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    cold = svc.serve(reqs)
    torch.cuda.synchronize()
    out["cold_s"] = time.perf_counter() - t0
    cold_counts = {key: v for key, v in ops.launch_counts.items() if v}
    check_answers("serving, cold", cold)
    captures = svc.cache.compiles
    entries = len(svc.cache.keys)
    graphs = len(svc.cache.graph_keys)
    out["memory_peak"] = torch.cuda.max_memory_allocated()
    log(f"serving cold batch of {len(reqs)}: {out['cold_s']!r} s; "
        f"{entries} entries ({graphs} CUDA graphs, {entries - graphs} eager: "
        f"THRESHOLD-BATCH), {captures} captures; launches {cold_counts}; "
        f"memory peak {out['memory_peak']} B ({out['memory_peak'] - mem0} B "
        f"above the phase's start)")

    ops.reset_launch_counts()
    t0 = time.perf_counter()
    warm = svc.serve(reqs)
    torch.cuda.synchronize()
    out["warm_s"] = time.perf_counter() - t0
    warm_counts = {key: v for key, v in ops.launch_counts.items() if v}
    for r, a, b in zip(reqs, cold, warm):
        same_answer(f"serving warm vs cold, k={r.k}", b, a)
    stats = svc.serve_stats()
    if (svc.cache.compiles != captures or len(svc.cache.keys) != entries
            or stats["steady_retraces"]):
        fail(f"serving warm pass captured again: {stats}")
    for name in SERVE_KERNELS:
        if not warm_counts.get(name):
            fail(f"serving warm pass launched {name} no time")
    log(f"serving warm batch: {out['warm_s']!r} s, the cold bits, 0 "
        f"recaptures, {stats['replays']} replays; launches {warm_counts}")
    for key, ent in svc.cache._fns.items():
        if ent.graph:
            log(f"  graph {key[0]} k={key[1][0]} {key[1][3][0]} "
                f"weighted={key[1][4]} bucket {key[2]}: launches per "
                f"replay {ent.launches}")

    # new parameters on warm entries: round-0 and tail replays
    new = [SelectionRequest(k=k, constraint=Knapsack(0.40 * k, col=0)),
           SelectionRequest(k=k, query=host[SERVE_QUERY_ROWS[1] % n],
                            seed=7)]
    replays0 = stats["replays"]
    got = svc.serve(new)
    for r, res in zip(new, got):
        ok, detail = check_feasible(service_mod._static_constraint(
            r.constraint), res.attrs, res.mask)
        if not (ok and res.feasible):
            fail(f"serving new parameters: infeasible: {detail}")
        same_answer(f"serving new parameters vs offline, k={r.k}", res,
                    offline_solve(st, E, r, device="cuda"))
    stats = svc.serve_stats()
    if (svc.cache.compiles != captures or stats["steady_retraces"]
            or stats["replays"] != replays0 + 4):
        fail(f"serving new parameters: not 4 replays of warm entries "
             f"({stats})")
    log(f"serving new parameters (budget 0.40k, another query row and "
        f"seed): round 0 and tail replayed, the offline bits, 0 captures")

    # a dispatcher burst
    dp = Dispatcher(svc, max_batch=8)
    try:
        burst = dp.map(reqs, timeout=600)
    finally:
        dp.close(timeout=60)
    check_answers("serving burst", burst)
    for r, a, b in zip(reqs, burst, cold):
        same_answer(f"serving burst vs direct, k={r.k}", a, b)
    stats = svc.serve_stats()
    if stats["queue_depth_max"] < 1 or stats["steady_retraces"]:
        fail(f"serving burst: {stats}")
    log(f"serving dispatcher burst (max_batch 8): {len(burst)} answers, "
        f"the direct bits, queue depth max {stats['queue_depth_max']}")

    # every served answer against the offline solve (eager, no cache)
    t0 = time.perf_counter()
    for r, res in zip(reqs, cold):
        same_answer(f"served vs offline, k={r.k} {r.constraint} "
                    f"query={r.query is not None} {r.algorithm}", res,
                    offline_solve(st, E, r, device="cuda"))
    log(f"served = offline_solve bit for bit, {len(reqs)} requests "
        f"(offline {time.perf_counter() - t0:.1f} s)")
    ratio = cold[0].value / main["cent_value"]
    gap = 1.0 - cold[-1].value / main["cent_value"]
    out.update(ratio=ratio, gap=gap)
    log(f"served k={k} / centralized: {ratio!r}; THRESHOLD-BATCH gap "
        f"{gap!r} (ε = {EPS})")
    if ratio < 0.9 or gap > EPS:
        fail(f"serving: ratio {ratio} or threshold gap {gap} out of bounds")

    # one warm tail: its graph replay against the eager tail
    prep = svc._prepare(reqs[0])
    fk = prep.fuse_key
    sols = svc._sol_cache[(fk, prep.fp, st.generation)]["sols"]
    ent = svc.cache._fns[("tail", fk, 1)]
    ladder = service_mod.round_ladder(st.Mp, k, mu)
    draws = [x.cuda() for x in service_mod.tail_draws(
        svc.tail_plan(0, ladder), fk)]
    ev = svc._eval_dev
    no = torch.zeros((0,), device="cuda")
    eager_tail = service_mod.make_tail_fn(fk)
    out["tail_eager_ms"] = cuda_ms(lambda: eager_tail(
        *sols, ev, no, no, service_mod.TailDraws(draws)), runs=3)
    out["tail_replay_ms"] = cuda_ms(ent.g.replay, runs=10)
    log(f"warm tail k={k}, unconstrained (rounds of {ladder[1:]} machines): "
        f"graph replay {out['tail_replay_ms']!r} ms, eager "
        f"{out['tail_eager_ms']!r} ms (CUDA events)")

    stats = svc.serve_stats()
    out.update(p50_ms=stats["latency_p50_ms"], p95_ms=stats["latency_p95_ms"],
               captures=stats["compiles"], entries=stats["cache_keys"],
               graph_entries=stats["graph_entries"])
    log(f"serving stats: {stats}")

    # a delta: 64 deletes, 64 inserts into the freed slots
    r = np.random.default_rng(SEED + 23)
    dels = [int(i) for i in r.choice(n, SERVE_DELTA, replace=False)]
    rows = host[r.choice(n, SERVE_DELTA, replace=False)] * np.float32(0.5)
    ia = make_attrs(SERVE_DELTA, SEED + 24)
    rep = svc.apply_delta(insert_rows=rows, insert_attrs=ia, delete_ids=dels)
    if rep.rebuilt or len(rep.changed_machines) > SERVE_DELTA \
            or st.free_slots:
        fail(f"serving delta: rebuilt {rep.rebuilt}, "
             f"{len(rep.changed_machines)} machines changed, "
             f"{st.free_slots} free slots")
    ops.reset_launch_counts()
    partial0 = svc.partial_resolves
    t0 = time.perf_counter()
    after = svc.serve(reqs)
    torch.cuda.synchronize()
    out["partial_s"] = time.perf_counter() - t0
    check_answers("serving after the delta", after)
    if svc.partial_resolves != partial0 + len(reqs):
        fail("serving after the delta: not one partial re-solve a request")
    log(f"serving after the delta ({len(rep.changed_machines)} machines "
        f"changed): {out['partial_s']!r} s through the partial re-solve; "
        f"launches {dict((k_, v) for k_, v in ops.launch_counts.items() if v)}")

    t0 = time.perf_counter()
    st.rebuild()
    out["rebuild_s"] = time.perf_counter() - t0
    staged = svc._dev["wide"]["blocks"].data_ptr()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    rebuilt = svc.serve(reqs)
    torch.cuda.synchronize()
    out["full_s"] = time.perf_counter() - t0
    for q, a, b in zip(reqs, after, rebuilt):
        same_answer(f"delta vs rebuild, k={q.k} {q.constraint} "
                    f"query={q.query is not None} {q.algorithm}", a, b)
    stats = svc.serve_stats()
    if stats["steady_retraces"] or \
            svc._dev["wide"]["blocks"].data_ptr() != staged:
        fail(f"serving after the rebuild recaptured or moved the staged "
             f"blocks: {stats}")
    log(f"delta = rebuild bit for bit, {len(reqs)} requests: re-ingest "
        f"{out['rebuild_s']!r} s, then round 0 in full (replays on the "
        f"blocks restaged in place) {out['full_s']!r} s against the partial "
        f"re-solve's {out['partial_s']!r} s; 0 recaptures; launches "
        f"{dict((k_, v) for k_, v in ops.launch_counts.items() if v)}")
    out["serve_counts"] = warm_counts
    del svc
    torch.cuda.empty_cache()
    return out

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
    ops.reset_launch_counts()
    K = ops.rbf_kernel(x, blocks, 0.5)
    if ops.launch_counts["rbf_kernel_rowvec"] != 1:
        fail("rbf_kernel at the round-0 update did not take the row vector")
    K_p, plain = timed_once(lambda: ref.rbf_kernel(x, blocks, 0.5))
    testing.assert_close(K, K_p, "rbf_kernel at the round-0 update")
    err = testing.max_abs_err(K, K_p)
    self_k = torch.take_along_dim(K[:, 0], idx[:, None], dim=1)
    if not bool(torch.all((self_k >= 1 - tol) & (self_k <= 1))):
        fail("rbf_kernel K(x, x) outside [1 - tol, 1] at the round-0 update")
    del K, K_p
    ms = cuda_ms(lambda: ops.rbf_kernel(x, blocks, 0.5), runs=20)
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
    K_p, plain = timed_once(lambda: ref.rbf_kernel(E, Y, 1.0))
    testing.assert_close(K, K_p, "rbf_kernel at a FacilityLocation chunk")
    err = testing.max_abs_err(K, K_p)
    del K, K_p
    ms = cuda_ms(lambda: ops.rbf_kernel(E, Y, 1.0), runs=10)
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

    # the centralized update: one row against all n rows, on the row vector
    x1 = X[1:2]
    ops.reset_launch_counts()
    K = ops.rbf_kernel(x1, X, 0.5)
    if ops.launch_counts["rbf_kernel_rowvec"] != 1:
        fail("rbf_kernel at the centralized update did not take the row "
             "vector")
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
    trace, plain = timed_once(lambda: ref.greedy_select_trace(
        blocks, E, seed, bmask, k, eval_weights=w))
    log(f"plain weighted greedy at round 0 (M={M}): {plain / 1e3:.1f} s")
    n_tie, same, err = check_greedy(sel, cm_out, blocks, E, seed, trace,
                                    "weighted greedy_select at round 0")
    log(f"weighted greedy_select round 0 vs plain: {same}/{M} machines "
        f"select as plain, near-tie steps {n_tie}, max|dcm| {err:.3g}")
    ms = cuda_ms(lambda: ops.greedy_select(blocks, E, seed, bmask, k,
                                           eval_weights=w), runs=3)
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


def timed_once(fn):
    """``fn()`` once between CUDA events: (its result, device ms)."""
    import torch
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def times_exemplar(main: dict, constrained: dict, weighted: dict,
                   streaming: dict, blocks) -> list[dict]:
    """exemplar_gains' kernel alone (operands padded once, as the scan
    block's row) at the THRESHOLD-BATCH d_max pass of round 0 (M = 2,000
    machines of μ = 22,500 rows, m = 512, d = 6), unweighted and with the
    weighted phase's eval weights, and at one chunk of the streaming
    centralized greedy (M = 1, n = 2²⁰): each against its plain version
    there, timed beside it and its bound.  Launches: the THRESHOLD-BATCH
    TREE runs (unconstrained and knapsack ∩ partition; the weighted one)
    and the streaming centralized greedy."""
    import torch
    from repro_torch import testing
    from repro_torch.kernels import exemplar_gains as _eg
    from repro_torch.kernels import ops, ref
    E = main["obj"].eval_set
    m, d = E.shape
    seed = torch.sum(E * E, dim=-1)
    w = weighted["w"]
    chunk = main["X"][:1 << 20].unsqueeze(0).contiguous()
    rows = []
    for name, X, ew, n_launch in (
            ("exemplar_gains (round 0 d_max)", blocks, None,
             constrained["launches"]["exemplar_gains_threshold"]),
            ("exemplar_gains_weighted (round 0 d_max)", blocks, w,
             weighted["exemplar_gains_weighted"]),
            ("exemplar_gains (2^20-row chunk)", chunk, None,
             streaming["central_launches"]["exemplar_gains"])):
        M, n, _ = X.shape
        Ep, cmp_ = ops._pad_eval(E, seed.expand(M, m))
        ewp = ops._pad_weights(ew, m)
        g = ops.exemplar_gains(X, E, seed, eval_weights=ew)
        g_p, plain = timed_once(lambda: ref.exemplar_gains(
            X, E, seed, eval_weights=ew))
        testing.assert_close(g, g_p, f"{name}")
        err = testing.max_abs_err(g, g_p)
        del g, g_p
        ms = cuda_ms(lambda: _eg.launch(X, Ep, cmp_, ewp),
                     runs=10 if M > 1 else 50)
        b, by, b32 = tile_bound(M * n * m, d, 4 * (M * n * d + m * d + M * m
                                                   + M * n), 3 if ew is None
                                else 4)
        rows.append({"name": name, "route": "cuda",
                     "source": "src/repro_torch/kernels/csrc/"
                               "exemplar_gains.cu",
                     "replaces": "src/repro/kernels/exemplar_gains.py:107",
                     "launches": n_launch, "max_abs_err": err, "ms": ms,
                     "plain_ms": plain, "bound_ms": b, "bound_by": by,
                     "bound_fp32_ms": b32, "library_ms": None})
    del chunk
    torch.cuda.empty_cache()
    return rows


def times_narrow(main: dict, streaming: dict, blocks, bmask) -> list[dict]:
    """The narrow instantiations of the three gain-tile kernels at round 0
    of the Webscope TREE (M = 2,000 machines of μ = 22,500 rows, m = 512,
    d = 6): each against its plain version there, timed beside the fp32
    kernel at the same shape, its plain version and its bound (the byte
    bound counts d · itemsize a row, + 8 of scale and zero-point at int8;
    the operations do not change).  exemplar_gains is the THRESHOLD-BATCH
    d_max pass, threshold_select level 0 unconstrained, greedy_select one
    call of k steps.  Launches: the streaming phase's runs."""
    import torch
    from repro_torch import testing
    from repro_torch.kernels import exemplar_gains as _eg
    from repro_torch.kernels import ops, ref
    obj, cfg = main["obj"], main["cfg"]
    E = obj.eval_set
    M, mu, d = blocks.shape
    m, k = E.shape[0], cfg.k
    seed = torch.sum(E * E, dim=-1)
    Ep, cmp_ = ops._pad_eval(E, seed.expand(M, m))
    launches: dict[str, int] = {}
    for cnt in streaming["launches"].values():
        for key, v in cnt.items():
            launches[key] = launches.get(key, 0) + v
    n_avail = torch.sum(bmask.long(), dim=1, keepdim=True)
    calls = int(torch.sum(torch.clamp_min(
        n_avail - torch.arange(k, device="cuda"), 0)))
    n_rows = int(bmask.sum())
    g32 = ops.exemplar_gains(blocks, E, seed)
    fp32_ms = {
        "exemplar_gains": cuda_ms(lambda: _eg.launch(blocks, Ep, cmp_),
                                  runs=10),
        "greedy_select": cuda_ms(lambda: ops.greedy_select(
            blocks, E, seed, bmask, k), runs=3)}
    tau32 = torch.amax(torch.where(bmask, g32, 0.0), dim=1)
    fp32_ms["threshold_select"] = cuda_ms(lambda: ops.threshold_select(
        blocks, E, seed, bmask, tau32, k), runs=5)
    src = "src/repro_torch/kernels/csrc/"
    rows = []
    for kind, dot in (("bf16", False), ("q8", False), ("fp32", True)):
        X, kw, deq, ctr = narrow_rows(blocks, kind, dot, seed=SEED)
        tag = ctr[0]
        card = {key: v for key, v in kw.items() if key != "compute_dtype"}
        row_b = {"bf16": 2 * d, "q8": d + 8, "fp32": 4 * d}[kind]
        what = f"{narrow_name(kind, dot)} at round 0"
        # exemplar_gains, the d_max pass
        g = ops.exemplar_gains(X, E, seed, **kw)
        g_p, plain = timed_once(lambda: ref.exemplar_gains(X, E, seed, **kw))
        testing.assert_close(g, g_p, f"exemplar_gains {what}")
        err = testing.max_abs_err(g, g_p)
        ms = cuda_ms(lambda: _eg.launch(X, Ep, cmp_, bf16dot=dot, **card),
                     runs=10)
        b, by, b32 = tile_bound(M * mu * m, d, M * mu * row_b + 4 * m * d
                                + 4 * M * m + 4 * M * mu, 3)
        rows.append({"name": f"exemplar_gains{tag}", "route": "cuda",
                     "source": src + "exemplar_gains.cu",
                     "replaces": "src/repro/kernels/exemplar_gains.py:107",
                     "launches": launches.get(f"exemplar_gains{tag}", 0),
                     "max_abs_err": err, "ms": ms, "plain_ms": plain,
                     "fp32_ms": fp32_ms["exemplar_gains"], "bound_ms": b,
                     "bound_by": by, "bound_fp32_ms": b32,
                     "library_ms": None})
        # greedy_select, one call of k steps
        sel, cm_out = ops.greedy_select(X, E, seed, bmask, k, **kw)
        trace, plain = timed_once(
            lambda: ref.greedy_select_trace(X, E, seed, bmask, k, **kw))
        sel_p, cm_p = trace[:2]
        if bool(torch.equal(sel, sel_p)):
            testing.assert_close(cm_out, cm_p, f"greedy_select {what}")
            err, same, n_tie = testing.max_abs_err(cm_out, cm_p), M, 0
        else:
            n_tie, same, err = check_greedy(sel, cm_out, deq, E, seed, trace,
                                            f"greedy_select {what}")
        log(f"greedy_select {what} vs plain: {same}/{M} machines select as "
            f"plain, near-tie steps {n_tie}, max|dcm| {err:.3g}")
        ms = cuda_ms(lambda: ops.greedy_select(X, E, seed, bmask, k, **kw),
                     runs=3)
        b, by, b32 = tile_bound(calls * m, d, M * mu * row_b + 4 * m * d
                                + 4 * m + M * mu + 4 * M * k + 4 * M * m, 3)
        rows.append({"name": f"greedy_select{tag}", "route": "cuda",
                     "source": src + "greedy_select.cu",
                     "replaces": "src/repro/kernels/greedy_select.py:265",
                     "launches": launches.get(f"greedy_select{tag}", 0),
                     "max_abs_err": err, "ms": ms, "plain_ms": plain,
                     "fp32_ms": fp32_ms["greedy_select"], "bound_ms": b,
                     "bound_by": by, "bound_fp32_ms": b32,
                     "library_ms": None})
        # threshold_select, level 0 unconstrained (τ: the smaller d_max)
        tau = torch.minimum(torch.amax(torch.where(bmask, g, 0.0), dim=1),
                            torch.amax(torch.where(bmask, g_p, 0.0), dim=1))
        acc, cm = ops.threshold_select(X, E, seed, bmask, tau, k, **kw)
        trace, plain = timed_once(lambda: ref.threshold_select_trace(
            X, E, seed, bmask, tau, k, **kw))
        full, near, err = check_threshold(
            acc, cm, trace, deq, E, seed.expand(M, m), tau, bmask, k, None,
            f"threshold_select {what}", kw.get("compute_dtype"))
        if full < FULL_SHARE * M:
            fail(f"threshold_select {what}: only {full}/{M} machines "
                 f"compared in full")
        ms = cuda_ms(lambda: ops.threshold_select(X, E, seed, bmask, tau, k,
                                                  **kw), runs=5)
        b, by, b32 = tile_bound(n_rows * m, d, M * mu * (row_b + 2)
                                + 4 * m * d + 8 * M * m + 16 * M, 3)
        rows.append({"name": f"threshold_select{tag}", "route": "cuda",
                     "source": src + "threshold_select.cu",
                     "replaces": "src/repro/kernels/threshold_select.py:238",
                     "launches": launches.get(f"threshold_select{tag}", 0),
                     "max_abs_err": err, "ms": ms, "plain_ms": plain,
                     "fp32_ms": fp32_ms["threshold_select"], "bound_ms": b,
                     "bound_by": by, "bound_fp32_ms": b32,
                     "library_ms": None})
        log(f"threshold_select {what}, level 0: {full}/{M} machines accept "
            f"as plain, near rows {near}")
        del X, deq
    return rows


def phase_times(scan: dict, main: dict, constrained: dict, active: dict,
                facility: dict, weighted: dict, streaming: dict
                ) -> list[dict]:
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
    g = ops.exemplar_gains(T, E, cm)
    g_p, plain = timed_once(lambda: ref.exemplar_gains(T, E, cm))
    testing.assert_close(g, g_p, "exemplar_gains at the scan block")
    err = testing.max_abs_err(g, g_p)
    # the kernel alone, on operands padded once; the whole ops call beside
    Xb = T.unsqueeze(0).contiguous()
    Ep, cmp_ = ops._pad_eval(E, cm.reshape(1, m))
    ms = cuda_ms(lambda: _eg.launch(Xb, Ep, cmp_), runs=50)
    ms_ops = cuda_ms(lambda: ops.exemplar_gains(T, E, cm), runs=50)
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
    trace, plain = timed_once(lambda: ref.greedy_select_trace(
        blocks, E, seed, bmask, k))
    log(f"plain greedy at round 0 (M={M}): {plain / 1e3:.1f} s")
    tile_precision(blocks, E, seed, trace[0])
    n_tie, same, err = check_greedy(sel, cm_out, blocks, E, seed, trace,
                                    "greedy_select at round 0")
    log(f"greedy_select round 0 vs plain: {same}/{M} machines select as "
        f"plain, every machine's cur_min checked, near-tie steps {n_tie}, "
        f"max|dcm| {err:.3g}")
    ms = cuda_ms(lambda: ops.greedy_select(blocks, E, seed, bmask, k),
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
    rows += times_exemplar(main, constrained, weighted, streaming, blocks)
    rows += times_new(main, active, facility, weighted, blocks, bmask)
    rows += times_narrow(main, streaming, blocks, bmask)
    for r in rows:
        per = (f" a call ({r['calls']} calls a run)" if "calls" in r else "")
        b32 = (f"; fp32-only bound {r['bound_fp32_ms']:.4f} ms, "
               f"{r['bound_fp32_ms'] / r['ms']:.1%}"
               if "bound_fp32_ms" in r else "")
        if "fp32_ms" in r:
            per += f" (the fp32 kernel there {r['fp32_ms']:.4f} ms)"
        log(f"time {r['name']}: {r['ms']:.4f} ms{per} (plain "
            f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms by "
            f"{r['bound_by']}, {r['bound_ms'] / r['ms']:.1%} of bound{b32}), "
            f"launches {r['launches']}")
    return rows



# ---------------------------------------------------------------------------
# the CLI, the trace tool and the examples (the system's own entry points)
# ---------------------------------------------------------------------------

# the CLI's largest dataset: 200,000 × 64 at μ = 200 = 0.1% of n, the
# capacity ratio of the paper's Fig. 2(e)–(f)
# (benchmarks/fig2_large_scale.py:1-2)
CLI_BASE = ["--dataset", "large-scale", "--k", "50", "--capacity", "200"]
#: flag set → (flags, counters each run must move)
CLI_FLAGS = {
    "resident": ([], ("greedy_select",)),
    "pipelined": (["--source", "chunked", "--engine", "pipelined", "--hosts",
                   "2", "--capacity-bytes", "67108864", "--wave-autotune"],
                  ("greedy_select",)),
    "int8": (["--dtype", "int8"], ("greedy_select_q8",)),
    "intersection": (["--constraint", "intersection:knapsack:budget=22.5"
                      "+partition:caps=13,13,13,13:col=1"],
                     ("greedy_select_constrained",)),
    "threshold-batch": (["--algorithm", "threshold-batch"],
                        ("exemplar_gains", "threshold_select")),
    # 8 MiB waves (7 of 163 machines): the fault profile alone streams
    # one machine a wave, 1,000 waves, and drops 5 of them past the retry
    # budget (a different TREE by design, Lemma 3.4), with 27 s of backoff
    "faults": (["--fault-profile", "transient=0.3,seed=7",
                "--capacity-bytes", "8388608"], ("greedy_select",)),
    "serve-smoke": (["--serve-smoke"], ("greedy_select",)),
}
#: runs whose TREE line must be the resident run's byte for byte
CLI_SAME_TREE = ("pipelined", "faults")
#: runs whose first batched kernel call (round 0 of the TREE: all 1,000
#: machines, or the int8 run's first one-machine wave) is held against its
#: plain version on the same operands
CLI_HOLD = {"resident": ("greedy_select",), "int8": ("greedy_select",),
            "intersection": ("greedy_select",),
            "threshold-batch": ("exemplar_gains", "threshold_select")}


def _first_call(names, store: dict):
    """``ops.<name>`` for each of ``names`` wrapped to keep the operands of
    its first batched call, (M, μ, d) rows (the callers replace their state
    between calls and change none in place); returns the function that
    restores them."""
    from repro_torch.kernels import ops
    orig = {name: getattr(ops, name) for name in names}

    def wrap(name):
        def wrapped(*a, **kw):
            if name not in store and a[0].dim() == 3:
                store[name] = (a, kw)
            return orig[name](*a, **kw)
        return wrapped

    for name in names:
        setattr(ops, name, wrap(name))
    return lambda: [setattr(ops, name, fn) for name, fn in orig.items()]


def hold_round0(run: str, store: dict) -> dict:
    """The kernel calls ``store`` kept from a CLI run (round 0, at the CLI's
    shapes and on its operands) against their plain versions:
    greedy_select under the near-tie rule (``check_greedy``),
    exemplar_gains within the gains' tolerance, threshold_select under the
    near-threshold rule (``check_threshold``, cur_min against the
    distances' summands: at d = 64 |x|² ≈ 630, and a row that is an eval
    point cancels to 0 with an error of its ulp, 6·10⁻⁵) at level 0's τ
    lowered to the plain d_max where that is smaller (d_max is a gain,
    and the two sides' gains of that row round apart).  Returns each
    kernel's readings."""
    import torch
    from repro_torch import testing
    from repro_torch.kernels import ops, ref
    out = {}
    for name, (a, kw) in store.items():
        X, E, cm = a[:3]
        deq = ref.dequantize_rows(X, kw.get("x_scale"), kw.get("x_zp"))
        M, what = X.shape[0], (f"CLI {run}: {name} at round 0 "
                               f"({tuple(X.shape)} {X.dtype})")
        if name == "exemplar_gains":
            g = ops.exemplar_gains(*a, **kw)
            g_p, plain = timed_once(lambda: ref.exemplar_gains(*a, **kw))
            testing.assert_close(g, g_p, what)
            out[name] = {"M": M, "max_abs_err": testing.max_abs_err(g, g_p),
                         "plain_ms": plain}
        elif name == "greedy_select":
            sel, cm_out = ops.greedy_select(*a, **kw)
            trace, plain = timed_once(
                lambda: ref.greedy_select_trace(*a, **kw))
            n_tie, same, err = check_greedy(sel, cm_out, deq, E, cm, trace,
                                            what)
            out[name] = {"M": M, "machines_as_plain": same,
                         "near_tie_steps": n_tie, "max_abs_err": err,
                         "plain_ms": plain}
        else:
            mask, tau, k = a[3:6]
            gkw = {key: kw.get(key) for key in ("eval_weights",
                                                "compute_dtype", "x_scale",
                                                "x_zp")}
            g_p = ref.exemplar_gains(X, E, cm, **gkw)
            tau = torch.minimum(tau, torch.clamp_min(torch.amax(
                torch.where(mask, g_p, 0.0), dim=-1), 1e-12))
            args = (X, E, cm, mask, tau, k)
            acc, cm_out = ops.threshold_select(*args, **kw)
            trace, plain = timed_once(
                lambda: ref.threshold_select_trace(*args, **kw))
            x2 = torch.amax(torch.where(mask, torch.sum(deq * deq, -1), 0.0),
                            dim=-1)
            terms = x2[:, None] + torch.sum(E * E, -1)[None, :]
            full, near, err = check_threshold(
                acc, cm_out, trace, deq, E, cm, tau, mask, k, None, what,
                kw.get("compute_dtype"), terms)
            if full < FULL_SHARE * M:
                fail(f"{what}: only {full}/{M} machines compared in full")
            out[name] = {"M": M, "machines_in_full": full,
                         "near_rows": near, "max_abs_err": err,
                         "plain_ms": plain}
        log(f"{what} vs plain: {out[name]}")
    return out


def _cli_line(lines: list[str], start: str) -> str:
    hit = [l for l in lines if l.startswith(start)]
    if not hit:
        fail(f"CLI: no '{start}' line in {lines}")
    return hit[0]


def _cli_f(line: str) -> float:
    return float(line.split("f=", 1)[1].split()[0])


def phase_cli() -> dict:
    """The port's CLI (``repro_torch.launch.submod.main``) on the card at
    its largest dataset, each flag set of ``CLI_FLAGS`` counting its
    kernels' launches; the streamed, pipelined, autotuned and
    fault-injected TREE lines as the resident run's; GREEDY TREE /
    centralized ≥ 0.9 and the THRESHOLD-BATCH gap ≤ ε; round 0's kernel
    calls of the resident, int8, intersection and THRESHOLD-BATCH runs
    held against their plain versions on the same operands
    (:func:`hold_round0`); the int8 recheck,
    the intersection's feasibility and THRESHOLD-BATCH's adaptivity line;
    ``python -m repro_torch.launch.tracetool`` on the pipelined run's trace
    and manifest (cross-check PASS); ``python -m
    repro_torch.launch.submod`` started as a user starts it (no
    ``--device``), its TREE line the in-process run's; then the three
    examples, and ``python -m repro_torch.examples.quickstart``."""
    import shutil
    import torch
    from repro_torch.examples import (active_set_selection,
                                      distributed_tree, quickstart)
    from repro_torch.kernels import ops
    from repro_torch.launch import submod
    tmp = ROOT / "build" / "cli_phase"
    tmp.mkdir(parents=True, exist_ok=True)
    trace, manifest = str(tmp / "trace.json"), str(tmp / "manifest.json")
    runs = {}
    for name, (flags, kernels) in CLI_FLAGS.items():
        argv = CLI_BASE + flags
        if name == "pipelined":
            argv += ["--trace-out", trace, "--metrics-out",
                     str(tmp / "metrics.json"), "--manifest-out", manifest]
        log(f"CLI {name}: python -m repro_torch.launch.submod "
            f"{' '.join(argv)}")
        store = {}
        restore = _first_call(CLI_HOLD.get(name, ()), store)
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        try:
            res = submod.main(argv)
            torch.cuda.synchronize()
        finally:
            restore()
        wall = time.perf_counter() - t0
        counts = {key: v for key, v in ops.launch_counts.items() if v}
        for kern in kernels:
            if not counts.get(kern):
                fail(f"CLI {name}: {kern} launched no time ({counts})")
        log(f"CLI {name}: wall {wall!r} s, launches {counts}")
        runs[name] = {"lines": res.lines, "wall_s": wall,
                      "launches": counts}
        if name in CLI_HOLD:
            if set(store) != set(CLI_HOLD[name]):
                fail(f"CLI {name}: no round-0 call of "
                     f"{set(CLI_HOLD[name]) - set(store)}")
            if name == "int8" and store["greedy_select"][0][0].dtype != \
                    torch.int8:
                fail(f"CLI int8: round 0's greedy_select took "
                     f"{store['greedy_select'][0][0].dtype} rows")
            runs[name]["round0_hold"] = hold_round0(name, store)
        del store

    want = _cli_line(runs["resident"]["lines"], "TREE:")
    for name in CLI_SAME_TREE:
        got = _cli_line(runs[name]["lines"], "TREE:")
        if got != want:
            fail(f"CLI {name}: '{got}' is not the resident run's '{want}'")
    ratios = {}
    for name in ("resident", "threshold-batch", "intersection"):
        lines = runs[name]["lines"]
        tree = _cli_f(_cli_line(lines, "TREE:"))
        ratios[name] = tree / _cli_f(_cli_line(lines, "centralized greedy"))
    if ratios["resident"] < 0.9:
        fail(f"CLI: TREE / centralized {ratios['resident']} < 0.9")
    if 1.0 - ratios["threshold-batch"] > EPS:
        fail(f"CLI: THRESHOLD-BATCH gap {1 - ratios['threshold-batch']} "
             f"> ε = {EPS}")
    for name, start, word in (("int8", "recheck:", "PASS"),
                              ("intersection", "feasibility:", "OK"),
                              ("threshold-batch", "adaptivity:",
                               "alg=threshold_batch"),
                              ("faults", "faults:", "dropped_waves=0"),
                              ("serve-smoke", "recheck:", "PASS"),
                              ("serve-smoke", "manifest:", "OK")):
        line = _cli_line(runs[name]["lines"], start)
        if word not in line:
            fail(f"CLI {name}: '{line}' lacks '{word}'")
    log(f"CLI: TREE / centralized {ratios!r}")

    # the module entry points, as a user starts them (on the card by
    # default), all started at once; the examples run in process meanwhile
    tool = _module_start("repro_torch.launch.tracetool", trace,
                         "--manifest", manifest)
    cli = _module_start("repro_torch.launch.submod", *CLI_BASE,
                        "--no-centralized")
    quick = _module_start("repro_torch.examples.quickstart")
    for ex in (quickstart, distributed_tree, active_set_selection):
        name = ex.__name__.rsplit(".", 1)[1]
        log(f"example {name}: {ex.__name__}.main()")
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        out = ex.main()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = {key: v for key, v in ops.launch_counts.items() if v}
        kern = ("greedy_select" if ex is not active_set_selection
                else "rbf_kernel")
        if not counts.get(kern):
            fail(f"example {name}: {kern} launched no time ({counts})")
        ratio = out["tree"].value / out["centralized"] if "tree" in out \
            else out["healthy"].value / out["centralized"]
        if ratio < 0.9:
            fail(f"example {name}: TREE / centralized {ratio} < 0.9")
        log(f"example {name}: wall {wall!r} s, TREE / centralized "
            f"{ratio!r}, launches {counts}")
        runs[f"example {name}"] = {"wall_s": wall, "launches": counts,
                                   "ratio": ratio}
    tool = tool()
    cross = [l for l in tool.stdout.splitlines()
             if l.startswith("cross-check:")]
    if tool.returncode != 0 or not cross or "PASS" not in cross[0]:
        fail(f"tracetool: exit {tool.returncode}, {cross} {tool.stderr}")
    shutil.rmtree(tmp, ignore_errors=True)
    cli = cli()
    if cli.returncode != 0 or _cli_line(cli.stdout.splitlines(),
                                        "TREE:") != want:
        fail(f"python -m repro_torch.launch.submod: exit {cli.returncode}, "
             f"not the resident run's '{want}': {cli.stderr[-2000:]}")

    ex = quick()
    if ex.returncode != 0 or "TREE (capacity 2k)" not in ex.stdout:
        fail(f"python -m repro_torch.examples.quickstart: exit "
             f"{ex.returncode}: {ex.stderr[-2000:]}")
    return runs


def _module_start(name: str, *args: str):
    """Start ``python -m name args`` from the checkout's ``src`` and
    return a function that waits for it, logs its output and wall, and
    returns its ``CompletedProcess``: a process's start-up (~8 s) then
    overlaps other work."""
    t0 = time.perf_counter()
    proc = subprocess.Popen([sys.executable, "-m", name, *args],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True,
                            env={**os.environ,
                                 "PYTHONPATH": str(ROOT / "src")})

    def finish() -> subprocess.CompletedProcess:
        try:
            out, err = proc.communicate(timeout=300)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.communicate()
            fail(f"python -m {name} {' '.join(args)}: no end in 300 s")
        for line in out.splitlines():
            log(f"  {name}: {line}")
        log(f"python -m {name} {' '.join(args)}: exit {proc.returncode}, "
            f"wall {time.perf_counter() - t0!r} s")
        return subprocess.CompletedProcess(proc.args, proc.returncode, out,
                                           err)

    return finish


# ---------------------------------------------------------------------------
# LM serving: the dense transformer (Qwen3-8B) and flash_attention
# ---------------------------------------------------------------------------

# hf:Qwen/Qwen3-8B at full width; the serving cell and the parity run
LM_ARCH = "qwen3-8b"
# arXiv:2404.05892 (Finch) at full width and depth: the same two phases
RWKV_ARCH = "rwkv6-1.6b"
#: the hand-written kernels each family's serving runs; their launch
#: counters are "<name>_prefill" and "<name>_decode"
FAMILY_KERNEL = {"dense": "flash_attention", "moe": "flash_attention",
                 "ssm": "wkv6", "vlm": "flash_attention",
                 "hybrid": ("flash_attention", "wkv6"),
                 "encdec": "flash_attention"}
LM_SERVE = dict(batch=8, prompt=2048, new=32, cache_len=2080)
LM_PARITY = dict(layers=2, batch=1, prompt=256, new=8)
# arXiv:2401.06066 (deepseek-moe-16b, served at full width and depth) and
# arXiv:2409.02060 (olmoe-1b-7b, parity only); 4 sequences, so a decode
# group of B tokens never drops an assignment at C = 4
MOE_ARCH = "deepseek-moe-16b"
MOE_PARITY_ARCHS = ("deepseek-moe-16b", "olmoe-1b-7b")
MOE_PARITY = dict(layers=2, batch=4, prompt=256, new=8)
# arXiv:2404.16821 (internvl2-76b: 256 patch embeddings before the
# prompt), arXiv:2403.19887 (jamba-1.5-large-398b) and arXiv:2212.04356
# (whisper-tiny: 1,500 frame embeddings, the encoder's 30-second context)
VLM_ARCH = "internvl2-76b"
HYBRID_ARCH = "jamba-1.5-large-398b"
ENCDEC_ARCH = "whisper-tiny"
ENCDEC_FRAMES = 1500
#: what the serving and parity cells cut, and why: 80 internvl2-76b
#: layers are 141 GB of bf16 weights, so 8 (17.9 GB); one jamba period
#: with 16 experts is 91 GB, so 4 experts (33 GB, every expert matrix
#: 8,192 × 24,576 as published); whisper-tiny runs whole.  Since PR 26,
#: to make room for the training phase within the run's time limit,
#: Qwen3-8B serves 18 of its 36 layers, rwkv6-1.6b 12 of 24 and
#: deepseek-moe-16b 14 of 28 (each layer the same at full width)
LM_CUTS = {VLM_ARCH: dict(n_layers=8),
           HYBRID_ARCH: dict(n_layers=8, n_experts=4),
           LM_ARCH: dict(n_layers=18), RWKV_ARCH: dict(n_layers=12),
           MOE_ARCH: dict(n_layers=14)}
#: the serving cells that differ from LM_SERVE: whisper decodes 32 tokens
#: after a 4-token prompt against its 1,500 frames, cache 1,500 slots
LM_SERVE_BY_ARCH = {ENCDEC_ARCH: dict(batch=8, prompt=4, new=32,
                                      cache_len=1500)}
#: the parity runs that differ from LM_PARITY: jamba one period, a
#: 64-token prompt and 2 decode steps (128 and 4 until PR 26, cut to make
#: room: the CPU side reads the 33 GB of weights a step); whisper whole
#: against 1,500 frames
LM_PARITY_BY_ARCH = {HYBRID_ARCH: dict(layers=8, batch=1, prompt=64,
                                       new=2),
                     ENCDEC_ARCH: dict(layers=4, batch=1, prompt=4, new=8)}
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


_SASS: dict[str, str] = {}


def sass_count(lib: str, op: str) -> int | None:
    """Instructions whose opcode holds ``op`` in the SASS of the built
    library ``lib`` (disassembled once a run), or None where cuobjdump is
    missing."""
    import os
    import shutil
    from repro_torch.kernels import _build
    tool = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / \
        "cuobjdump"
    tool = str(tool) if tool.exists() else shutil.which("cuobjdump")
    if tool is None:
        return None
    if lib not in _SASS:
        _build.load(lib)
        sass = subprocess.run([tool, "-sass", str(_build.lib_path(lib))],
                              capture_output=True, text=True, timeout=300)
        if sass.returncode != 0:
            fail(f"cuobjdump: {sass.stderr.strip()[:500]}")
        _SASS[lib] = sass.stdout
    return _SASS[lib].count(op)


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
    import concurrent.futures
    libs = ("exemplar_gains", "greedy_select", "threshold_select")
    with concurrent.futures.ThreadPoolExecutor(len(libs) + 1) as pool:
        # cuobjdump over each library at once (each takes seconds)
        hgmma = pool.submit(hgmma_count)
        counts = dict(zip(libs, pool.map(lambda lib: sass_count(lib, "HMMA"),
                                         libs)))
        hgmma = hgmma.result()
    if None in counts.values():
        log("  cuobjdump not found: HMMA not counted")
        return {}
    for lib, n in counts.items():
        if n == 0:
            fail(f"{lib}: no HMMA instruction in the built library's SASS "
                 f"(the gain tile runs no tensor-core product)")
    log(f"HMMA in the SASS of the gain tile's libraries: {counts}; HGMMA in "
        f"flash_attention's: {hgmma}")
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
    # the shapes of the VLM, hybrid and encoder-decoder serving cells (the
    # prompts as the model's strided views), and whisper's self-attention
    # prefill of its 4-token prompt and decode against its 1,500 slots
    t0 = time.perf_counter()
    for arch in (VLM_ARCH, HYBRID_ARCH, ENCDEC_ARCH):
        for what, B, H, Hkv, S, T, D, causal, kv in attention_shapes(arch):
            seed += 1
            check(B, H, Hkv, S, T, D, torch.bfloat16, causal, kv, seed,
                  strided=S > 1)
    for S, T, causal, kv in ((4, 4, True, None), (1, 1500, False, 36)):
        seed += 1
        check(8, 6, 6, S, T, 64, torch.bfloat16, causal, kv, seed,
              strided=S > 1)
    log(f"  the VLM, hybrid and encoder-decoder shapes against plain: "
        f"{time.perf_counter() - t0:.1f} s")
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


#: the backward's training shapes: Qwen3-8B's attention at the training
#: cell's microbatch (B = 1 of 8 × 2,048) and whisper-tiny's encoder at its
#: serving batch, (what, B, H, Hkv, S, T, D, causal)
ATTN_BWD_SHAPES = [("train qwen3-8b", 1, 32, 8, 2048, 2048, 128, True),
                   ("train whisper-tiny encoder", 8, 6, 6, 1500, 1500, 64,
                    False)]


def attention_grads(q, k, v, do, causal):
    """``(o, dq, dk, dv, counts)``: ``ops.flash_attention`` under autograd
    on leaf copies of q, k, v, its backward for ``do``, and the launches
    the forward and backward counted."""
    import torch
    from repro_torch.kernels import ops
    qq, kk, vv = (t.detach().requires_grad_(True) for t in (q, k, v))
    ops.reset_launch_counts()
    with torch.enable_grad():
        o = ops.flash_attention(qq, kk, vv, causal=causal)
        dq, dk, dv = torch.autograd.grad(o, (qq, kk, vv), do)
    torch.cuda.synchronize()
    return o.detach(), dq, dk, dv, dict(ops.launch_counts)


#: the launches of one forward under autograd and its backward (the
#: route's own counters: :func:`bwd_launches`)
ATTN_BWD_LAUNCHES = {"flash_attention_prefill": 1,
                     "flash_attention_prefill_lse": 1,
                     "flash_attention_bwd_delta": 1,
                     "flash_attention_bwd_dkdv": 1,
                     "flash_attention_bwd_dq": 1, "flash_attention_decode": 0}
#: the tensor-core backward's own counters
BWD_WGMMA = ("flash_attention_bwd_dkdv_wgmma", "flash_attention_bwd_dq_wgmma")


def bwd_launches(D, dtype) -> dict:
    """The launches of one forward under autograd and its backward at head
    dim ``D`` in ``dtype``: ``ATTN_BWD_LAUNCHES``, the forward on
    ``prefill_route``'s kernel, the backward on ``bwd_route``'s (on the
    tensor cores no Δ pre-pass: the dQ kernel writes Δ)."""
    from repro_torch.kernels import flash_attention as fa
    wg = fa.bwd_route(dtype, D) == "wgmma"
    return dict(ATTN_BWD_LAUNCHES,
                flash_attention_prefill_wgmma=int(
                    fa.prefill_route(dtype, D) == "wgmma"),
                **{k: int(wg) for k in BWD_WGMMA},
                flash_attention_bwd_delta=int(not wg))


def phase_kernels_attention_bwd() -> None:
    """The flash_attention backward (``csrc/flash_attention_bwd.cu``) on the
    card against autograd of the plain version, fp32 and bf16: D ∈ {16, 64,
    128, 256} × group ∈ {1, 4, 8} × {causal S = T ragged, causal S < T (the
    offset), non-causal S ≠ T}, half of them on the model's strided views;
    S = 1 (a prefill kernel leaves the log-sum-exp); the training shapes of
    ``ATTN_BWD_SHAPES``.  Each case: dq, dk, dv within
    ``testing.ATTN_GRAD_TOL`` of the plain gradients, a second call equal
    to the bits, the launches of :func:`bwd_launches` counted (the forward
    on ``prefill_route``'s kernel, the backward on ``bwd_route``'s: bf16
    at D ∈ {64, 128} on the tensor cores); the kernels' registers, shared
    memory and spills, and HGMMA in the built library's SASS (none fails
    the phase, where cuobjdump exists)."""
    import torch
    from repro_torch import testing
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    worst: dict[str, float] = {}
    cases: dict[str, int] = {}
    n = 0

    def check(B, H, Hkv, S, T, D, dtype, causal, seed, strided):
        nonlocal n
        q, k, v = _qkv(B, H, Hkv, S, T, D, dtype, seed, strided)
        g = torch.Generator(device="cuda")
        g.manual_seed(seed + 1)
        do = torch.randn(q.shape, generator=g, device="cuda").to(dtype)
        what = (f"flash_attention backward {dtype} B={B} H={H} Hkv={Hkv} "
                f"S={S} T={T} D={D} causal={causal} strided={strided}")
        _, dq, dk, dv, counts = attention_grads(q, k, v, do, causal)
        route = fa.bwd_route(dtype, D)
        want = bwd_launches(D, dtype)
        got = {key: counts[key] for key in want}
        if got != want:
            fail(f"{what}: launches {got}, expected {want} (route {route})")
        cases[route] = cases.get(route, 0) + 1
        plain = ref.flash_attention_backward(q, k, v, do, causal=causal)
        for name, a, b in zip(("dq", "dk", "dv"), (dq, dk, dv), plain):
            if a.dtype != dtype or a.shape != b.shape:
                fail(f"{what}: {name} {a.dtype} {tuple(a.shape)}")
            try:
                share = testing.assert_grad_close(a, b, dtype,
                                                  f"{what}: {name}")
            except AssertionError as e:
                fail(str(e))
            key = f"{route} {dtype} {name}"
            worst[key] = max(worst.get(key, 0.0), share)
        again = attention_grads(q, k, v, do, causal)[1:4]
        if not all(torch.equal(a, b) for a, b in zip((dq, dk, dv), again)):
            fail(f"{what}: a second call gives other bits")
        n += 1
        return (dq, dk, dv), plain

    seed = 100
    for D in fa.HEAD_DIMS:
        for dtype in (torch.float32, torch.bfloat16):
            for G in (1, 4, 8):
                for S, T, causal in ((130, 130, True), (77, 200, True),
                                     (50, 333, False)):
                    check(2, 2 * G, 2, S, T, D, dtype, causal, seed,
                          strided=seed % 2 == 0)
                    seed += 1
        for dtype in (torch.float32, torch.bfloat16):
            check(1, 4, 1, 1, 9, D, dtype, False, seed, False)
            check(1, 4, 4, 1, 5, D, dtype, True, seed + 1, True)
            seed += 2
    for what, B, H, Hkv, S, T, D, causal in ATTN_BWD_SHAPES:
        check(B, H, Hkv, S, T, D, torch.bfloat16, causal, seed, True)
        seed += 1
        torch.cuda.empty_cache()
    build_log = _build.build_log.get("flash_attention_bwd", "")
    for marker in ("flash_bwd_delta_kernel", "flash_bwd_dkdv_kernel",
                   "flash_bwd_dq_kernel", "flash_bwd_dkdv_wgmma_kernel",
                   "flash_bwd_dq_wgmma_kernel"):
        for line in _ptxas_report(build_log, marker):
            log(f"  ptxas {line}")
    smem = {D: {kind: fa.bwd_smem_bytes(D, kind)
                for kind in fa.BWD_SMEM_KINDS
                if fa.bwd_smem_bytes(D, kind) >= 0} for D in fa.HEAD_DIMS}
    log(f"  backward shared memory per CTA by D: {smem}")
    n_hgmma = sass_count("flash_attention_bwd", "HGMMA")
    if n_hgmma is None:
        log("  cuobjdump not found: HGMMA not counted")
    elif n_hgmma == 0:
        fail("flash_attention_bwd: no HGMMA instruction in the built "
             "library's SASS (the tensor-core backward runs no wgmma)")
    else:
        log(f"  HGMMA instructions in the backward library's SASS: "
            f"{n_hgmma}")
    log(f"flash_attention backward vs plain: {n} cases agree, each twice to "
        f"the bit (dq, dk, dv within {testing.ATTN_GRAD_TOL[torch.float32]} "
        f"(fp32) / {testing.ATTN_GRAD_TOL[torch.bfloat16]} (bf16) of the "
        f"largest |value|); cases by route {cases}; worst share by route, "
        f"type and gradient: " + ", ".join(
            f"{key} {worst[key]:.3g}" for key in sorted(worst)))


def times_attention_bwd(launches: dict, cell: dict | None = None
                        ) -> list[dict]:
    """The backward's kernels (one row: a call, on ``bwd_route``'s route)
    at ``ATTN_BWD_SHAPES`` in bf16, held against autograd of the plain
    version there (whose run, timed once, is the plain time), timed beside
    the bound (5 products of 2·D a visible pair on the bf16 tensor cores,
    or the bytes of q, k, v, o, dO and the three gradients) and beside the
    backward of PyTorch's scaled_dot_product_attention (``enable_gqa``,
    under autograd).  ``launches``: {what: backward calls at that shape in
    a training step} (a row's ``launches``: those calls × a call's
    launches); ``cell``: the training cell, whose step the Qwen3-8B row's
    share is taken of (a call's time × calls a step / step time)."""
    import torch
    import torch.nn.functional as F
    from repro_torch import testing
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops, ref
    rows = []
    for what, B, H, Hkv, S, T, D, causal in ATTN_BWD_SHAPES:
        scale = 1.0 / D ** 0.5
        q, k, v = _qkv(B, H, Hkv, S, T, D, torch.bfloat16, 31, True)
        do = torch.randn(q.shape, device="cuda").to(torch.bfloat16)
        o, lse = fa.launch(q, k, v, causal=causal, scale=scale,
                           with_lse=True)
        grads = fa.launch_backward(q, k, v, o, lse, do, causal=causal,
                                   scale=scale)
        plain, plain_ms = timed_once(lambda: ref.flash_attention_backward(
            q, k, v, do, causal=causal))
        for name, a, b_ in zip(("dq", "dk", "dv"), grads, plain):
            try:
                testing.assert_grad_close(a, b_, torch.bfloat16,
                                          f"backward at {what}: {name}")
            except AssertionError as e:
                fail(str(e))
        err = max(testing.max_abs_err(a, b_) for a, b_ in zip(grads, plain))
        del grads, plain
        torch.cuda.empty_cache()
        ops.reset_launch_counts()
        fa.launch_backward(q, k, v, o, lse, do, causal=causal, scale=scale)
        per_call = sum(ops.launch_counts[key] for key in BWD_KERNELS)
        ms = cuda_ms(lambda: fa.launch_backward(q, k, v, o, lse, do,
                                                causal=causal, scale=scale),
                     runs=10)
        ops.reset_launch_counts()
        qs, ks, vs = (t.detach().requires_grad_(True) for t in (q, k, v))
        with torch.enable_grad():
            o_l = F.scaled_dot_product_attention(qs, ks, vs, is_causal=causal,
                                                 enable_gqa=True)
        lib = cuda_ms(lambda: torch.autograd.grad(
            o_l, (qs, ks, vs), do, retain_graph=True), runs=10)
        flops = 5 * 2 * B * H * D * visible_pairs(S, T, causal, None)
        nbytes = 2 * D * (4 * B * H * S + 4 * B * Hkv * T) + 4 * B * H * S
        t_ops, t_bytes = flops / PEAK_BF16, nbytes / PEAK_BYTES
        b = 1e3 * max(t_ops, t_bytes)
        by = "operations" if t_ops >= t_bytes else "bytes"
        calls = launches.get(what, 0)
        n = calls * per_call
        share = ""
        if cell is not None and what == ATTN_BWD_SHAPES[0][0]:
            share = (f"; {calls} calls a training step: "
                     f"{ms * calls / cell['step_ms']:.1%} of the cell's "
                     f"step ({cell['step_ms']:.1f} ms)")
        log(f"flash_attention backward {what}: B={B} H={H} Hkv={Hkv} S={S} "
            f"T={T} D={D} causal={causal}, bf16, route "
            f"{fa.bwd_route(torch.bfloat16, D)}: {ms:.4f} ms ({per_call} "
            f"launches), "
            f"plain {plain_ms:.4f} ms (the check's run), SDPA backward "
            f"{lib:.4f} ms, bound {b:.4f} ms by {by}{share}")
        rows.append({"name": f"flash_attention backward ({what})",
                     "route": "cuda",
                     "source": "src/repro_torch/kernels/csrc/"
                               "flash_attention_bwd.cu",
                     "replaces": "src/repro/kernels/flash_attention.py:91 "
                                 "(no TPU backward: autograd of "
                                 "src/repro/kernels/ref.py:322)",
                     "launches": n, "max_abs_err": err,
                     "ms": ms, "plain_ms": plain_ms, "bound_ms": b,
                     "bound_by": by, "library_ms": lib})
        del q, k, v, do, o, lse, o_l, qs, ks, vs
        torch.cuda.empty_cache()
    return rows


def _lm_prompt(cfg, batch: int, seq: int, device: str):
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    return SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                                  global_batch=batch, seed=SEED),
                       device).batch(0)["tokens"]


def _lm_inputs(cfg, batch: int, seq: int, device: str):
    """(prompt, embeds): SyntheticLM tokens and, for the VLM and the
    encoder-decoder families, the stub frontend's output as the JAX
    package's tests draw it, 0.02·N(0, 1) from the seed in bf16:
    ``frontend_tokens`` patch embeddings or ENCDEC_FRAMES frames."""
    import torch
    prompt = _lm_prompt(cfg, batch, seq, device)
    n = {"vlm": cfg.frontend_tokens, "encdec": ENCDEC_FRAMES}.get(
        cfg.family)
    if n is None:
        return prompt, None
    g = torch.Generator(device=device).manual_seed(SEED + 1)
    return prompt, (0.02 * torch.randn((batch, n, cfg.d_model), generator=g,
                                       device=device)).to(torch.bfloat16)


def lm_config(arch: str, **cuts):
    """``arch``'s configuration with its cell's cuts (:data:`LM_CUTS`) and
    ``cuts`` on top."""
    import dataclasses
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config(arch),
                               **{**LM_CUTS.get(arch, {}), **cuts})


def family_kernels(cfg) -> tuple:
    k = FAMILY_KERNEL[cfg.family]
    return k if isinstance(k, tuple) else (k,)


def moe_calls_per_pass(cfg) -> int:
    """MoE layers a forward pass runs (the hybrid's every moe_period-th)."""
    if cfg.family == "hybrid":
        return cfg.n_layers // cfg.moe_period
    return cfg.n_layers if cfg.is_moe else 0


def expected_launches(cfg, n_new: int) -> dict:
    """Kernel launches, by counter, of one prefill and ``n_new`` − 1 decode
    steps: one a layer and call of the family's kernel; the hybrid's one
    attention layer and 7 Mamba layers a period; the encoder-decoder's
    encoder layers, then each decoder layer's self- and cross-attention."""
    L, steps = cfg.n_layers, n_new - 1
    if cfg.family == "ssm":
        return {"wkv6_prefill": L, "wkv6_decode": L * steps}
    if cfg.family == "hybrid":
        P = L // cfg.attn_period
        m = P * (cfg.attn_period - 1)
        return {"flash_attention_prefill": P,
                "flash_attention_decode": P * steps,
                "wkv6_prefill": m, "wkv6_decode": m * steps}
    if cfg.family == "encdec":
        return {"flash_attention_prefill": cfg.encoder_layers + 2 * L,
                "flash_attention_decode": 2 * L * steps}
    return {"flash_attention_prefill": L, "flash_attention_decode": L * steps}


def call_shape(kernel: str, args, kwargs) -> tuple:
    """The shape key of a kernel call: flash_attention's (S, T,
    kv_valid_len), wkv6's (T, Dk, Dv)."""
    if kernel == "flash_attention":
        return (kernel, args[0].shape[2], args[1].shape[2],
                kwargs.get("kv_valid_len"))
    return (kernel, args[0].shape[2], args[0].shape[3], args[2].shape[3])


def shape_launches(serve: dict, kernel: str, S: int, T: int, kv="any"
                   ) -> int:
    """Launches of ``kernel`` at (S, T) — and at ``kv``, where given — in
    a serving run (``serve["launch_shapes"]``; wkv6: T = 1 or the prompt,
    and its Dk)."""
    return sum(n for k, s, t, v, n in serve["launch_shapes"]
               if k == kernel and s == S and t == T
               and (kv == "any" or v == kv))


def _flip_summary(flips: list, own: list) -> dict:
    """Route readings of a run that followed another's (``testing.follow_routes``):
    on the same router input, the tokens whose experts differ (each a near
    tie), the largest such margin in bf16 ulps and the smallest top-K margin;
    on the run's own input, how many differ and by how many ulps at most
    (the drift of the hidden states; read, not held)."""
    def n(fl):
        return int(sum(rf["flipped"].sum() for rf in fl))
    return {"route_flips": n(flips),
            "tokens_routed": int(sum(rf["flipped"].size for rf in flips)),
            "max_flip_ulps": max(rf["max_flip_ulps"] for rf in flips),
            "min_top_k_margin": min(rf["min_margin"] for rf in flips),
            "own_input_route_flips": n(own),
            "own_input_max_flip_ulps": max(rf["max_flip_ulps"] for rf in own)}


def phase_lm_parity(arch: str = LM_ARCH) -> dict:
    """``arch`` (Qwen3-8B, rwkv6-1.6b, the MoE configurations at 2 layers;
    internvl2-76b at 2 layers after 256 patch embeddings; jamba at one
    period with 4 experts and a 128-token prompt; whisper-tiny whole on
    1,500 frames) at full width, one set of weights: prefill a SyntheticLM
    prompt and decode on the card, and the same on the CPU through the
    plain versions, fed the card's tokens; logits within LM_PARITY_TOL
    (the hybrid's 8 layers: HYBRID_PARITY_TOL) at every step, and the
    card's pick the CPU's or within that bound of the CPU's best (the
    near-tie rule); the family's kernels launched as
    :func:`expected_launches` says.

    MoE: bf16 router logits tie often, so a token's K experts can differ
    between the card and the CPU.  At every MoE call the CPU's router is
    held on the card's router input: where its top K of that input differs
    from the card's, its K-th and (K+1)-th logits must lie within one bf16
    ulp (``testing.route_flips``).  The CPU run then dispatches the card's
    experts (its own router weights at them), so its hidden states, which
    drift from the card's by bf16 rounding, do not carry the two apart
    through a flip, and every sequence's logits are held.  Returns the
    flips on the same input, the smallest top-K margin, the flips the
    CPU's own routes would have made on its own input, and the largest
    logit error on the sequences with no such flip beside the whole's."""
    import contextlib
    import torch
    from repro_torch import testing
    from repro_torch.kernels import ops
    from repro_torch.models import get_model
    from repro_torch.models import layers as L
    c = parity_cell(arch)
    cfg = lm_config(arch, n_layers=c["layers"])
    B = c["batch"]
    routed = cfg.is_moe
    tol = HYBRID_PARITY_TOL if cfg.family == "hybrid" else LM_PARITY_TOL
    params = get_model(cfg).init_params(cfg, device="cuda", seed=SEED)
    prompt, embeds = _lm_inputs(cfg, B, c["prompt"], "cuda")
    card_routes, flips, own = [], [], []
    plain = contextlib.nullcontext()

    def run(p, toks_in, device):
        return greedy_logits(cfg, p, prompt, embeds, c, device, toks_in)

    ops.reset_launch_counts()
    with (L.route_hook(testing.record_routes(card_routes)) if routed
          else plain):
        card_logits, card_toks = run(params, None, "cuda")
    torch.cuda.synchronize()
    counts = dict(ops.launch_counts)
    want = expected_launches(cfg, c["new"])
    if any(counts[name] != n for name, n in want.items()):
        fail(f"LM parity ({arch}): launches {counts}, not {want}")
    card_routes = [(hc.cpu(), e.cpu()) for hc, e in card_routes]
    cpu_params = L.tree_map(lambda t: t.to("cpu"), params)
    del params
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    try:
        with (L.route_hook(testing.follow_routes(card_routes, flips, own))
              if routed else plain):
            cpu_logits, cpu_toks = run(cpu_params, card_toks, "cpu")
    except AssertionError as exc:
        fail(f"LM parity ({arch}): {exc}")
    t_cpu = time.perf_counter() - t0
    err = float(torch.max(torch.abs(card_logits - cpu_logits)))
    per_step = torch.abs(card_logits - cpu_logits).amax(dim=(0, 2)).tolist()
    card_tok = torch.cat(card_toks, 1)
    best = cpu_logits.max(dim=-1).values
    picked = torch.take_along_dim(cpu_logits, card_tok[..., None].long(),
                                  dim=-1)[..., 0]
    differ = card_tok != torch.cat(cpu_toks, 1)
    gap = float(torch.max(best - picked))
    res = {"max_abs_dlogit": err, "max_abs_dlogit_per_step": per_step,
           "pick_gap": gap, "cpu_s": t_cpu}
    moe_note = ""
    if routed:
        if len(flips) != len(card_routes):
            fail(f"LM parity ({arch}): {len(flips)} CPU router calls for "
                 f"{len(card_routes)} on the card")
        clean = torch.ones((B,), dtype=torch.bool)
        for rf in own:
            clean &= ~torch.from_numpy(rf["flipped"].reshape(B, -1).any(-1))
        res.update(
            **_flip_summary(flips, own),
            sequences_without_flip=int(clean.sum()),
            max_abs_dlogit_without_flip=(
                float(torch.max(torch.abs(card_logits[clean]
                                          - cpu_logits[clean])))
                if clean.any() else None))
        moe_note = (f"; routes on the card's router input: "
                    f"{res['route_flips']} of {res['tokens_routed']} token "
                    f"routings differ (every one within one bf16 ulp, the "
                    f"largest {res['max_flip_ulps']!r} ulps), smallest "
                    f"top-K margin {res['min_top_k_margin']!r}; the CPU "
                    f"run dispatched the card's experts, where its own "
                    f"routes on its own input would differ at "
                    f"{res['own_input_route_flips']} (up to "
                    f"{res['own_input_max_flip_ulps']!r} ulps); max "
                    f"|dlogit| on the {res['sequences_without_flip']} of "
                    f"{B} sequences with no such flip "
                    f"{res['max_abs_dlogit_without_flip']!r}")
    log(f"LM parity, {arch} at full width and {c['layers']} layers "
        f"({cfg.n_experts or 'no'} experts, B={B}, prompt {c['prompt']}"
        f"{'' if embeds is None else f' after {embeds.shape[1]} embeddings'}"
        f", {c['new']} tokens): card vs "
        f"CPU max |dlogit| {err!r} over {c['new']} steps ({per_step}; "
        f"logits up to "
        f"{float(cpu_logits.abs().max()):.3f}); picks differing "
        f"{int(differ.sum())}, CPU's best minus its logit at the card's "
        f"pick up to {gap!r}; CPU side {t_cpu:.1f} s; launches "
        f"{counts}{moe_note}")
    if err > tol:
        fail(f"LM parity ({arch}): card and CPU logits differ by {err} > "
             f"{tol}")
    if gap > tol:
        fail(f"LM parity ({arch}): a card pick is {gap} below the CPU's "
             f"best (> {tol})")
    return res


def parity_cell(arch: str) -> dict:
    """The parity run's layers, batch, prompt and new tokens for ``arch``."""
    return LM_PARITY_BY_ARCH.get(arch, MOE_PARITY if arch in MOE_PARITY_ARCHS
                                 else LM_PARITY)


def greedy_logits(cfg, params, prompt, embeds, cell: dict, device,
                  toks_in=None):
    """Prefill ``prompt`` (after ``embeds``) and decode ``cell["new"]`` − 1
    greedy steps through the serve fns on ``device``, fed ``toks_in`` where
    given (another run's tokens) and the run's own picks otherwise.
    Returns the last position's fp32 logits at each step (B, new, V) on
    the host and the tokens picked."""
    import torch
    from repro_torch.serve import make_serve_fns
    from repro_torch.serve.serve_step import next_token
    cache_len = cell["prompt"] + cell["new"]
    if cfg.family == "encdec":
        cache_len = max(cache_len, ENCDEC_FRAMES)
    pf, df = make_serve_fns(cfg, cache_len)
    lg, cache = pf(params, prompt.to(device),
                   None if embeds is None else embeds.to(device))
    logits, toks = [lg[:, -1].float().cpu()], [next_token(lg)]
    for t in range(cell["new"] - 1):
        feed = toks[-1] if toks_in is None else toks_in[t].to(device)
        lg, cache = df(params, cache, feed)
        logits.append(lg[:, -1].float().cpu())
        toks.append(next_token(lg))
    return torch.stack(logits, 1), [t.cpu() for t in toks]


def lm_drift(arch: str = HYBRID_ARCH) -> dict:
    """How far the bf16 evaluations of ``arch``'s parity cell sit from each
    other and from the fp32 evaluation of the same weights: on the card in
    bf16 (its MoE routes recorded), on the CPU's plain path in bf16, and on
    the card with ``COMPUTE_DTYPE`` and the caches in fp32 (the bf16
    weights' values in fp32), the last two fed the card's tokens and
    dispatching its experts.  Logs and returns each pair's max |dlogit|
    per step.  Not run by :func:`main` (the fp32 weights of jamba's period
    are 66 GB on the card); it measured the basis of
    :data:`HYBRID_PARITY_TOL`:
    ``python3 -c "import chip_smoke as c; c.phase_setup(); c.lm_drift()"``."""
    import functools
    import torch
    from repro_torch import testing
    from repro_torch.models import get_model
    from repro_torch.models import layers as L
    c = parity_cell(arch)
    cfg = lm_config(arch, n_layers=c["layers"])
    model = get_model(cfg)
    params = model.init_params(cfg, device="cuda", seed=SEED)
    prompt, embeds = _lm_inputs(cfg, c["batch"], c["prompt"], "cuda")
    routes = []
    with L.route_hook(testing.record_routes(routes)):
        card, toks = greedy_logits(cfg, params, prompt, embeds, c, "cuda")
    routes = [(hc.cpu(), e.cpu()) for hc, e in routes]
    host = L.tree_map(lambda t: t.to("cpu"), params)
    del params
    torch.cuda.empty_cache()
    with L.route_hook(testing.follow_routes(routes, [])):
        cpu, _ = greedy_logits(cfg, host, prompt, embeds, c, "cpu", toks)
    saved = (L.COMPUTE_DTYPE, model.init_cache)
    L.COMPUTE_DTYPE = torch.float32
    model.init_cache = functools.partial(saved[1], dtype=torch.float32)
    try:
        p32 = L.tree_map(lambda t: t.to("cuda").float(), host)
        with L.route_hook(testing.follow_routes(
                [(hc.float(), e) for hc, e in routes], [])):
            fp32, _ = greedy_logits(cfg, p32, prompt, embeds, c, "cuda",
                                    toks)
    finally:
        L.COMPUTE_DTYPE, model.init_cache = saved
    del p32
    torch.cuda.empty_cache()

    def d(a, b):
        return torch.abs(a - b).amax(dim=(0, 2)).tolist()

    res = {"card_vs_cpu": d(card, cpu), "card_vs_fp32": d(card, fp32),
           "cpu_vs_fp32": d(cpu, fp32),
           "max_abs_logit": float(fp32.abs().max())}
    log(f"LM drift, {arch} ({cfg.n_layers} layers, B={c['batch']}, prompt "
        f"{c['prompt']}, {c['new']} tokens), max |dlogit| per step: "
        f"{json.dumps(res)}")
    return res


def _drop_shares(cfg, calls: list) -> dict:
    """Assignments dropped per MoE layer over one serving run's MoE calls
    (each call's experts ``top_e`` (B, S, K) in order, layer by layer): the
    prefill's share per layer (calls with S > 1), the decode's per layer
    over its steps."""
    from repro_torch.models import layers as L
    n_layers = moe_calls_per_pass(cfg)
    pre = [0.0] * n_layers
    dec_kept, dec_all = [0.0] * n_layers, [0] * n_layers
    dropped, n_pre = 0, 0
    for i, top_e in enumerate(calls):
        kept, total = int(L.kept_assignments(cfg, top_e)), top_e.numel()
        dropped += total - kept
        if top_e.shape[1] > 1:
            pre[n_pre % n_layers] = 1.0 - kept / total
            n_pre += 1
        else:
            dec_kept[i % n_layers] += kept
            dec_all[i % n_layers] += total
    dec = [1.0 - k / a if a else 0.0 for k, a in zip(dec_kept, dec_all)]
    return {"dropped": dropped, "prefill_share_per_layer": pre,
            "decode_share_per_layer": dec}


def moe_product_times(cfg, params, prefill_ms: float, decode_ms: float
                      ) -> dict:
    """One MoE layer's parts at the serving cell's prefill and decode
    shapes, each timed alone (CUDA events) on layer 0's weights and a
    random residual: the router with its top K, the one-hot masks, the
    dispatch product, the expert products, the combine product, the shared
    experts, and the whole layer; times the layer count against prefill
    and decode per token."""
    import torch
    from repro_torch.models import layers as L
    c = LM_SERVE
    p = L.slice_layer(params["moe"], 0)
    out = {}
    for what, S, whole in (("prefill", c["prompt"], prefill_ms),
                           ("decode", 1, decode_ms)):
        B, d, K, E = c["batch"], cfg.d_model, cfg.experts_per_token, \
            cfg.n_experts
        gen = torch.Generator(device="cuda").manual_seed(SEED)
        x = torch.randn((B, S, d), generator=gen, device="cuda").to(
            torch.bfloat16)
        hc = L.cast(L.rms_norm(x, p["ln"], cfg.norm_eps))
        _, top_w, top_e = L.route(p, hc, cfg)
        G, gsz = L.groups(cfg, B, S)
        C = L.capacity(cfg, gsz)
        xg = hc.reshape(G, gsz, d)
        tw, te = top_w.reshape(G, gsz, K), top_e.reshape(G, gsz, K)
        disp, comb = L._onehot_masks(tw, te, E, K, C)
        buf = torch.einsum("gtec,gtd->gecd", disp, xg)
        eo = L._experts(p["experts"], buf, cfg)
        runs = 20 if S == 1 else 5
        parts = {
            "route": lambda: L.route(p, hc, cfg),
            "masks": lambda: L._onehot_masks(tw, te, E, K, C),
            "dispatch": lambda: torch.einsum("gtec,gtd->gecd", disp, xg),
            "experts": lambda: L._experts(p["experts"], buf, cfg),
            "combine": lambda: torch.einsum("gtec,gecd->gtd", comb, eo),
            "layer": lambda: L.moe(p, x, cfg),
        }
        if "shared" in p:
            sp = p["shared"]
            parts["shared"] = lambda: (
                L._act(hc @ sp["w_gate"], cfg.gate_fn)
                * (hc @ sp["w_up"])) @ sp["w_down"]
        ms = {name: cuda_ms(fn, runs=runs) for name, fn in parts.items()}
        dc = ms["dispatch"] + ms["combine"]
        out[what] = {
            "B": B, "S": S, "groups": G, "group_tokens": gsz, "capacity": C,
            "ms_per_layer": ms,
            "dispatch_combine_ms_model": dc * cfg.n_layers,
            "experts_ms_model": ms["experts"] * cfg.n_layers,
            "moe_ms_model": ms["layer"] * cfg.n_layers,
            "dispatch_combine_share": dc * cfg.n_layers / whole,
            "experts_share": ms["experts"] * cfg.n_layers / whole,
        }
        del x, hc, disp, comb, buf, eo
    torch.cuda.empty_cache()
    return out


def phase_lm_serve(arch: str = LM_ARCH) -> dict:
    """``arch`` (Qwen3-8B, rwkv6-1.6b, deepseek-moe-16b; internvl2-76b and
    jamba-1.5-large-398b with their cuts, :data:`LM_CUTS`; whisper-tiny)
    at full width on the card through greedy_generate: 8 SyntheticLM
    prompts of 2,048 tokens (whisper: 4 tokens after 1,500 frames; the
    VLM's after 256 patch embeddings), 32 new tokens, cache 2,080
    (whisper 1,500).  Every launch counter of the family's kernels moved
    as :func:`expected_launches` says (every flash_attention prefill on
    the tensor-core route, every wkv6 prefill on the recurrent kernel);
    the last decode step's logits agree with forward over the prompt and
    the generated tokens within LM_SERVE_TOL (MoE and the hybrid: with
    the same weights at a capacity factor under which nothing drops,
    ⌈E/K⌉, as ``reduced()`` does, since drops legitimately differ between
    batch shapes; the decode teacher-forced with the served tokens;
    forward's router held on that decode's router input, every token whose
    experts differ there within one bf16 ulp, and forward dispatching the
    decode's experts).  Times prefill and each decode step (CUDA events),
    the memory peak, each kernel's share of both (events around each call
    of it, a run of its own, which also counts its launches by shape), and
    the device time of one prefill and one decode step replayed from a
    CUDA graph (so 1 − device / wall is the share the device idles while
    the host launches).  MoE and the hybrid: the share of (token, expert)
    assignments dropped per layer; MoE: the dispatch and combine products
    timed apart from the expert products (:func:`moe_product_times`)."""
    import collections
    import dataclasses
    import torch
    from repro_torch import testing
    from repro_torch.kernels import ops
    from repro_torch.models import get_model
    from repro_torch.models import layers as L
    from repro_torch.serve import greedy_generate, make_serve_fns
    from repro_torch.serve.serve_step import next_token
    c = LM_SERVE_BY_ARCH.get(arch, LM_SERVE)
    cfg = lm_config(arch)
    model, kerns = get_model(cfg), family_kernels(cfg)
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
                  for t in L.tree_leaves(params))
    prompt, embeds = _lm_inputs(cfg, B, S, "cuda")
    moe_calls = []

    def served_experts(p, hc, cfg_, routed):
        moe_calls.append(routed[2])
        return routed[1], routed[2]

    ops.reset_launch_counts()
    with L.route_hook(served_experts):
        out = greedy_generate(cfg, params, prompt, n_new,
                              cache_len=c["cache_len"], embeds=embeds)
    torch.cuda.synchronize()
    counts = dict(ops.launch_counts)
    drops = _drop_shares(cfg, moe_calls) if cfg.is_moe else None
    del moe_calls
    for name, n in expected_launches(cfg, n_new).items():
        if counts[name] != n:
            fail(f"LM serve ({arch}): {name} launched {counts[name]} times, "
                 f"not {n}")
    if "wkv6" in kerns and (counts["wkv6_recurrent"]
                            + counts["wkv6_chunked"] // 3
                            != counts["wkv6_prefill"]):
        fail(f"LM serve ({arch}): the recurrent kernel launched "
             f"{counts['wkv6_recurrent']} times for "
             f"{counts['wkv6_prefill']} prefill calls (every decode step "
             f"belongs to the decode kernel)")
    if ("flash_attention" in kerns
            and counts["flash_attention_prefill_wgmma"]
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
        lg, cache = pf(params, prompt, embeds)
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
    # one more decode step (the cache's last position) and one more
    # prefill, each timed on the device alone
    pos, tok = cache["pos"], toks[:, -1:]

    def decode_at_pos():
        df(params, cache, tok)
        cache["pos"] = pos

    dev_decode = device_ms(decode_at_pos)
    del cache
    dev_prefill = device_ms(lambda: pf(params, prompt, embeds))
    torch.cuda.empty_cache()
    if not torch.equal(toks, out):
        fail(f"LM serve ({arch}): a second run through the serve fns picked "
             "other tokens than greedy_generate")
    # each kernel's share: events around every call of it
    calls = []
    origs = {k: getattr(ops, k) for k in kerns}

    def timed_kernel(kernel):
        def timed(*a, **kw):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            o = origs[kernel](*a, **kw)
            e1.record()
            calls.append((call_shape(kernel, a, kw), e0, e1))
            return o
        return timed

    for k in kerns:
        setattr(ops, k, timed_kernel(k))
    try:
        prefill_ms2, steps2, _, toks2, _ = serve_once()
    finally:
        for k, fn in origs.items():
            setattr(ops, k, fn)
    if not torch.equal(toks2, out):
        fail(f"LM serve ({arch}): the timed run picked other tokens")
    shares = {}
    for k in kerns:
        pre = sum(e0.elapsed_time(e1) for key, e0, e1 in calls
                  if key[0] == k and key[1] > 1)
        dec = sum(e0.elapsed_time(e1) for key, e0, e1 in calls
                  if key[0] == k and key[1] == 1)
        shares[k] = {"share_prefill": pre / prefill_ms2,
                     "share_decode": dec / sum(steps2), "prefill_ms": pre,
                     "decode_ms_per_token": dec / (n_new - 1)}
    by_shape = collections.Counter(key for key, _, _ in calls)
    for k in kerns:
        if (sum(n for key, n in by_shape.items() if key[0] == k)
                != counts[f"{k}_prefill"] + counts[f"{k}_decode"]):
            fail(f"LM serve ({arch}): the timed run called {k} other times "
                 f"than the served run launched it ({dict(by_shape)})")
    del calls

    check_cfg = cfg
    if cfg.is_moe:
        # nothing drops where C ≥ the group: cf ≥ E / K
        check_cfg = dataclasses.replace(cfg, moe_capacity_factor=float(
            math.ceil(cfg.n_experts / cfg.experts_per_token)))
        served = []
        with L.route_hook(testing.record_routes(served)):
            pfn, dfn = make_serve_fns(check_cfg, c["cache_len"])
            last, cache = pfn(params, prompt, embeds)
            for t in range(n_new - 1):
                last, cache = dfn(params, cache, out[:, t:t + 1])
        del cache
        nodrop = _drop_shares(check_cfg, [e for _, e in served])
        # forward over the same positions: its router held on the served
        # run's router input, and dispatching the served experts (bf16
        # router logits tie often, and the cached and the full paths
        # round apart, so the two runs' own routes may part)
        nl, flips, own = moe_calls_per_pass(cfg), [], []
        targets = [tuple(torch.cat([served[l][j]] + [
            served[nl * (t + 1) + l][j] for t in range(n_new - 1)], 1)
            for j in (0, 1)) for l in range(nl)]
        del served
        try:
            with L.route_hook(testing.follow_routes(targets, flips, own)):
                # the whole 2,080 tokens (2,048 + 31 do not split into the
                # dispatch groups); causal, and with no drops a token's
                # output does not depend on its group: position −2 is the
                # last decode step's
                full = model.forward(params, check_cfg,
                                     torch.cat([prompt, out], 1),
                                     embeds=embeds)[:, :-1]
        except AssertionError as exc:
            fail(f"LM serve ({arch}), forward: {exc}")
        del targets
        forward_flips = _flip_summary(flips, own)
        if nodrop["dropped"]:
            fail(f"LM serve ({arch}): {nodrop['dropped']} assignments "
                 f"dropped at capacity factor "
                 f"{check_cfg.moe_capacity_factor}")
    else:
        full = model.forward(params, cfg, torch.cat([prompt, out[:, :-1]], 1),
                             embeds=embeds)
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
           "kernel": kerns[0] if len(kerns) == 1 else list(kerns),
           "kernel_share_prefill": sum(v["share_prefill"]
                                       for v in shares.values()),
           "kernel_share_decode": sum(v["share_decode"]
                                      for v in shares.values()),
           "kernel_prefill_ms": sum(v["prefill_ms"]
                                    for v in shares.values()),
           "kernel_decode_ms_per_token": sum(v["decode_ms_per_token"]
                                             for v in shares.values()),
           "prefill_device_ms": dev_prefill, "decode_device_ms": dev_decode,
           "decode_device_idle_share": 1.0 - dev_decode / decode_ms,
           "prefill_device_idle_share": 1.0 - dev_prefill / prefill_ms,
           "decode_vs_forward": err, "launches": counts,
           "launch_shapes": [[*key, n] for key, n in by_shape.items()],
           "init_s": t_init}
    if len(kerns) > 1:
        res["kernel_shares"] = shares
    if cfg.is_moe:
        res.update(moe_drops=drops,
                   moe_check_capacity_factor=check_cfg.moe_capacity_factor,
                   moe_forward_route_flips=forward_flips)
    if cfg.family == "moe":
        res["moe_products"] = moe_product_times(cfg, params, prefill_ms,
                                                decode_ms)
    front = "" if embeds is None else f" after {embeds.shape[1]} embeddings"
    log(f"LM serve, {arch} ({cfg.n_layers} layers, d_model "
        f"{cfg.d_model}, {cfg.n_experts or 'no'} experts, "
        f"{w_bytes / 1e9:.2f} GB of weights, init {t_init:.1f} s): B={B}, "
        f"prompt {S}{front}, {n_new} new tokens, cache {c['cache_len']}; "
        f"launches {counts}; tokens[0, :8] {out[0, :8].tolist()}")
    log(f"LM serve: {json.dumps(res)}")
    if err > LM_SERVE_TOL:
        fail(f"LM serve ({arch}): last decode step vs forward {err} > "
             f"{LM_SERVE_TOL}")
    del params
    torch.cuda.empty_cache()
    return res


def attention_shapes(arch: str) -> list[tuple]:
    """(what, B, H, Hkv, S, T, D, causal, kv_valid_len) of each
    flash_attention shape of ``arch``'s serving cell: the prompt's prefill
    and the decode against the whole cache (the VLM's 256 patch positions
    counted); whisper's encoder over its frames, the cross-attention's
    prefill of the prompt against them and its decode under
    kv_valid_len = the frame count."""
    cfg = lm_config(arch)
    c = LM_SERVE_BY_ARCH.get(arch, LM_SERVE)
    B, H, Hkv, D = c["batch"], cfg.n_heads, cfg.n_kv_heads, cfg.hd
    if cfg.family == "encdec":
        F = ENCDEC_FRAMES
        return [("encoder", B, H, Hkv, F, F, D, False, None),
                ("cross prefill", B, H, Hkv, c["prompt"], F, D, False, None),
                ("cross decode", B, H, Hkv, 1, c["cache_len"], D, False, F)]
    extra = cfg.frontend_tokens if cfg.family == "vlm" else 0
    S, T = c["prompt"] + extra, c["cache_len"] + extra
    return [("prefill", B, H, Hkv, S, S, D, True, None),
            ("decode", B, H, Hkv, 1, T, D, False, T)]


def times_attention(serve: dict, arch: str = LM_ARCH) -> list[dict]:
    """flash_attention at ``arch``'s serving cell's shapes
    (:func:`attention_shapes`; for Qwen3-8B also the 32k prefill), bf16:
    held against its plain version there, timed beside it, beside its
    bound and beside PyTorch's scaled_dot_product_attention on the same
    inputs; each row's launches those of its shape in the serving run."""
    import torch
    import torch.nn.functional as F
    from repro_torch import testing
    from repro_torch.kernels import ops, ref
    a = ATTN_32K
    shapes = []
    for what, B, H, Hkv, S, T, D, causal, kv in attention_shapes(arch):
        n = shape_launches(serve, "flash_attention", S, T,
                           kv if what == "cross decode" else "any")
        shapes.append((what if arch == LM_ARCH else f"{what}, {arch}", B, H,
                       Hkv, S, T, D, causal, kv, n, 50 if S == 1 else 10))
    if arch == LM_ARCH:
        shapes.append(("prefill 32k", a["B"], a["H"], a["Hkv"], a["S"],
                       a["S"], a["D"], True, None,
                       serve["launches"]["flash_attention_prefill"], 3))
    rows = []
    for what, B, H, Hkv, S, T, D, causal, kv, launches, runs in shapes:
        q, k, v = _qkv(B, H, Hkv, S, T, D, torch.bfloat16, 7)
        o = ops.flash_attention(q, k, v, causal=causal, kv_valid_len=kv)
        o_p, plain = timed_once(lambda: ref.flash_attention(
            q, k, v, causal=causal, kv_valid_len=kv))
        testing.assert_attention_close(o, o_p, True,
                                       f"flash_attention at the {what} shape")
        err = testing.max_abs_err(o, o_p)
        del o, o_p
        torch.cuda.empty_cache()
        ms = cuda_ms(lambda: ops.flash_attention(q, k, v, causal=causal,
                                                 kv_valid_len=kv), runs=runs)
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
    """r, k, v ~ N(0, 1) and u ~ 0.1·N(0, 1) in ``dtype``, w fp32 in (0, 1]
    on the card: ``decay`` "model" is the decay of the model at its init,
    exp(−exp(−6 + N(0, 1)/2)) ≈ 0.9975 (a state that remembers ~400
    steps), "fast" is sigmoid(N(0, 1) + 2), as tests/test_kernels.py draws
    it, and a number is that constant decay (the strong decays 0.5, 0.05,
    1e-6 of a trained model's fast channels).  ``strided``: each a (B, H,
    T, D) view of a (B, T, H, D) tensor, as the model passes them."""
    import torch
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)

    def draw(D, dt):
        x = torch.randn((B, T, H, D), generator=g, device="cuda").to(dt)
        return x.transpose(1, 2) if strided else x.transpose(1, 2).contiguous()

    r, k, v = draw(Dk, dtype), draw(Dk, dtype), draw(Dv, dtype)
    n = draw(Dk, torch.float32)
    if decay == "model":
        w = torch.exp(-torch.exp(-6.0 + 0.5 * n))
    elif decay == "fast":
        w = torch.sigmoid(n + 2.0)
    else:
        w = torch.full_like(n, float(decay))
    u = (0.1 * torch.randn((H, Dk), generator=g, device="cuda")).to(dtype)
    return r, k, v, w, u


def wkv6_bound(B, H, T, Dk, Dv, itemsize, state_in, y_itemsize):
    """(bound ms, by, fp32-only bound ms): the bytes of r, k, v and u
    (``itemsize``), w (fp32), y (``y_itemsize``) and the fp32 state, read
    where given and written, each moved once, against 5·Dk·Dv + 3·Dk + 2·Dv
    operations per step and head (the state update w·S + k·v, r·S, the
    bonus (r·u)·k and v·a) at the TF32 tensor-core rate; the fp32-only
    bound takes the operations at the fp32 rate (the recurrent kernel's
    CUDA cores)."""
    steps = B * H * T
    flops = steps * (5 * Dk * Dv + 3 * Dk + 2 * Dv)
    nbytes = (steps * ((2 * Dk + Dv) * itemsize + 4 * Dk + Dv * y_itemsize)
              + H * Dk * itemsize + 4 * B * H * Dk * Dv * (1 + int(state_in)))
    t_tc, t_bytes = flops / PEAK_TF32, nbytes / PEAK_BYTES
    fp32_only, _ = bound_ms(flops, nbytes)
    return (1e3 * max(t_tc, t_bytes),
            "operations" if t_tc >= t_bytes else "bytes", fp32_only)


def wkv6_readings(y, st, y_p, st_p, terms, bf16) -> dict:
    """The chunked kernel against the plain recurrence: the error model's
    reading (max |Δ|/m, y and state) and the elements outside the
    unchanged RTOL/ATOL checks."""
    import torch
    from repro_torch import testing
    rt = testing.BF16_RTOL if bf16 else testing.RTOL

    def outside(a, b, rtol):
        a, b = a.double(), b.double()
        return int(torch.sum((a - b).abs() > testing.ATOL + rtol * b.abs()))

    return {"terms_ratio_y": testing.terms_ratio(y, y_p, terms[0], bf16),
            "terms_ratio_state": testing.terms_ratio(st, st_p, terms[1]),
            "outside_rtol_atol": outside(y.float(), y_p.float(), rt)
            + outside(st, st_p, testing.RTOL)}


def phase_kernels_wkv6() -> None:
    """wkv6 against its plain version on the card, fp32 and bf16: Dk = Dv
    = 64 and 16, Dk ≠ Dv, ragged T, B × H = 1 and 256, r/k/v/w as the
    model's strided views and contiguous, from zeros and from a given
    state, T = 2,100, the strong decays 0.5, 0.05 and 1e-6 over several
    chunks; two launches over parts of T against one over all of it; one
    decode step (T = 1) from a state written in place; the shapes it does
    not take raise.  Each case through the routed kernel (``ops.wkv6``:
    the recurrent kernel, which repeats the plain version's arithmetic op
    for op) held by testing's tolerance, the bitwise agreements counted;
    and through the chunked kernel (``wkv6.launch_chunked``), held by the
    error model (``testing.WKV_TERMS_RTOL``) at every case, its elements
    outside the same tolerance counted by decay: where the terms cancel
    (y or a state entry near 0 against a large Σ|terms|) the tolerance
    holds no summation order but the recurrence's own, the exact sum
    included (``tests/test_torch_wkv6_chunked.py``)."""
    import torch
    from repro_torch import testing
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import wkv6 as wk
    worst = {torch.float32: 0.0, torch.bfloat16: 0.0}
    ratio = {"y": 0.0, "state": 0.0}
    outside = {}   # elements outside RTOL/ATOL, chunked kernel, by decay
    n = same = n_chunked = 0

    def check(y, st, y_p, st_p, bf16, what):
        nonlocal n, same
        testing.assert_attention_close(y, y_p, bf16, f"{what}: y")
        testing.assert_close(st, st_p, f"{what}: state")
        worst[torch.bfloat16 if bf16 else torch.float32] = max(
            worst[torch.bfloat16 if bf16 else torch.float32],
            testing.max_abs_err(y, y_p), testing.max_abs_err(st, st_p))
        n += 1
        same += int(torch.equal(y, y_p) and torch.equal(st, st_p))

    def check_chunked(y, st, y_p, st_p, terms, bf16, decay, what):
        nonlocal n_chunked
        ratio["y"] = max(ratio["y"], testing.assert_within_terms(
            y, y_p, terms[0], bf16, f"chunked {what}: y"))
        ratio["state"] = max(ratio["state"], testing.assert_within_terms(
            st, st_p, terms[1], False, f"chunked {what}: state"))
        key = f"{decay} {'bf16' if bf16 else 'fp32'}"
        outside[key] = outside.get(key, 0) + wkv6_readings(
            y, st, y_p, st_p, terms, bf16)["outside_rtol_atol"]
        n_chunked += 1

    # (dtype, case), the strong decays last so the earlier cases keep
    # their seeds
    runs = []
    for dtype in (torch.float32, torch.bfloat16):
        small = 4 if dtype == torch.float32 else 8
        runs += [(dtype, case) for case in (
            (2, 3, 37, 16, 16, "fast", True),
            (1, 1, 100, 64, 64, "model", True),
            (8, 32, 70, 64, 64, "model", True),
            (2, 2, 45, 16, 64, "fast", True),
            (2, 2, 33, 64, 16, "fast", False),
            (1, 2, 20, small, 2 * small, "fast", False),
            (2, 4, 2100, 64, 64, "model", True))]
    runs += [(dtype, (2, 3, 300, 64, 64, decay, True))
             for dtype in (torch.float32, torch.bfloat16)
             for decay in (0.5, 0.05, 1e-6)]
    seed = 0
    for dtype, (B, H, T, Dk, Dv, decay, strided) in runs:
        for given in (False, True):
            seed += 1
            r, k, v, w, u = _wkv_inputs(B, H, T, Dk, Dv, dtype, seed,
                                        decay, strided)
            s0 = (torch.randn((B, H, Dk, Dv), device="cuda")
                  if given else None)
            bf16 = dtype == torch.bfloat16
            what = (f"wkv6 {dtype} B={B} H={H} T={T} Dk={Dk} Dv={Dv} "
                    f"{decay} strided={strided} state={given}")
            y, st = ops.wkv6(r, k, v, w, u, s0)
            torch.cuda.synchronize()
            y_p, st_p = ref.wkv6(r, k, v, w, u, s0)
            check(y, st, y_p, st_p, bf16, what)
            y, st = wk.launch_chunked(r, k, v, w, u, s0)
            torch.cuda.synchronize()
            check_chunked(y, st, y_p, st_p, testing.wkv6_terms(
                r, k, v, w, u, s0), bf16, decay, what)
    # state chaining, in place: the recurrent kernel over [0, 150) and
    # [150, 300) gives one call's bits; the chunked kernel the same on a
    # chunk boundary ([0, 128), [128, 300)), and at 150, where the chunk
    # grid moves with the split, the checks of one call against plain
    r, k, v, w, u = _wkv_inputs(2, 4, 300, 64, 64, torch.bfloat16, 91)
    y_p, st_p = ref.wkv6(r, k, v, w, u)
    terms = testing.wkv6_terms(r, k, v, w, u)
    for fn, cut in ((wk.launch, 150), (wk.launch_chunked, 128),
                    (wk.launch_chunked, 150)):
        y, st = fn(r, k, v, w, u)
        st2 = torch.empty_like(st)
        y1, _ = fn(*(a[:, :, :cut] for a in (r, k, v, w)), u, state_out=st2)
        y2, _ = fn(*(a[:, :, cut:] for a in (r, k, v, w)), u, st2,
                   state_out=st2)
        torch.cuda.synchronize()
        y12 = torch.cat([y1, y2], 2)
        if fn is wk.launch or cut % wk.CHUNK == 0:
            if not (torch.equal(y12, y) and torch.equal(st2, st)):
                fail(f"wkv6 {fn.__name__}: two launches split at {cut} of "
                     "300 differ from one")
        else:
            check_chunked(y12, st2, y_p, st_p, terms, True, "model",
                          f"two launches split at {cut}")
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
    n_dec = check_wkv6_decode()
    # the hybrid's Mamba scan as the model passes it (u = 0, Dk = 16, Dv =
    # 128, H = 128): the prompt from zeros on the recurrent kernel, then a
    # decode step in place on the decode kernel, y in fp32
    for what, B, H, T, Dk, Dv in mamba_scan_shapes():
        given = T == 1
        r, k, v, w, u = mamba_inputs(B, H, T, Dk, Dv, 93)
        state = torch.randn((B, H, Dk, Dv), device="cuda") if given else None
        before = state.clone() if given else None
        od = torch.float32 if given else None
        ops.reset_launch_counts()
        y, st = ops.wkv6(r, k, v, w, u, state, state_out=state, out_dtype=od)
        torch.cuda.synchronize()
        route = "wkv6_decode" if given else "wkv6_recurrent"
        if ops.launch_counts[route] != 1 or (given and st is not state):
            fail(f"wkv6 Mamba {what}: launches {dict(ops.launch_counts)}")
        y_p, st_p = ref.wkv6(r, k, v, w, u, before, out_dtype=od)
        check(y, st, y_p, st_p, not given,
              f"wkv6 Mamba {what} B={B} H={H} T={T} Dk={Dk} Dv={Dv}")
        del r, k, v, w, u, state, before, y, st, y_p, st_p
    for Dk, dtype in ((128, torch.bfloat16), (4, torch.bfloat16)):
        for T in (3, 1):
            r, k, v, w, u = _wkv_inputs(1, 1, T, Dk, 16, dtype, 0)
            for fn in (ops.wkv6, wk.launch_chunked):
                try:
                    fn(r, k, v, w, u)
                except ValueError:
                    pass
                else:
                    fail(f"wkv6 took Dk={Dk} in {dtype} at T={T}, which it "
                         "has no instantiation of")
    r, k, v, w, u = _wkv_inputs(1, 1, 2, 16, 16, torch.bfloat16, 0)
    try:
        wk.launch_decode(r, k, v, w, u)
    except ValueError:
        pass
    else:
        fail("the wkv6 decode kernel took T = 2")
    smem = {Dk: (wk.smem_bytes(Dk, False), wk.smem_bytes(Dk, True))
            for Dk in (16, 32, 64)}
    log(f"  shared memory per CTA (fp32, bf16 operands) by Dk, from the "
        f"built kernel: {smem}; chunked kernel (fp32, bf16) "
        f"{(wk.chunked_smem_bytes(False), wk.chunked_smem_bytes(True))}")
    n_hmma = sass_count("wkv6_chunked", "HMMA")
    if n_hmma is None:
        log("  cuobjdump not found: the chunked kernel's HMMA not counted")
    elif n_hmma == 0:
        fail("wkv6_chunked: no HMMA instruction in the built library's SASS")
    else:
        log(f"  HMMA instructions in the chunked kernel's SASS: {n_hmma}")
    log(f"wkv6 vs plain: {n} cases through ops.wkv6 (the recurrent kernel) "
        f"agree (fp32 within rtol={testing.RTOL} atol={testing.ATOL}, max "
        f"|d| {worst[torch.float32]!r}; bf16 y within rtol="
        f"{testing.BF16_RTOL:.5g}, max |d| {worst[torch.bfloat16]!r}), "
        f"{same} of them to the bit; the chunked kernel in {n_chunked} "
        f"cases within the error model (max |d|/m: y {ratio['y']!r}, state "
        f"{ratio['state']!r}; bound {testing.WKV_TERMS_RTOL!r}), elements "
        f"outside that tolerance by decay and type {outside}; chaining over "
        f"parts of T and the in-place decode step checked; the decode "
        f"kernel in {n_dec} T = 1 cases to the bit")


def check_wkv6_decode() -> int:
    """Every T = 1 call of ``ops.wkv6`` launches the decode kernel (counted
    under wkv6_decode, the recurrent kernel not at all) and gives the plain
    version's y and state to the bit (``torch.equal``), and the recurrent
    kernel's at T = 1: fp32 and bf16 r/k/v, Dk = Dv ∈ {16, 64}, Dk ≠ Dv,
    Dk = 40 with Dv = 72 (rows padded, a second 64-column block part
    filled), the smallest Dk, B × H = 1 and 256, strided views and
    contiguous, zeros in and a given state, u in r's type and in fp32, y
    in r's type and in fp32, and each given state updated in place.
    Returns the number of cases; logs ptxas's registers and spills of the
    decode kernel."""
    import torch
    from repro_torch.kernels import _build, ops, ref
    from repro_torch.kernels import wkv6 as wk
    n = 0
    seed = 200
    for dtype in (torch.float32, torch.bfloat16):
        small = 4 if dtype == torch.float32 else 8
        for B, H, Dk, Dv, strided in (
                (2, 3, 16, 16, True), (1, 1, 64, 64, True),
                (8, 32, 64, 64, True), (2, 2, 16, 64, True),
                (2, 2, 64, 16, False), (1, 2, small, 2 * small, False),
                (2, 2, 40, 72, True)):
            seed += 1
            r, k, v, w, u = _wkv_inputs(B, H, 1, Dk, Dv, dtype, seed,
                                        "fast", strided)
            s0 = torch.randn((B, H, Dk, Dv), device="cuda")
            for given in (False, True):
                for uu in (u, u.float()):
                    for od in (None, torch.float32):
                        what = (f"wkv6 decode {dtype} B={B} H={H} Dk={Dk} "
                                f"Dv={Dv} strided={strided} state={given} "
                                f"u {uu.dtype} y {od}")
                        st_in = s0 if given else None
                        y_p, st_p = ref.wkv6(r, k, v, w, uu, st_in,
                                             out_dtype=od)
                        y_r, st_r = wk.launch_recurrent(r, k, v, w, uu,
                                                        st_in, out_dtype=od)
                        state = s0.clone() if given else None
                        ops.reset_launch_counts()
                        y, st = ops.wkv6(r, k, v, w, uu, state,
                                         state_out=state, out_dtype=od)
                        torch.cuda.synchronize()
                        if (ops.launch_counts["wkv6_decode"] != 1
                                or ops.launch_counts["wkv6_recurrent"]):
                            fail(f"{what}: launches "
                                 f"{dict(ops.launch_counts)}")
                        if given and st is not state:
                            fail(f"{what}: the state was not updated in "
                                 "place")
                        for a, b, name in ((y, y_p, "y vs plain"),
                                           (st, st_p, "state vs plain"),
                                           (y, y_r, "y vs recurrent"),
                                           (st, st_r,
                                            "state vs recurrent")):
                            if a.dtype != b.dtype or not torch.equal(a, b):
                                fail(f"{what}: {name} differ")
                        n += 1
    for line in _ptxas_report(_build.build_log.get("wkv6_decode", ""),
                              "wkv6_decode_kernel"):
        log(f"  ptxas wkv6_decode {line}")
    return n


def wkv6_bwd_cases() -> list[tuple]:
    """(dtype, B, H, T, Dk, Dv, decay, strided, u_zero) of
    :func:`phase_kernels_wkv6_bwd`: rwkv6-1.6b's head (Dk = Dv = 64) and
    ``reduced()``'s (16), Jamba's scan (Dk = 16, Dv = 128, u = 0), Dk ≠ Dv
    both ways, the narrowest rows, B × H = 1 and 256, T = 1, T on a chunk
    boundary and one past it (the recurrent kernel's: 16 = 2 chunks of 8
    at 64 × 64, 33 at 16 × 16, chunks of 32; the chunked kernel's: 64 at
    64 × 64, 65 at 16 × 128), ragged T and T = 2,100, each decay, strided
    views and contiguous; fp32 and bf16."""
    import torch
    cases = []
    for dtype in (torch.float32, torch.bfloat16):
        small = 4 if dtype == torch.float32 else 8
        cases += [(dtype, *c) for c in (
            (2, 3, 37, 16, 16, "fast", True, False),
            (1, 1, 100, 64, 64, "model", True, False),
            (8, 32, 70, 64, 64, "model", True, False),
            (2, 2, 45, 16, 128, 0.5, True, True),
            (2, 2, 33, 64, 16, "fast", False, False),
            (1, 2, 40, 64, 128, "fast", False, False),
            (1, 2, 20, small, 2 * small, "fast", False, False),
            (1, 2, 1, 64, 64, "fast", True, False),
            (2, 2, 16, 64, 64, "model", True, False),
            (1, 2, 33, 16, 16, "fast", True, False),
            (2, 2, 64, 64, 64, "model", True, False),
            (1, 2, 65, 16, 128, "fast", False, False),
            (2, 4, 2100, 64, 64, "model", True, False))]
        cases += [(dtype, 2, 3, 300, 64, 64, decay, True, False)
                  for decay in (0.5, 0.05, 1e-6)]
    return cases


def wkv6_bwd_inputs(B, H, T, Dk, Dv, dtype, seed, decay, strided, given,
                    u_zero=False, dy_dtype=None):
    """:func:`_wkv_inputs`' r, k, v, w, u (u = 0 with ``u_zero``), the
    state S_0 and the gradients dy (a (B, H, T, Dv) view of (B, T, H, Dv)
    where ``strided``, in ``dy_dtype`` or r's) and dS_T; S_0 and dS_T
    ~ N(0, 1) fp32 where ``given``, else None."""
    import torch
    r, k, v, w, u = _wkv_inputs(B, H, T, Dk, Dv, dtype, seed, decay,
                                strided)
    if u_zero:
        u = torch.zeros_like(u)
    g = torch.Generator(device="cuda")
    g.manual_seed(seed + 7)
    dy = torch.randn((B, T, H, Dv), generator=g, device="cuda").to(
        dy_dtype or dtype).transpose(1, 2)
    if not strided:
        dy = dy.contiguous()
    s0 = ds = None
    if given:
        s0, ds = torch.randn((2, B, H, Dk, Dv), generator=g, device="cuda")
    return r, k, v, w, u, s0, dy, ds


WKV_GRADS = ("dr", "dk", "dv", "dw", "du", "d_state")


def phase_kernels_wkv6_bwd() -> None:
    """The wkv6 backward on the card against the plain version
    (``ref.wkv6_backward``, the recurrence's order): every case of
    :func:`wkv6_bwd_cases` from zeros and from a given S_0 with a given
    dS_T, and one bf16 case with dy in fp32 (the decode output's type),
    each through ``wkv6.launch_backward`` on the route ``wkv6.bwd_route``
    names: the chunked kernel (``csrc/wkv6_bwd_chunked.cu``) for the
    model's states (64 × 64, 16 × 16, 16 × 128), the recurrent kernel
    (``csrc/wkv6_bwd.cu``) for the rest.  Each case: its launches those of
    its route and no other (three chunked launches and a du sum, or a scan
    and a du sum), the cases counted by route; the six gradients to the
    bit of the plain version where they agree so (counted; the recurrent
    kernel repeats its order), else within ``testing.WKV_GRAD_TOL``; a
    second call equal to the first to the bit; the types and shapes of the
    gradients.  At T ≤ 100 also against autograd of the plain forward
    (``ref.wkv6``), within ``WKV_GRAD_TOL``, and on the chunked route the
    recurrent kernel at the same state to the bit of the plain version.
    Then the shapes neither takes raise; ptxas's registers and spills of
    each instantiation of both; the HMMA (mma.sync) instructions in the
    chunked library's SASS (none fails the phase, where cuobjdump
    exists)."""
    import torch
    from repro_torch import testing
    from repro_torch.kernels import _build, ops, ref
    from repro_torch.kernels import wkv6 as wk
    n = same = n_autograd = n_rec = 0
    by_route: dict[str, int] = {}
    worst: dict[str, float] = {}
    worst_autograd: dict[str, float] = {}
    seed = 300

    def grads(args):
        r, v = args[0], args[2]
        route = wk.bwd_route(r.shape[2], r.shape[3], v.shape[3], r.dtype)
        ops.reset_launch_counts()
        out = wk.launch_backward(*args)
        torch.cuda.synchronize()
        counts = {key: ops.launch_counts[key] for key in WKV_BWD_ALL}
        want = WKV_BWD_ROUTE_LAUNCHES[route]
        if counts != want:
            fail(f"wkv6 backward on the {route} route: launches {counts}, "
                 f"expected {want}")
        return out, route

    def check(case, given, dy_dtype=None):
        nonlocal n, same, n_autograd, n_rec, seed
        dtype, B, H, T, Dk, Dv, decay, strided, u_zero = case
        seed += 1
        args = wkv6_bwd_inputs(B, H, T, Dk, Dv, dtype, seed, decay, strided,
                               given, u_zero, dy_dtype)
        r, k, v, w, u, s0, dy, ds = args
        what = (f"wkv6 backward {dtype} B={B} H={H} T={T} Dk={Dk} Dv={Dv} "
                f"{decay} strided={strided} state={given} u=0 {u_zero} "
                f"dy {dy.dtype}")
        got, route = grads(args)
        by_route[route] = by_route.get(route, 0) + 1
        want = ref.wkv6_backward(*args)
        types = (dtype, dtype, dtype, torch.float32, u.dtype, torch.float32)
        for name, a, b, t in zip(WKV_GRADS, got, want, types):
            if a.dtype != t or a.shape != b.shape:
                fail(f"{what}: {name} {a.dtype} {tuple(a.shape)}")
        if all(torch.equal(a, b) for a, b in zip(got, want)):
            same += 1
        for name, a, b in zip(WKV_GRADS, got, want):
            try:
                share = testing.assert_grad_close(
                    a, b, a.dtype, f"{what}: {name}", testing.WKV_GRAD_TOL)
            except AssertionError as e:
                fail(str(e))
            key = f"{route} {a.dtype} {name}"
            worst[key] = max(worst.get(key, 0.0), share)
        again, _ = grads(args)
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            fail(f"{what}: a second call gives other bits")
        if route == "chunked" and T <= 100:
            rec = wk.launch_backward_recurrent(*args)
            if not all(torch.equal(a, b) for a, b in zip(rec, want)):
                fail(f"{what}: the recurrent kernel parts from the plain "
                     "version")
            n_rec += 1
        if T <= 100:
            with torch.enable_grad():
                xs = [t.detach().clone().requires_grad_(True)
                      for t in (r, k, v, w, u)]
                st = (torch.zeros((B, H, Dk, Dv), device="cuda")
                      if s0 is None else s0.clone()).requires_grad_(True)
                y, fin = ref.wkv6(*xs, st, out_dtype=dy.dtype)
                loss = torch.sum(y.float() * dy.float())
                if ds is not None:
                    loss = loss + torch.sum(fin * ds)
                auto = [torch.zeros_like(x) if g is None else g for x, g in
                        zip(xs + [st], torch.autograd.grad(
                            loss, xs + [st], allow_unused=True))]
            for name, a, b in zip(WKV_GRADS, got, auto):
                try:
                    share = testing.assert_grad_close(
                        a, b, a.dtype, f"{what}: {name} against autograd",
                        testing.WKV_GRAD_TOL)
                except AssertionError as e:
                    fail(str(e))
                key = f"{route} {a.dtype} {name}"
                worst_autograd[key] = max(worst_autograd.get(key, 0.0),
                                          share)
            n_autograd += 1
        n += 1
        del got, want, again, args

    for case in wkv6_bwd_cases():
        for given in (False, True):
            check(case, given)
        torch.cuda.empty_cache()
    check((torch.bfloat16, 2, 4, 64, 64, 64, "model", True, False), True,
          dy_dtype=torch.float32)
    # the shapes it does not take
    bad = [("Dk = 128", dict(Dk=128)), ("Dv = 256", dict(Dv=256)),
           ("Dk = 4 in bf16", dict(Dk=4))]
    for label, kw in bad:
        shape = dict(B=1, H=1, T=5, Dk=16, Dv=16) | kw
        args = wkv6_bwd_inputs(shape["B"], shape["H"], shape["T"],
                               shape["Dk"], shape["Dv"], torch.bfloat16, 0,
                               "fast", False, True)
        try:
            wk.launch_backward(*args)
        except ValueError:
            continue
        fail(f"the wkv6 backward took {label}")
    r, k, v, w, u, s0, dy, ds = wkv6_bwd_inputs(1, 1, 5, 16, 16,
                                                torch.bfloat16, 0, "fast",
                                                False, True)
    for label, args in (
            ("dy of another shape", (r, k, v, w, u, s0, dy[:, :, :4], ds)),
            ("an fp16 dy", (r, k, v, w, u, s0, dy.half(), ds)),
            ("a bf16 dS_T", (r, k, v, w, u, s0, dy, ds.bfloat16()))):
        try:
            wk.launch_backward(*args)
        except ValueError:
            continue
        fail(f"the wkv6 backward took {label}")
    for lib in ("wkv6_bwd", "wkv6_bwd_chunked"):
        for line in _ptxas_report(_build.build_log.get(lib, ""), "wkv6_bwd"):
            log(f"  ptxas {line}")
    tiles = {f"{Dk}x{Dv}": (wk.backward_chunk(Dk, Dv),
                            wk.backward_smem_bytes(Dk, Dv))
             for Dk, Dv in ((16, 16), (16, 64), (16, 128), (64, 16),
                            (64, 64), (64, 128))}
    log(f"  recurrent backward (steps a chunk, shared memory per CTA) by "
        f"state: {tiles}")
    log("  chunked backward, shared memory of a gradient CTA by state and "
        "type: " + ", ".join(
            f"{Dk}x{Dv} {t} {wk.backward_smem_bytes_chunked(Dk, Dv, t == 'bf16')}"
            for Dk, Dv in wk.BWD_CHUNKED_SHAPES for t in ("fp32", "bf16")))
    hmma = sass_count("wkv6_bwd_chunked", "HMMA")
    if hmma is None:
        log("  cuobjdump not found: HMMA not counted")
    elif hmma == 0:
        fail("wkv6_bwd_chunked: no HMMA instruction in the built library's "
             "SASS (its products run on no tensor core)")
    else:
        log(f"  HMMA in the chunked backward's SASS: {hmma}")
    log(f"wkv6 backward vs plain: {n} cases by route {by_route}, {same} of "
        f"them to the bit in all six gradients, the rest within "
        f"testing.WKV_GRAD_TOL "
        f"{ {str(k): v for k, v in testing.WKV_GRAD_TOL.items()} }; worst "
        f"share by type and gradient: " + ", ".join(
            f"{key} {worst[key]:.3g}" for key in sorted(worst))
        + f"; each second call to the bit; {n_autograd} cases against "
        f"autograd of ref.wkv6, worst: " + ", ".join(
            f"{key} {worst_autograd[key]:.3g}"
            for key in sorted(worst_autograd))
        + f"; the recurrent kernel at {n_rec} chunked cases' states to the "
        f"bit of the plain version")


def times_wkv6(serve: dict, chunked_serve: dict) -> list[dict]:
    """wkv6 at the RWKV serving cell's prefill (B = 8, T = 2,048, the
    final state written) and decode (B = 8, T = 1, state in and out, y in
    fp32) shapes and at the 32k prefill (B = 1), bf16 r/k/v/u and fp32 w
    as the model passes them: the routed kernel (the recurrent one, its
    launches from ``serve``) held against its plain version there, the
    chunked kernel at both prefill shapes (its launches from
    ``chunked_serve``, phase_rwkv_chunked's run) held by the error model
    and read against RTOL/ATOL, each timed
    beside the plain version and the bound (the tensor-core bound, the
    fp32-only bound beside it); the two kernels at B = 8, H = 32 and T
    from 16 to 512 (where the chunked kernel starts to pay).  No PyTorch
    call computes the recurrence (library_ms null)."""
    import torch
    from repro_torch import testing
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import wkv6 as wk
    c = LM_SERVE
    cfg = lm_config(RWKV_ARCH)
    H, D = cfg.n_heads, cfg.rwkv_head_dim
    launches = serve["launches"]
    if launches["wkv6_recurrent"] != cfg.n_layers:
        fail(f"rwkv6 serving: {launches['wkv6_recurrent']} recurrent wkv6 "
             f"launches, not one prefill a layer ({cfg.n_layers})")
    shapes = [("prefill", c["batch"], c["prompt"], False,
               launches["wkv6_prefill"], 20),
              ("decode", c["batch"], 1, True, launches["wkv6_decode"], 50),
              ("prefill 32k", WKV_32K["B"], WKV_32K["T"], False,
               launches["wkv6_prefill"], 5)]
    rows = []
    for what, B, T, given, n_launch, runs in shapes:
        r, k, v, w, u = _wkv_inputs(B, H, T, D, D, torch.bfloat16, 17)
        s0 = torch.randn((B, H, D, D), device="cuda") if given else None
        st = torch.empty((B, H, D, D), device="cuda")
        out_dtype = torch.float32 if given else None

        def kernel(fn=ops.wkv6):
            return fn(r, k, v, w, u, s0, state_out=st, out_dtype=out_dtype)

        def plain():
            return ref.wkv6(r, k, v, w, u, s0, out_dtype=out_dtype)

        y, _ = kernel()
        (y_p, st_p), plain_ms = timed_once(plain)
        testing.assert_attention_close(y, y_p, not given,
                                       f"wkv6 at the {what} shape: y")
        testing.assert_close(st, st_p, f"wkv6 at the {what} shape: state")
        err = max(testing.max_abs_err(y, y_p), testing.max_abs_err(st, st_p))
        ms = cuda_ms(kernel, runs=runs)
        b, by, b32 = wkv6_bound(B, H, T, D, D, 2, given, 4 if given else 2)
        log(f"wkv6 {what}: B={B} H={H} T={T} Dk=Dv={D}, bf16 r/k/v/u, fp32 "
            f"w, state {'in and out' if given else 'out'}; the check's "
            f"plain run {plain_ms / 1e3:.1f} s")
        row = {"name": f"wkv6 ({what})", "route": "cuda",
               "source": "src/repro_torch/kernels/csrc/"
                         + ("wkv6_decode.cu" if T == 1 else "wkv6.cu"),
               "replaces": "src/repro/kernels/wkv6.py:69",
               "launches": n_launch, "max_abs_err": err, "ms": ms,
               "plain_ms": plain_ms, "bound_ms": b, "bound_by": by,
               "bound_fp32_ms": b32, "library_ms": None}
        if T == 1:
            # the recurrent kernel at T = 1 (the route before the decode
            # kernel), timed beside it: the same bits
            y_r, st_r = kernel(wk.launch_recurrent)
            st_r = st_r.clone()
            y, _ = kernel()
            torch.cuda.synchronize()
            if not (torch.equal(y, y_r) and torch.equal(st, st_r)):
                fail("wkv6 decode: the decode kernel and the recurrent "
                     "kernel differ at T = 1")
            row["recurrent_ms"] = cuda_ms(
                lambda: kernel(wk.launch_recurrent), runs=runs)
            log(f"wkv6 decode: decode kernel {ms:.5f} ms, recurrent kernel "
                f"at T = 1 {row['recurrent_ms']:.5f} ms, the same bits")
            del y_r, st_r
        rows.append(row)
        if T > 1:
            y, _ = kernel(wk.launch_chunked)
            torch.cuda.synchronize()
            terms = testing.wkv6_terms(r, k, v, w, u, s0)
            testing.assert_within_terms(y, y_p, terms[0], not given,
                                        f"chunked wkv6 at the {what}: y")
            testing.assert_within_terms(st, st_p, terms[1], False,
                                        f"chunked wkv6 at the {what}: state")
            read = wkv6_readings(y, st, y_p, st_p, terms, not given)
            del terms
            ms_c = cuda_ms(lambda: kernel(wk.launch_chunked), runs=runs)
            rows.append({**row, "name": f"wkv6 chunked ({what})",
                         "source": "src/repro_torch/kernels/csrc/"
                                   "wkv6_chunked.cu",
                         "launches": chunked_serve["launches"][
                             "wkv6_chunked"],
                         "max_abs_err": max(testing.max_abs_err(y, y_p),
                                            testing.max_abs_err(st, st_p)),
                         "ms": ms_c, **read})
            log(f"wkv6 chunked {what}: {ms_c:.4f} ms (recurrent {ms:.4f}); "
                f"{read}")
        del y, y_p, st_p, r, k, v, w, u, s0, st
        torch.cuda.empty_cache()
    sweep = {}
    for T in (16, 32, 64, 128, 256, 512):
        r, k, v, w, u = _wkv_inputs(8, H, T, D, D, torch.bfloat16, 18)
        sweep[T] = {name: cuda_ms(lambda fn=fn: fn(r, k, v, w, u), runs=20)
                    for name, fn in (("recurrent", wk.launch_recurrent),
                                     ("chunked", wk.launch_chunked))}
    log(f"wkv6 by T at B=8 H={H} (ms, recurrent and chunked): {sweep}")
    return rows


def mamba_scan_shapes() -> list[tuple]:
    """(what, B, H, T, Dk, Dv) of the hybrid serving cell's Mamba scan:
    ``ops.wkv6`` with r, k, w (B, H, T, d_state) and v (B, H, T, hd), u = 0,
    over the prompt (the recurrent kernel) and at T = 1 (the decode
    kernel)."""
    from repro_torch.models import hybrid
    cfg = lm_config(HYBRID_ARCH)
    _, H, ds = hybrid._dims(cfg)
    c = LM_SERVE
    return [("prefill", c["batch"], H, c["prompt"], ds, cfg.hd),
            ("decode", c["batch"], H, 1, ds, cfg.hd)]


def mamba_inputs(B, H, T, Dk, Dv, seed):
    """The Mamba scan's operands at the model's init: bf16 r, k, v, fp32
    w at Jamba's init decay (a ≈ 0.5 a step: dt ≈ 0.7, A_log = 0) and
    u = 0 (bf16)."""
    import torch
    r, k, v, w, u = _wkv_inputs(B, H, T, Dk, Dv, torch.bfloat16, seed, 0.5)
    return r, k, v, w, torch.zeros_like(u)


def times_mamba_scan(serve: dict) -> list[dict]:
    """wkv6 at the hybrid serving cell's Mamba shapes
    (:func:`mamba_scan_shapes`): prefill with the final state written and
    y in bf16, decode with the state in and out and y in fp32, as the
    model passes them; held against the plain version there, timed beside
    it and beside the bound (the tensor-core bound, the fp32-only one
    beside it); launches those of the shape in the serving run.  No
    PyTorch call computes the recurrence (library_ms null)."""
    import torch
    from repro_torch import testing
    from repro_torch.kernels import ops, ref
    rows = []
    for what, B, H, T, Dk, Dv in mamba_scan_shapes():
        given = T == 1
        r, k, v, w, u = mamba_inputs(B, H, T, Dk, Dv, 21)
        s0 = torch.randn((B, H, Dk, Dv), device="cuda") if given else None
        st = torch.empty((B, H, Dk, Dv), device="cuda")
        out_dtype = torch.float32 if given else None

        def kernel():
            return ops.wkv6(r, k, v, w, u, s0, state_out=st,
                            out_dtype=out_dtype)

        def plain():
            return ref.wkv6(r, k, v, w, u, s0, out_dtype=out_dtype)

        y, _ = kernel()
        (y_p, st_p), plain_ms = timed_once(plain)
        testing.assert_attention_close(y, y_p, not given,
                                       f"wkv6 at the Mamba {what} shape: y")
        testing.assert_close(st, st_p,
                             f"wkv6 at the Mamba {what} shape: state")
        err = max(testing.max_abs_err(y, y_p), testing.max_abs_err(st, st_p))
        ms = cuda_ms(kernel, runs=50 if given else 10)
        b, by, b32 = wkv6_bound(B, H, T, Dk, Dv, 2, given, 4 if given else 2)
        log(f"wkv6 Mamba {what}: B={B} H={H} T={T} Dk={Dk} Dv={Dv}, bf16 "
            f"r/k/v, u = 0, fp32 w = 0.5, state "
            f"{'in and out' if given else 'out'}")
        rows.append({"name": f"wkv6 ({what}, {HYBRID_ARCH} Mamba scan)",
                     "route": "cuda",
                     "source": "src/repro_torch/kernels/csrc/"
                               + ("wkv6_decode.cu" if given else "wkv6.cu"),
                     "replaces": "src/repro/kernels/wkv6.py:69",
                     "launches": shape_launches(serve, "wkv6", T, Dk),
                     "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": b, "bound_by": by, "bound_fp32_ms": b32,
                     "library_ms": None})
        del y, y_p, st_p, r, k, v, w, u, s0, st
        torch.cuda.empty_cache()
    return rows


# ---------------------------------------------------------------------------
# LM training (Qwen3-8B) on the flash_attention backward
# ---------------------------------------------------------------------------

#: step parity: Qwen3-8B at full width, 2 of its 36 layers, B = 2 prompts
#: of 32 SyntheticLM tokens in 2 microbatches, one set of fp32 masters
TRAIN_PARITY = dict(layers=2, batch=2, seq=32, micro=2)
#: the other families, at reduced() (D = 16: the CUDA-core attention route,
#: the 16 × 16 wkv6 state), in fp32 compute, two microbatches; the hybrid
#: once more with its Mamba heads at Jamba's width (hd = 128: one head of
#: a 16 × 128 state, the chunked backward's instantiation), held against
#: the same step on the card with the plain backward within
#: TRAIN_STEP_TOL[fp32] and twice to the bit (:func:`check_train_bits`;
#: against the CPU its A_log leaf, 12 values each a sum of 1,024 terms that
#: cancel, read 2.1e-5 of its norm, past TRAIN_STEP_TOL's 2e-5 a leaf, and
#: 2.9e-5 with the plain versions run on the card instead of the kernels
#: (:func:`train_leaf_drift`): the card's arithmetic outside the kernels;
#: the wkv6 backward's order of sums alone moves it by 1.4e-6 on the CPU)
TRAIN_PARITY_ARCHS = ("deepseek-moe-16b", "internvl2-76b", ENCDEC_ARCH,
                      RWKV_ARCH, HYBRID_ARCH)
TRAIN_JAMBA_SCAN = dict(head_dim=128)
#: whisper-tiny whole, one step of 8 × 1,500 frames (the encoder's 30-second
#: context) and 1,500 tokens: the backward at the encoder's shape
TRAIN_WHISPER = dict(batch=8, seq=ENCDEC_FRAMES)
#: the training cell: Qwen3-8B at full width, 4 of 36 layers (2.01 B
#: parameters, ~32 GB of masters, gradients and moments; 36 layers would be
#: ~131 GB), 8 × 2,048 SyntheticLM tokens in the config's 8 microbatches,
#: remat, bf16 moments; a warm-up step and 3 timed steps, a checkpoint every
#: 2 steps, steps 3-4 resumed from the step-2 checkpoint
TRAIN_CELL = dict(layers=4, batch=8, seq=2048, steps=4, ckpt_every=2)
#: the CLI's run: --reduced, 30 steps (a checkpoint at 25), then --resume;
#: and RWKV-6 reduced for 10 steps, in process
TRAIN_CLI = ["--arch", LM_ARCH, "--reduced", "--steps", "30"]
TRAIN_CLI_RWKV = ["--arch", RWKV_ARCH, "--reduced", "--steps", "10"]
BWD_KERNELS = ("flash_attention_bwd_delta", "flash_attention_bwd_dkdv",
               "flash_attention_bwd_dq")
#: launched once by every backward call, on either route
BWD_CALL = ("flash_attention_bwd_dkdv", "flash_attention_bwd_dq")


def rel_norms(actual: list, expected: list, device="cuda"
              ) -> tuple[float, float, int]:
    """(‖a − b‖ / ‖b‖ over all leaves, the worst leaf's, its index), in
    fp64 on the card, one leaf at a time."""
    import torch
    num = den = 0.0
    worst, at = 0.0, -1
    for i, (a, b) in enumerate(zip(actual, expected)):
        # to the card in its own type first: a host-side cast to float64
        # would double the bytes the host writes and copies
        a = a.to(device).double()
        b = b.to(device).double()
        d2, b2 = float(torch.sum((a - b) ** 2)), float(torch.sum(b * b))
        num, den = num + d2, den + b2
        r = math.sqrt(d2 / max(b2, 1e-300))
        if r > worst:
            worst, at = r, i
    return math.sqrt(num / max(den, 1e-300)), worst, at


def train_leaf_drift(arch: str = HYBRID_ARCH, cuts=None) -> dict:
    """Where an fp32 train step's card-vs-CPU distance comes from, leaf by
    leaf: one step of ``arch`` at ``reduced()`` with ``cuts``
    (``TRAIN_JAMBA_SCAN`` by default), two microbatches, from one set of
    masters on one batch, on the card through the kernels, on the card
    through the plain versions (``ops`` dispatching the card's tensors as
    the CPU's), and on the CPU; logs and returns ‖Δ‖ / ‖reference‖ of each
    leaf's gradient for each pair.  Not run by :func:`main`; it measured
    the source of the A_log reading in ``TRAIN_JAMBA_SCAN``'s note:
    ``python3 -c "import chip_smoke as c; c.phase_setup();
    c.train_leaf_drift()"``."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.kernels import ops
    from repro_torch.models import layers as TL
    from repro_torch.train import optimizer as opt_lib
    from repro_torch.train import train_step as ts
    cfg = dataclasses.replace(get_config(arch).reduced(), microbatches=2,
                              **(TRAIN_JAMBA_SCAN if cuts is None else cuts))
    opt = opt_lib.OptConfig(lr=1e-3, warmup_steps=2, total_steps=10)
    dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=16, global_batch=4,
                    seed=SEED, d_model=cfg.d_model)
    step_fn = ts.make_train_step(cfg, opt)
    saved = (TL.COMPUTE_DTYPE, ops._on_card)
    TL.COMPUTE_DTYPE = torch.float32
    grads = {}
    try:
        host = opt_lib.tree_map(
            lambda t: t.to("cpu"),
            ts.init_train_state(cfg, opt, SEED, device="cuda"))
        for run, dev in (("card", "cuda"), ("card_plain", "cuda"),
                         ("cpu", "cpu")):
            state = opt_lib.tree_map(lambda t: t.to(dev, copy=True), host)
            if run == "card_plain":
                ops._on_card = lambda t: False
            g = []
            step_fn(state, SyntheticLM(dc, dev).batch(0), keep_grads=g)
            ops._on_card = saved[1]
            grads[run] = [x.cpu() for x in g]
    finally:
        TL.COMPUTE_DTYPE, ops._on_card = saved
    names = [".".join(k) for k in _leaf_names(host["params"])]
    pairs = (("card", "cpu"), ("card_plain", "cpu"), ("card", "card_plain"))
    res = {f"{a} vs {b}": {n: rel_norms([x], [y], "cpu")[0] for n, x, y in
                           zip(names, grads[a], grads[b])} for a, b in pairs}
    log(f"train leaf drift, {arch} reduced {cuts or TRAIN_JAMBA_SCAN}, fp32, "
        f"‖Δ‖ / ‖reference‖ by leaf (card vs cpu, card_plain vs cpu, card "
        f"vs card_plain):")
    for n in names:
        log(f"  {n}: " + ", ".join(f"{res[f'{a} vs {b}'][n]:.3g}"
                                   for a, b in pairs))
    return res


class BwdShapes:
    """Within the block, each call of ``mod.launch_backward`` is counted
    by ``key`` of its arguments (``calls``), the launches going on."""

    def __init__(self, mod, key):
        self.mod, self.key = mod, key

    def __enter__(self):
        self.real, self.calls = self.mod.launch_backward, {}

        def rec(*args, **kwargs):
            key = self.key(*args, **kwargs)
            self.calls[key] = self.calls.get(key, 0) + 1
            return self.real(*args, **kwargs)

        self.mod.launch_backward = rec
        return self

    def __exit__(self, *exc):
        self.mod.launch_backward = self.real


def attention_bwd_shape(q, k, v, *args, causal, **kwargs) -> tuple:
    """A flash_attention backward call's (B, H, Hkv, S, T, D, causal)."""
    return (q.shape[0], q.shape[1], k.shape[1], q.shape[2], k.shape[2],
            q.shape[3], bool(causal))


def wkv6_bwd_shape(r, k, v, *args) -> tuple:
    """A wkv6 backward call's (B, H, T, Dk, Dv)."""
    return tuple(r.shape) + (v.shape[3],)


def check_train_bits(name: str, cfg, batch: int, seq: int) -> dict:
    """One fp32 train step of ``cfg`` on the card, from one set of masters
    on one SyntheticLM batch, three times: with the wkv6 backward kernels
    twice, and with the plain backward (``ref.wkv6_backward`` on the card)
    in their place.  The kernels' two steps equal to the bit (loss,
    grad_norm, every gradient); the kernels' step against the plain one
    within ``testing.TRAIN_STEP_TOL[fp32]`` (loss, grad_norm, lr, the
    gradients and the worst leaf, the update, the moments: the standing
    bound of every fp32 card-vs-CPU step; the chunked kernel sums in
    another order than the plain version, so the two no longer agree to
    the bit); the A_log and dt_bias leaves' readings logged; every
    parameter with a non-zero gradient; the wkv6 launches of
    :func:`wkv6_train_launches`."""
    import torch
    from repro_torch import testing
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import wkv6 as wk
    from repro_torch.models import layers as TL
    from repro_torch.train import optimizer as opt_lib
    from repro_torch.train import train_step as ts
    opt = opt_lib.OptConfig(lr=1e-3, warmup_steps=2, total_steps=10)
    dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                    global_batch=batch, seed=SEED, d_model=cfg.d_model)
    step_fn = ts.make_train_step(cfg, opt)
    saved, real = TL.COMPUTE_DTYPE, wk.launch_backward
    TL.COMPUTE_DTYPE = torch.float32
    runs = []
    try:
        for plain in (False, False, True):
            state = ts.init_train_state(cfg, opt, SEED, device="cuda")
            p0 = [t.clone() for t in opt_lib.tree_leaves(state["params"])]
            if plain:
                wk.launch_backward = ref.wkv6_backward
            ops.reset_launch_counts()
            grads = []
            state, m = step_fn(state, SyntheticLM(dc, "cuda").batch(0),
                               keep_grads=grads)
            torch.cuda.synchronize()
            wk.launch_backward = real
            upd = [a - b for a, b in
                   zip(opt_lib.tree_leaves(state["params"]), p0)]
            runs.append({"grads": grads, "m": m, "upd": upd,
                         "opt": state["opt"],
                         "counts": dict(ops.launch_counts)})
            names = [".".join(k) for k in _leaf_names(state["params"])]
            del state, p0
    finally:
        TL.COMPUTE_DTYPE, wk.launch_backward = saved, real
    k1, k2, pl = runs
    want = wkv6_train_launches(cfg)
    got_launches = {k: k1["counts"][k] for k in want}
    if got_launches != want:
        fail(f"train step {name}: wkv6 launches {got_launches}, expected "
             f"{want}")
    if not all(bool(torch.any(g != 0)) for g in k1["grads"]):
        fail(f"train step {name}: a parameter without a gradient")
    same = (all(torch.equal(a, b) for a, b in zip(k1["grads"], k2["grads"]))
            and float(k1["m"]["loss"]) == float(k2["m"]["loss"])
            and float(k1["m"]["grad_norm"]) == float(k2["m"]["grad_norm"]))
    if not same:
        fail(f"train step {name}: the kernels' step twice gives other bits")
    got = {key: abs(float(k1["m"][key]) - float(pl["m"][key]))
           / abs(float(pl["m"][key])) for key in ("loss", "grad_norm", "lr")}
    got["grads"], got["grad_leaf"], at = rel_norms(k1["grads"], pl["grads"])
    got["update"] = rel_norms(k1["upd"], pl["upd"])[0]
    for key in ("mu", "nu"):
        got[key] = rel_norms(opt_lib.tree_leaves(k1["opt"][key]),
                             opt_lib.tree_leaves(pl["opt"][key]))[0]
    tol = testing.TRAIN_STEP_TOL[torch.float32]
    bad = {k: v for k, v in got.items() if not v <= tol[k]}
    if bad:
        fail(f"train step {name}: the kernels' step against the plain "
             f"backward's on the card: {bad} past {tol} (worst gradient "
             f"leaf {names[at]})")
    leaves = {n: rel_norms([a], [b])[0] for n, a, b in
              zip(names, k1["grads"], pl["grads"])
              if "A_log" in n or "dt_bias" in n}
    log(f"train step {name} (fp32, B={batch} S={seq}, {cfg.microbatches} "
        f"microbatches, {len(names)} parameters, all with a gradient): the "
        f"kernels' step twice to the bit; against the plain backward's on "
        f"the card {got} (worst leaf {names[at]}); A_log and dt_bias "
        f"gradients: " + ", ".join(f"{n} {v:.3g}" for n, v in leaves.items())
        + f"; loss {float(k1['m']['loss']):.6f}; wkv6 launches "
        f"{got_launches}")
    return {"launches": got_launches, "diffs": got, "leaves": leaves}


def check_train_parity(name: str, cfg, mode: str, batch: int, seq: int
                       ) -> dict:
    """One train step of ``cfg`` on the card against the same step on the
    CPU's plain path, from one set of fp32 masters (drawn on the card and
    copied) on one SyntheticLM batch, COMPUTE_DTYPE ``mode``: the loss,
    grad_norm and lr, every parameter's gradient (none missing or all
    zero on the card), the update and the moments, held to
    ``testing.TRAIN_STEP_TOL``; the backward's launches counted.  (The
    CPU step beside a card phase on a thread ran no faster: both drive the
    host's 8 cores.)"""
    import torch
    from repro_torch import testing
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.models import layers as TL
    from repro_torch.train import optimizer as opt_lib
    from repro_torch.train import train_step as ts
    dtype = torch.float32 if mode == "fp32" else torch.bfloat16
    opt = opt_lib.OptConfig(lr=1e-3, warmup_steps=2, total_steps=10)
    dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                    global_batch=batch, seed=SEED, frontend=cfg.frontend,
                    frontend_tokens=cfg.frontend_tokens, d_model=cfg.d_model)
    step_fn = ts.make_train_step(cfg, opt)
    saved = TL.COMPUTE_DTYPE
    TL.COMPUTE_DTYPE = dtype
    try:
        card = ts.init_train_state(cfg, opt, SEED, device="cuda")
        cpu = opt_lib.tree_map(lambda t: t.to("cpu", copy=True), card)
        p0 = [t.clone() for t in opt_lib.tree_leaves(card["params"])]
        ops.reset_launch_counts()
        gc = []
        card, mc = step_fn(card, SyntheticLM(dc, "cuda").batch(0),
                           keep_grads=gc)
        torch.cuda.synchronize()
        counts = dict(ops.launch_counts)
    finally:
        TL.COMPUTE_DTYPE = saved
    # the card keeps only what is compared: gradients, update, moments
    names = [".".join(k) for k in _leaf_names(card["params"])]
    upd_c = [a.sub_(b) for a, b in zip(opt_lib.tree_leaves(card["params"]),
                                       p0)]
    card_opt = card["opt"]
    del card, p0
    torch.cuda.empty_cache()
    TL.COMPUTE_DTYPE = dtype
    try:
        t0 = time.perf_counter()
        p0h = [t.clone() for t in opt_lib.tree_leaves(cpu["params"])]
        gp = []
        cpu, mp = step_fn(cpu, SyntheticLM(dc, "cpu").batch(0),
                          keep_grads=gp)
        upd_p = [a.sub_(b) for a, b in
                 zip(opt_lib.tree_leaves(cpu["params"]), p0h)]
        t_cpu = time.perf_counter() - t0
    finally:
        TL.COMPUTE_DTYPE = saved
    del p0h
    tol = testing.TRAIN_STEP_TOL[dtype]
    zero = [n for n, g in zip(names, gc) if g is None
            or not bool(torch.any(g != 0))]
    if zero:
        fail(f"train step {name}: no gradient on the card for {zero}")
    got = {key: abs(float(mc[key]) - float(mp[key])) / abs(float(mp[key]))
           for key in ("loss", "grad_norm", "lr")}
    got["grads"], got["grad_leaf"], at = rel_norms(gc, gp)
    got["update"] = rel_norms(upd_c, upd_p)[0]
    for key in ("mu", "nu"):
        got[key] = rel_norms(opt_lib.tree_leaves(card_opt[key]),
                             opt_lib.tree_leaves(cpu["opt"][key]))[0]
    bad = {k: v for k, v in got.items() if not v <= tol[k]}
    if bad:
        fail(f"train step {name} ({mode}) card vs CPU: {bad} past {tol} "
             f"(worst gradient leaf {names[at]})")
    bwd = {k: counts[k] for k in BWD_KERNELS + BWD_WGMMA + WKV_BWD_ALL}
    calls = bwd[BWD_CALL[0]]
    wg = fa.bwd_route(dtype, cfg.hd) == "wgmma"
    if "flash_attention" in family_kernels(cfg) and (
            calls < 1 or any(bwd[k] != calls for k in BWD_CALL)
            or counts["flash_attention_prefill_lse"] < calls
            or bwd["flash_attention_bwd_delta"] != calls * (not wg)
            or any(bwd[k] != calls * wg for k in BWD_WGMMA)):
        fail(f"train step {name}: backward launches {bwd} (route "
             f"{fa.bwd_route(dtype, cfg.hd)}), forward with the log-sum-exp "
             f"{counts['flash_attention_prefill_lse']}")
    want = wkv6_train_launches(cfg)
    got_wkv = {k: counts[k] for k in want}
    if got_wkv != want:
        fail(f"train step {name}: wkv6 launches {got_wkv}, expected {want} "
             "(the backward once a layer and microbatch, the forward twice "
             "under remat)")
    if want:
        bwd["wkv6_prefill"] = counts["wkv6_prefill"]
    log(f"train step {name} ({mode}, B={batch} S={seq}, "
        f"{cfg.microbatches} microbatches, {len(names)} parameters, all "
        f"with a gradient on the card): card vs CPU {got} (CPU step "
        f"{t_cpu:.1f} s); loss {float(mc['loss']):.6f}, launches: forward "
        f"with lse {counts['flash_attention_prefill_lse']}, backward {bwd}")
    del cpu, gp, upd_p, gc, upd_c, card_opt
    torch.cuda.empty_cache()
    return {"diffs": got, "launches": bwd}


#: the wkv6 backward's launch counters, by route: the recurrent kernel's
#: (one each a call) and the chunked kernel's (three launches and a du sum
#: a call)
WKV_BWD = ("wkv6_bwd", "wkv6_bwd_du")
WKV_BWD_CHUNKED = ("wkv6_bwd_chunked", "wkv6_bwd_chunked_du")
WKV_BWD_ALL = WKV_BWD + WKV_BWD_CHUNKED
#: the launches of one backward call on each route
WKV_BWD_ROUTE_LAUNCHES = {
    "recurrent": {"wkv6_bwd": 1, "wkv6_bwd_du": 1, "wkv6_bwd_chunked": 0,
                  "wkv6_bwd_chunked_du": 0},
    "chunked": {"wkv6_bwd": 0, "wkv6_bwd_du": 0, "wkv6_bwd_chunked": 3,
                "wkv6_bwd_chunked_du": 1}}


def wkv6_state(cfg) -> tuple[int, int]:
    """(Dk, Dv) of the model's ``ops.wkv6`` calls: RWKV-6's head, the
    hybrid's Mamba head (d_state × hd)."""
    if cfg.family == "ssm":
        return cfg.rwkv_head_dim, cfg.rwkv_head_dim
    return cfg.ssm_state_dim, cfg.hd


def wkv6_layers(cfg) -> int:
    """Layers a forward runs through ``ops.wkv6``: every RWKV-6 layer, the
    hybrid's Mamba layers (all but one a period)."""
    if cfg.family == "ssm":
        return cfg.n_layers
    if cfg.family == "hybrid":
        return cfg.n_layers // cfg.attn_period * (cfg.attn_period - 1)
    return 0


def wkv6_train_launches(cfg) -> dict:
    """wkv6 launches of one train step of ``cfg`` on the card: a backward a
    wkv6 layer and microbatch, on the route ``wkv6.bwd_route`` names for
    the model's state (:data:`WKV_BWD_ROUTE_LAUNCHES`; none on the other),
    and the forward twice under remat (``run_layer`` runs it again in the
    backward)."""
    import torch
    from repro_torch.kernels import wkv6 as wk
    calls = wkv6_layers(cfg) * max(cfg.microbatches, 1)
    if not calls:
        return {}
    route = wk.bwd_route(2, *wkv6_state(cfg), torch.bfloat16)
    out = {k: n * calls for k, n in WKV_BWD_ROUTE_LAUNCHES[route].items()}
    out["wkv6_prefill"] = calls * (2 if cfg.remat else 1)
    return out


def _leaf_names(tree, prefix=()) -> list:
    """The key paths of a nested dict's leaves, in the JAX tree's order."""
    if isinstance(tree, dict):
        return [p for key in sorted(tree)
                for p in _leaf_names(tree[key], prefix + (key,))]
    return [prefix]


def phase_train_parity() -> dict:
    """Phase 17a: train steps on the card against the CPU's plain path —
    the MoE, VLM, encoder-decoder, RWKV-6 and hybrid families at
    ``reduced()`` (fp32, two microbatches), the hybrid once more at
    Jamba's scan width (``TRAIN_JAMBA_SCAN``), Qwen3-8B and rwkv6-1.6b at
    full width (``TRAIN_PARITY``, bf16) and rwkv6-1.6b's step once more in
    fp32 (the wkv6 backward's gradients without bf16 rounding in the
    way); whisper-tiny whole for one step at the encoder's 1,500 frames
    (its backward launches by shape).  The wkv6 backward's calls by (B,
    H, T, Dk, Dv) are kept (``wkv6_shapes``)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import wkv6 as wk
    from repro_torch.train import optimizer as opt_lib
    from repro_torch.train import train_step as ts
    p = TRAIN_PARITY
    out = {}
    with BwdShapes(wk, wkv6_bwd_shape) as wkv_shapes:
        for arch in TRAIN_PARITY_ARCHS:
            rc = dataclasses.replace(get_config(arch).reduced(),
                                     microbatches=2)
            out[arch] = check_train_parity(f"{arch} reduced", rc, "fp32", 4,
                                           16)
        rc = dataclasses.replace(get_config(HYBRID_ARCH).reduced(),
                                 microbatches=2, **TRAIN_JAMBA_SCAN)
        out["jamba_scan"] = check_train_bits(
            f"{HYBRID_ARCH} reduced, {TRAIN_JAMBA_SCAN}", rc, 4, 16)
        for arch, mode in ((LM_ARCH, "bf16"), (RWKV_ARCH, "bf16"),
                           (RWKV_ARCH, "fp32")):
            cfg = dataclasses.replace(get_config(arch), n_layers=p["layers"],
                                      microbatches=p["micro"])
            out[f"{arch} {mode}"] = check_train_parity(
                f"{arch}, {p['layers']} layers", cfg, mode, p["batch"],
                p["seq"])
    out["wkv6_shapes"] = wkv_shapes.calls
    opt = opt_lib.OptConfig()
    cfg = get_config(ENCDEC_ARCH)
    w = TRAIN_WHISPER
    state = ts.init_train_state(cfg, opt, SEED, device="cuda")
    data = SyntheticLM(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=w["seq"], global_batch=w["batch"],
        seed=SEED, frontend=cfg.frontend, d_model=cfg.d_model), "cuda")
    with BwdShapes(fa, attention_bwd_shape) as shapes:
        _, m = ts.make_train_step(cfg, opt)(state, data.batch(0))
        torch.cuda.synchronize()
    if not math.isfinite(float(m["loss"])):
        fail(f"whisper-tiny train step: loss {float(m['loss'])}")
    out["whisper_shapes"] = shapes.calls
    log(f"train step whisper-tiny whole (B={w['batch']}, {w['seq']} frames "
        f"and tokens): loss {float(m['loss']):.4f}, backward calls by (B, "
        f"H, Hkv, S, T, D, causal): {shapes.calls}")
    del state
    torch.cuda.empty_cache()
    return out


def phase_train_cell() -> dict:
    """Phase 17b: the training cell (``TRAIN_CELL``).  Each step timed with
    CUDA events, its launches counted from 0 (every backward kernel and
    the forward with the log-sum-exp must launch); the memory peak; a
    checkpoint every 2 steps (keep 2); then the step-2 checkpoint restored
    into a fresh state and steps 3-4 run again: their metrics and the
    final state equal the uninterrupted run's, bit for bit."""
    import shutil
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.kernels import ops
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train import optimizer as opt_lib
    from repro_torch.train import train_step as ts
    from repro_torch.train.fault_tolerance import CheckpointManager
    c = TRAIN_CELL
    cfg = dataclasses.replace(get_config(LM_ARCH), n_layers=c["layers"])
    opt = opt_lib.OptConfig(total_steps=100, moment_dtype=cfg.moment_dtype)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    state = ts.init_train_state(cfg, opt, SEED, device="cuda")
    leaves = opt_lib.tree_leaves(state["params"])
    n_params = sum(t.numel() for t in leaves)
    n_emb = state["params"]["emb"].numel()
    init_mem = torch.cuda.memory_allocated()
    step_fn = ts.make_train_step(cfg, opt)
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size,
                                  seq_len=c["seq"], global_batch=c["batch"],
                                  seed=SEED), "cuda")
    ckdir = ROOT / "build" / "train_ckpt"
    shutil.rmtree(ckdir, ignore_errors=True)
    mgr = CheckpointManager(str(ckdir), every_steps=c["ckpt_every"], keep=2)
    du = shutil.disk_usage(ROOT / "build")
    log(f"train cell: {n_params:,} parameters ({n_emb:,} in the embedding "
        f"table), state {init_mem:,} B on the card; disk free under build/ "
        f"{du.free:,} B")
    hist, ckpt_s = [], []
    cli = None
    for step in range(c["steps"]):
        batch = data.batch(step)
        ops.reset_launch_counts()
        (state, m), ms = timed_once(lambda: step_fn(state, batch))
        counts = dict(ops.launch_counts)
        if step + 1 == c["steps"]:
            # the timed steps are done: the CLI's run (phase 17c) starts
            # here, its start-up beside this phase's checkpoint I/O
            cli = start_train_cli()
        hist.append({"loss": float(m["loss"]), "grad_norm":
                     float(m["grad_norm"]), "lr": float(m["lr"]), "ms": ms,
                     "launches": {k: v for k, v in counts.items() if v}})
        t0 = time.perf_counter()
        mgr.maybe_save(step + 1, state)
        ckpt_s.append(time.perf_counter() - t0)
        if not math.isfinite(hist[-1]["loss"]):
            fail(f"train cell step {step + 1}: loss {hist[-1]['loss']}")
        missing = [k for k in BWD_CALL + ("flash_attention_prefill_lse",)
                   if counts[k] == 0]
        if missing:
            fail(f"train cell step {step + 1}: {missing} launched no time")
        if any(counts[k] != counts["flash_attention_bwd_dq"]
               for k in BWD_WGMMA):
            fail(f"train cell step {step + 1}: a backward call off the "
                 f"tensor cores: {counts}")
        log(f"train cell step {step + 1}: {hist[-1]}; checkpoint "
            f"{ckpt_s[-1]:.1f} s")
    peak = torch.cuda.max_memory_allocated()
    step_ms = statistics.median(h["ms"] for h in hist[1:])
    tokens = c["batch"] * c["seq"]
    attn = 3 * 4 * c["batch"] * cfg.n_heads * cfg.hd * visible_pairs(
        c["seq"], c["seq"], True, None) * cfg.n_layers
    flops = 6 * (n_params - n_emb) * tokens + attn
    out = {"cli": cli,
           "step_ms": step_ms, "tokens_per_s": tokens / (step_ms / 1e3),
           "model_flops": flops, "mfu": flops / (step_ms / 1e3) / PEAK_BF16,
           "peak_mem": peak, "init_mem": init_mem, "n_params": n_params,
           "launches": hist[-1]["launches"], "ckpt_s": ckpt_s,
           "history": hist}
    # resume: the step-2 checkpoint into a fresh state, steps 3-4 again
    t0 = time.perf_counter()
    resumed = ckpt.restore(str(ckdir), c["ckpt_every"], state)
    out["restore_s"] = time.perf_counter() - t0
    for step in range(c["ckpt_every"], c["steps"]):
        resumed, m = step_fn(resumed, data.batch(step))
        got = [float(m["loss"]), float(m["grad_norm"]), float(m["lr"])]
        want = [hist[step][k] for k in ("loss", "grad_norm", "lr")]
        if got != want:
            fail(f"train cell: resumed step {step + 1} {got} against the "
                 f"uninterrupted run's {want}")
    for a, b in zip(opt_lib.tree_leaves(resumed), opt_lib.tree_leaves(state)):
        if not torch.equal(a, b):
            fail("train cell: the resumed state differs from the "
                 "uninterrupted run's after step 4")
    shutil.rmtree(ckdir, ignore_errors=True)
    log(f"train cell ({LM_ARCH}, {c['layers']} of 36 layers, "
        f"{c['batch']} x {c['seq']} tokens, {cfg.microbatches} "
        f"microbatches, remat, bf16 moments): step {step_ms:.1f} ms "
        f"(median of steps 2-{c['steps']}), {out['tokens_per_s']:.1f} "
        f"tokens/s, {out['mfu']:.1%} of 989 TFLOP/s (6·N·tokens, N without "
        f"the embedding table, plus attention: {flops / 1e12:.1f} TFLOP a "
        f"step), memory peak {peak:,} B (state {init_mem:,} B); launches a "
        f"step {out['launches']}; checkpoints {ckpt_s} s, restore "
        f"{out['restore_s']:.1f} s; steps 3-4 resumed from the step-2 "
        f"checkpoint equal the uninterrupted run, bit for bit")
    del state, resumed
    torch.cuda.empty_cache()
    return out


#: the RWKV-6 training cell: rwkv6-1.6b whole (24 layers, d = 2,048, 32
#: heads of 64; ~25 GB of fp32 masters, gradients, fp32 sum and two bf16
#: moments), 8 × 2,048 SyntheticLM tokens in the config's 2 microbatches,
#: remat, bf16 moments; a warm-up step and 3 timed steps; no checkpoint I/O
#: (the Qwen3-8B cell keeps the resume check; the wkv6 backward's bitwise
#: second call, phase 17, stands in for this cell's determinism)
TRAIN_CELL_RWKV = dict(batch=8, seq=2048, steps=4)


def phase_train_cell_rwkv(trace: bool = False) -> dict:
    """Phase 17d: the RWKV-6 training cell (``TRAIN_CELL_RWKV``).  Each
    step timed with CUDA events, its launches counted from 0 (the wkv6
    backward once a layer and microbatch, the forward twice under remat:
    :func:`wkv6_train_launches`), a finite loss; the memory peak; the
    backward's calls by shape (``wkv6_shapes``).  With ``trace`` one more
    step under ``torch.profiler``, its device time by part
    (:func:`step_breakdown`); :func:`main` leaves it out (~15–20 s of the
    run's time limit):
    ``python3 -c "import chip_smoke as c; c.phase_setup();
    c.phase_train_cell_rwkv(trace=True)"``."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.kernels import ops
    from repro_torch.kernels import wkv6 as wk
    from repro_torch.timing import kernel_trace
    from repro_torch.train import optimizer as opt_lib
    from repro_torch.train import train_step as ts
    c = TRAIN_CELL_RWKV
    cfg = get_config(RWKV_ARCH)
    opt = opt_lib.OptConfig(total_steps=100, moment_dtype=cfg.moment_dtype)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    state = ts.init_train_state(cfg, opt, SEED, device="cuda")
    n_params = sum(t.numel() for t in opt_lib.tree_leaves(state["params"]))
    n_emb = state["params"]["emb"].numel()
    init_mem = torch.cuda.memory_allocated()
    step_fn = ts.make_train_step(cfg, opt)
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size,
                                  seq_len=c["seq"], global_batch=c["batch"],
                                  seed=SEED), "cuda")
    want = wkv6_train_launches(cfg)
    hist = []
    with BwdShapes(wk, wkv6_bwd_shape) as shapes:
        for step in range(c["steps"]):
            batch = data.batch(step)
            ops.reset_launch_counts()
            (state, m), ms = timed_once(lambda: step_fn(state, batch))
            counts = {k: v for k, v in ops.launch_counts.items() if v}
            hist.append({"loss": float(m["loss"]),
                         "grad_norm": float(m["grad_norm"]), "ms": ms,
                         "launches": counts})
            if not math.isfinite(hist[-1]["loss"]):
                fail(f"rwkv train cell step {step + 1}: loss "
                     f"{hist[-1]['loss']}")
            got = {k: counts.get(k, 0) for k in want}
            if got != want:
                fail(f"rwkv train cell step {step + 1}: wkv6 launches {got}, "
                     f"expected {want}")
            log(f"rwkv train cell step {step + 1}: {hist[-1]}")
    peak = torch.cuda.max_memory_allocated()
    step_ms = statistics.median(h["ms"] for h in hist[1:])
    tokens = c["batch"] * c["seq"]
    flops = 6 * (n_params - n_emb) * tokens
    out = {"step_ms": step_ms, "tokens_per_s": tokens / (step_ms / 1e3),
           "model_flops": flops, "mfu": flops / (step_ms / 1e3) / PEAK_BF16,
           "peak_mem": peak, "init_mem": init_mem, "n_params": n_params,
           "launches": hist[-1]["launches"], "history": hist,
           "wkv6_shapes": {k: v // c["steps"]
                           for k, v in shapes.calls.items()}}
    log(f"rwkv train cell ({RWKV_ARCH} whole, {cfg.n_layers} layers, "
        f"{n_params:,} parameters, {c['batch']} x {c['seq']} tokens, "
        f"{cfg.microbatches} microbatches, remat, bf16 moments): step "
        f"{step_ms:.1f} ms (median of steps 2-{c['steps']}), "
        f"{out['tokens_per_s']:.1f} tokens/s, {out['mfu']:.1%} of 989 "
        f"TFLOP/s (6·N·tokens, N without the embedding table: "
        f"{flops / 1e12:.1f} TFLOP a step), memory peak {peak:,} B (state "
        f"{init_mem:,} B); launches a step {out['launches']}; wkv6 backward "
        f"calls a step by (B, H, T, Dk, Dv) {out['wkv6_shapes']}")
    if trace:
        batch = data.batch(c["steps"])
        out["device"] = step_breakdown(
            kernel_trace(lambda: step_fn(state, batch), 1), step_ms)
    del state
    torch.cuda.empty_cache()
    return out


#: kernel-name substrings of each part of a training step's device time
STEP_PARTS = (("wkv6 backward", ("wkv6_bwd_chunk_kernel",
                                  "wkv6_bwd_scan_kernel",
                                  "wkv6_bwd_grad_kernel",
                                  "wkv6_bwd_chunked_du_kernel",
                                  "wkv6_bwd_kernel", "wkv6_bwd_du_kernel")),
              ("wkv6 forward", ("wkv6_kernel",)),
              ("matrix products", ("gemm", "nvjet", "xmma", "cutlass")),
              ("optimizer", ("multi_tensor", "foreach")))


def step_breakdown(kernels: dict, step_ms: float) -> dict:
    """A step's device time from ``torch.profiler`` (:func:`kernel_trace`
    over one step): ms by part of ``STEP_PARTS`` (the rest "other"), the
    device's busy and idle share of ``step_ms``, and the ten kernels that
    take most; logged."""
    if not kernels:
        log("  torch.profiler read no device time for the traced step")
        return {}
    parts: dict[str, float] = {}
    total = 0.0
    for name, k in kernels.items():
        ms = k["count"] * k["us_per_launch"] / 1e3
        total += ms
        part = next((p for p, keys in STEP_PARTS
                     if any(key in name for key in keys)), "other")
        parts[part] = parts.get(part, 0.0) + ms
    top = sorted(kernels.items(), key=lambda kv: -kv[1]["count"]
                 * kv[1]["us_per_launch"])[:10]
    out = {"device_ms": total, "idle": 1 - total / step_ms, "parts": parts,
           "top": [(name[:60], k["count"],
                    k["count"] * k["us_per_launch"] / 1e3)
                   for name, k in top]}
    log(f"  a traced step's device time (torch.profiler): {total:.1f} ms of "
        f"the median step's {step_ms:.1f} ms (idle {out['idle']:.1%}); by "
        f"part: " + ", ".join(f"{p} {ms:.1f} ms ({ms / total:.1%})"
                              for p, ms in sorted(parts.items(),
                                                  key=lambda kv: -kv[1])))
    for name, n, ms in out["top"]:
        log(f"    {ms:9.2f} ms  {n:6d} launches  {name}")
    return out


def wkv6_bwd_bound(B, H, T, Dk, Dv, itemsize, dy_itemsize, state_in):
    """(bound ms, by, fp32-only bound ms) of the wkv6 backward: the bytes
    of r, k, v and dy read and dr, dk, dv written (``itemsize``,
    ``dy_itemsize``), w read and dw written (fp32), u read and du written,
    the fp32 S_0 and dS_T read and dS_0 written where ``state_in``, each
    moved once, against 14·Dk·Dv + 12·Dk + 4·Dv operations a step and
    head (the state S_{t−1} (w·S + k·v, 3), S·dy, G·v, G ⊙ S and Gᵀ·k
    each a product and a sum (8), the update w·G + r·dy (3); the bonus
    a_t and c_t, the u terms of dr and dk, and du) at the TF32
    tensor-core rate, as :func:`wkv6_bound`; the fp32-only bound takes
    them at the fp32 rate."""
    steps = B * H * T
    flops = steps * (14 * Dk * Dv + 12 * Dk + 4 * Dv)
    nbytes = (steps * (2 * (2 * Dk + Dv) * itemsize + Dv * dy_itemsize
                       + 8 * Dk) + 2 * H * Dk * itemsize
              + 4 * B * H * Dk * Dv * (3 if state_in else 0))
    t_tc, t_bytes = flops / PEAK_TF32, nbytes / PEAK_BYTES
    fp32_only, _ = bound_ms(flops, nbytes)
    return (1e3 * max(t_tc, t_bytes),
            "operations" if t_tc >= t_bytes else "bytes", fp32_only)


#: (what, B, H, T, Dk, Dv, decay, u = 0) of the wkv6 backward's time rows
WKV_BWD_SHAPES = [
    (f"train {RWKV_ARCH}", 4, 32, 2048, 64, 64, "model", False),
    (f"{HYBRID_ARCH} Mamba scan", 8, 128, 2048, 16, 128, 0.5, True)]


def times_wkv6_bwd(parity: dict, cell: dict) -> list[dict]:
    """The wkv6 backward at rwkv6-1.6b's training microbatch (B = 4, H =
    32, T = 2,048, Dk = Dv = 64) and at Jamba's scan (B = 8, H = 128, T =
    2,048, Dk = 16, Dv = 128, u = 0), bf16, from zeros, on each route: the
    chunked kernel (``csrc/wkv6_bwd_chunked.cu``, which ``bwd_route`` sends
    these states to) and the recurrent one (``csrc/wkv6_bwd.cu``, timed
    beside it in turns, chunked / recurrent / chunked); each held against
    the plain version there (its run, timed once, is the plain time)
    within ``WKV_GRAD_TOL``, timed beside the bound
    (:func:`wkv6_bwd_bound`).  Launches: the cell's a step at rwkv6-1.6b's
    shape (four a call on the chunked route: three and du's sum); at
    Jamba's the training parity's on the 16 × 128 instantiation (no
    full-width Jamba trains on one card); the recurrent kernel's none (no
    call of the main path takes it at these states).  No PyTorch call
    computes this function (library_ms null)."""
    import torch
    from repro_torch import testing
    from repro_torch.kernels import ref
    from repro_torch.kernels import wkv6 as wk
    cfg_b = cell["wkv6_shapes"]
    rows = []
    src = "src/repro_torch/kernels/csrc/"
    for what, B, H, T, Dk, Dv, decay, u_zero in WKV_BWD_SHAPES:
        args = wkv6_bwd_inputs(B, H, T, Dk, Dv, torch.bfloat16, 41, decay,
                               True, False, u_zero)
        plain, plain_ms = timed_once(lambda: ref.wkv6_backward(*args))
        fns = {"chunked": wk.launch_backward_chunked,
               "recurrent": wk.launch_backward_recurrent}
        errs, bits = {}, {}
        for route, fn in fns.items():
            got = fn(*args)
            bits[route] = all(torch.equal(a, b) for a, b in zip(got, plain))
            for name, a, b in zip(WKV_GRADS, got, plain):
                try:
                    testing.assert_grad_close(
                        a, b, a.dtype, f"backward at {what} ({route}): {name}",
                        testing.WKV_GRAD_TOL)
                except AssertionError as e:
                    fail(str(e))
            errs[route] = max(testing.max_abs_err(a, b)
                              for a, b in zip(got, plain))
            del got
        del plain
        torch.cuda.empty_cache()
        ms = {"chunked": cuda_ms(lambda: fns["chunked"](*args), runs=5)}
        ms["recurrent"] = cuda_ms(lambda: fns["recurrent"](*args), runs=5)
        again = cuda_ms(lambda: fns["chunked"](*args), runs=5)
        b, by, b32 = wkv6_bwd_bound(B, H, T, Dk, Dv, 2, 2, False)
        if u_zero:
            calls = sum(n for (_, _, _, k, v), n in
                        parity["wkv6_shapes"].items() if (k, v) == (Dk, Dv))
        else:
            calls = cfg_b.get((B, H, T, Dk, Dv), 0)
        share = ""
        if not u_zero:
            share = (f"; {calls} calls a training step: "
                     f"{ms['chunked'] * calls / cell['step_ms']:.1%} of the "
                     f"cell's step ({cell['step_ms']:.1f} ms)")
        log(f"wkv6 backward {what}: B={B} H={H} T={T} Dk={Dk} Dv={Dv}, bf16"
            f", {decay} decay{', u = 0' if u_zero else ''}: chunked "
            f"{ms['chunked']:.4f} ms (again {again:.4f}), recurrent "
            f"{ms['recurrent']:.4f} ms, plain {plain_ms:.4f} ms (the check's "
            f"run; the recurrent kernel "
            f"{'to the bit' if bits['recurrent'] else 'within WKV_GRAD_TOL'}"
            f", the chunked within WKV_GRAD_TOL), bound {b:.4f} ms by {by} "
            f"(fp32-only {b32:.4f}){share}")
        for route in ("chunked", "recurrent"):
            rows.append({
                "name": f"wkv6 backward, {route} ({what})", "route": "cuda",
                "source": src + ("wkv6_bwd_chunked.cu" if route == "chunked"
                                 else "wkv6_bwd.cu"),
                "replaces": "src/repro/kernels/wkv6.py:69 (no TPU backward: "
                            "jax.grad of src/repro/models/layers.py:375)",
                "launches": 4 * calls if route == "chunked" else 0,
                "max_abs_err": errs[route], "ms": ms[route],
                "plain_ms": plain_ms, "bound_ms": b, "bound_by": by,
                "bound_fp32_ms": b32, "library_ms": None})
        del args
        torch.cuda.empty_cache()
    return rows


def train_launches(parity: dict, cell: dict) -> dict:
    """Backward calls a training step at each of ``ATTN_BWD_SHAPES``: the
    cell's step (Qwen3-8B; one dQ launch a call), whisper-tiny's step at
    the encoder's shape (its cross attention has the same shape)."""
    (q_what, *_), (w_what, *w_shape) = ATTN_BWD_SHAPES
    return {q_what: cell["launches"].get("flash_attention_bwd_dq", 0),
            w_what: parity["whisper_shapes"].get(tuple(w_shape), 0)}


def start_train_cli():
    """``python -m repro_torch.launch.train`` (``TRAIN_CLI``) with step
    checkpoints under ``build/train_cli``, started: returns the function
    that waits for it (:func:`_module_start`)."""
    import shutil
    ckdir = ROOT / "build" / "train_cli"
    shutil.rmtree(ckdir, ignore_errors=True)
    return _module_start("repro_torch.launch.train", *TRAIN_CLI,
                         "--ckpt-dir", str(ckdir))


def phase_train_cli(cli=None) -> dict:
    """Phase 17c: ``python -m repro_torch.launch.train`` (``TRAIN_CLI``)
    with step checkpoints (``cli``: the run :func:`start_train_cli`
    started, else started here), then the launcher's ``main`` with
    ``--resume`` in this process (the step-30 line the same to the digit);
    the select-then-train example at its defaults, in process, its
    backward launches counted; the launcher's ``main`` on RWKV-6
    (``TRAIN_CLI_RWKV``) in process, its losses finite and the wkv6
    backward launched."""
    import contextlib
    import io
    import shutil
    import torch
    from repro_torch.examples import train_lm_with_selection as ex
    from repro_torch.kernels import ops
    from repro_torch.launch import train as launch_train
    ckdir = ROOT / "build" / "train_cli"
    run = (cli or start_train_cli())()
    if run.returncode != 0:
        fail(f"repro_torch.launch.train: exit {run.returncode}: "
             f"{run.stderr[-2000:]}")
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        launch_train.main([*TRAIN_CLI, "--ckpt-dir", str(ckdir), "--resume"])
    shutil.rmtree(ckdir, ignore_errors=True)
    first, again = run.stdout.splitlines(), out.getvalue().splitlines()
    for line in again:
        log(f"  repro_torch.launch.train --resume: {line}")
    steps = [line for line in first if line.startswith("step ")]
    if [line.split()[1] for line in steps] != ["1", "10", "20", "30"] or \
            not all(math.isfinite(float(line.split()[3])) for line in steps):
        fail(f"repro_torch.launch.train: lines {first}")
    if again[:1] != ["resumed from step 25"] or again[-1] != steps[-1]:
        fail(f"repro_torch.launch.train --resume: {again} (the run's last "
             f"line {steps[-1]})")
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    res = ex.main("cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {k: ops.launch_counts[k] for k in BWD_KERNELS + BWD_WGMMA}
    losses = res["selected"] + res["random"]
    if min(counts[k] for k in BWD_CALL) < 1 \
            or not all(map(math.isfinite, losses)) \
            or len(set(res["idx"].tolist())) != len(res["idx"]):
        fail(f"example train_lm_with_selection: launches {counts}, "
             f"{len(res['idx'])} rows selected")
    log(f"example train_lm_with_selection at its defaults: wall {wall:.1f} "
        f"s, backward launches {counts}; the CLI resumed to the same "
        f"step-30 line")
    ops.reset_launch_counts()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        res = launch_train.main(TRAIN_CLI_RWKV)
    torch.cuda.synchronize()
    wkv = {k: ops.launch_counts[k] for k in WKV_BWD_CHUNKED}
    losses = [m["loss"] for m in res["metrics"]]
    if len(losses) != 10 or not all(map(math.isfinite, losses)) \
            or min(wkv.values()) < 1:
        fail(f"repro_torch.launch.train {' '.join(TRAIN_CLI_RWKV)}: losses "
             f"{losses}, wkv6 backward launches {wkv}")
    for line in out.getvalue().splitlines():
        log(f"  repro_torch.launch.train {' '.join(TRAIN_CLI_RWKV)}: {line}")
    log(f"  wkv6 backward launches in its 10 steps: {wkv}")
    return {"example_wall": wall, "example_launches": counts,
            "rwkv_cli_launches": wkv}


def phase_rwkv_chunked() -> dict:
    """rwkv6-1.6b as phases 11 and 12 with every prefill call's wkv6 on the
    chunked kernel, which ``ops.wkv6`` dispatches no call to
    (``wkv6.launch`` swapped for these runs only and restored; decode
    stays on the decode kernel): card against CPU within LM_PARITY_TOL at 2
    layers; serving at the cell's depth with three chunked launches per
    layer, the last decode step against forward within LM_SERVE_TOL,
    prefill time beside phase 12's."""
    from repro_torch.kernels import wkv6 as wk
    routed = wk.launch

    def prefill_chunked(r, *args, **kwargs):
        fn = wk.launch_chunked if r.shape[2] > 1 else routed
        return fn(r, *args, **kwargs)

    wk.launch = prefill_chunked
    try:
        phase_lm_parity(RWKV_ARCH)
        res = phase_lm_serve(RWKV_ARCH)
    finally:
        wk.launch = routed
    n = res["launches"]["wkv6_chunked"]
    if n != 3 * res["launches"]["wkv6_prefill"]:
        fail(f"rwkv6 serving on the chunked route: {n} chunked launches for "
             f"{res['launches']['wkv6_prefill']} prefill calls")
    log(f"rwkv6 serving, prefill on the chunked wkv6: prefill "
        f"{res['prefill_ms']!r} ms, wkv6 {res['kernel_prefill_ms']!r} ms of "
        f"it; last decode step vs forward {res['decode_vs_forward']!r}")
    return res


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a card")
    if torch.cuda.device_count() < 1:
        fail("no CUDA device")
    seconds: dict[str, float] = {}

    def timed(name: str, fn, *args):
        """``fn(*args)``, its wall seconds added to ``seconds[name]``."""
        t0 = time.perf_counter()
        out = fn(*args)
        seconds[name] = seconds.get(name, 0.0) + time.perf_counter() - t0
        return out

    timed("setup", phase_setup)
    for fn in (phase_kernels, phase_kernels_constrained, phase_kernels_rbf,
               phase_kernels_weighted, phase_kernels_narrow,
               phase_kernels_attention, phase_kernels_attention_bwd,
               phase_kernels_wkv6, phase_kernels_wkv6_bwd):
        timed(fn.__name__, fn)
    timed("lm_parity", phase_lm_parity)
    serve = timed("lm_serve", phase_lm_serve)
    attn_rows = timed("lm_times", times_attention, serve)
    for arch in MOE_PARITY_ARCHS:
        timed("moe_parity", phase_lm_parity, arch)
    moe = timed("moe_serve", phase_lm_serve, MOE_ARCH)
    attn_rows += timed("moe_times", times_attention, moe, MOE_ARCH)
    timed("rwkv_parity", phase_lm_parity, RWKV_ARCH)
    rwkv = timed("rwkv_serve", phase_lm_serve, RWKV_ARCH)
    chunked = timed("rwkv_chunked", phase_rwkv_chunked)
    wkv_rows = timed("rwkv_times", times_wkv6, rwkv, chunked)
    for arch in (VLM_ARCH, HYBRID_ARCH, ENCDEC_ARCH):
        timed(f"{arch} parity", phase_lm_parity, arch)
        served = timed(f"{arch} serve", phase_lm_serve, arch)
        attn_rows += timed(f"{arch} times", times_attention, served, arch)
        if arch == HYBRID_ARCH:
            wkv_rows += timed(f"{arch} times", times_mamba_scan, served)
    parity = timed("train_parity", phase_train_parity)
    cell = timed("train_cell", phase_train_cell)
    timed("train_cli", phase_train_cli, cell.pop("cli"))
    rwkv_cell = timed("train_cell_rwkv", phase_train_cell_rwkv)
    attn_rows += timed("train_times", times_attention_bwd,
                       train_launches(parity, cell), cell)
    wkv_rows += timed("train_times", times_wkv6_bwd, parity, rwkv_cell)
    scan = timed("scan", phase_scan)
    main_path = timed("main", phase_main)
    constrained = timed("constrained", phase_constrained, main_path)
    streaming = timed("streaming", phase_streaming, scan, main_path,
                      constrained)
    for fn in (phase_engine, phase_autotune):
        timed(fn.__name__, fn, main_path, streaming)
    for fn in (phase_stochastic, phase_threshold_greedy, phase_randgreedi):
        timed(fn.__name__, fn, main_path)
    timed("active_set", phase_active_set_parkinsons)
    active = timed("active_set", phase_active_set_webscope, main_path)
    facility = timed("facility", phase_facility, main_path)
    weighted = timed("weighted", phase_weighted, main_path)
    timed("serving", phase_serving, main_path, constrained)
    timed("cli", phase_cli)
    rows = timed("times", phase_times, scan, main_path, constrained, active,
                 facility, weighted, streaming)
    rows += attn_rows + wkv_rows
    for r in attn_rows + wkv_rows:
        lib = ("no library call" if r["library_ms"] is None
               else f"SDPA {r['library_ms']:.4f} ms")
        fp32 = ("" if "bound_fp32_ms" not in r else
                f"; fp32-only bound {r['bound_fp32_ms']:.4f} ms, "
                f"{r['bound_fp32_ms'] / r['ms']:.1%}")
        log(f"time {r['name']}: {r['ms']:.4f} ms (plain {r['plain_ms']:.4f} "
            f"ms, {lib}, bound {r['bound_ms']:.4f} ms by {r['bound_by']}, "
            f"{r['bound_ms'] / r['ms']:.1%} of bound{fp32}), launches "
            f"{r['launches']}")
    log(f"seconds by phase: {json.dumps(seconds)}; together "
        f"{sum(seconds.values())!r}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
