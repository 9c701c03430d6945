"""Production driver for distributed submodular maximization (counterpart of
``repro.launch.submod``).

    PYTHONPATH=src python -m repro_torch.launch.submod \
        --dataset csn-20k --k 50 --capacity 400 [--device cuda|cpu] \
        [--algorithm greedy|stochastic_greedy|threshold_greedy|threshold-batch] \
        [--batch-eps E] \
        [--source resident|chunked|sharded] [--wave-machines W] \
        [--engine sync|pipelined] [--hosts P] [--capacity-bytes B] \
        [--wave-autotune] [--async-checkpoint] [--prefetch-depth D] \
        [--constraint knapsack:budget=2.5 | partition:caps=4,4,4 | ...] \
        [--permutation dense|feistel] \
        [--dtype fp32|bf16|int8] [--q-block-rows B] \
        [--autotune-cache [PATH]] [--ckpt-delta-every K] \
        [--ckpt-dir DIR --resume] [--fail round:ids] \
        [--fault-profile 'transient=0.3,seed=7,...'] [--fault-retries N] \
        [--fault-backoff S] [--no-hedge] [--max-dropped-fraction F] \
        [--trace-out trace.json] [--metrics-out metrics.json] \
        [--manifest-out manifest.json] [--profile-dir PROFDIR] \
        [--serve-smoke [--serve-requests N]]

Runs TREE-BASED COMPRESSION (Algorithm 1) on one device — the card unless
``--device cpu``, with no fallback — and reports its value against the
centralized greedy and two-round RandGreedI, with rounds and oracle calls.
Every flag of the JAX CLI keeps its name, default and choices, and means
the same thing here:

* ``--source chunked|sharded`` (or ``--wave-machines``) streams round 0 in
  capacity-bounded waves from a host source, bit for bit as the resident
  run for the same plan; ``--permutation feistel`` takes the O(1)-state
  slot cipher.
* ``--engine pipelined`` overlaps wave t+1's gather with wave t's solve
  (:mod:`repro_torch.engine`), ``--hosts P`` shards each gather across P
  ingestion hosts, ``--capacity-bytes B`` sizes the waves from a byte
  budget, ``--wave-autotune`` retunes the width per wave from measured
  rates, ``--async-checkpoint`` writes round checkpoints on a writer
  thread; all of it is execution policy, the sync run's bits.
* ``--dtype bf16|int8`` ships narrow rows (dequantized in the kernels) and
  re-scores the coreset at fp32 (``recheck:`` line, PASS within 5e-2).
* ``--fault-profile`` arms the seeded chaos injector on the gather path;
  ``--fault-retries`` / ``--fault-backoff`` / ``--no-hedge`` /
  ``--max-dropped-fraction`` tune the :class:`FaultPolicy` (``faults:``).
* ``--algorithm threshold-batch`` takes the low-adaptivity τ-ladder tier
  (``--batch-eps``; ``adaptivity:`` line).
* ``--constraint`` applies a hereditary constraint (``knapsack:budget=F
  [:col=I]``, ``partition:caps=I,I,..[:col=I]``, ``intersection:<spec>+
  <spec>``) to the tree and to both comparison columns, over attributes
  synthesized from ``--seed``; every coreset is re-checked by the NumPy
  checker (``feasibility:``).
* ``--trace-out`` / ``--metrics-out`` / ``--manifest-out`` attach the
  telemetry layer; ``--profile-dir`` brackets the run with a
  ``torch.profiler`` session (``torch_profile.json``).  Inspect a trace
  with ``python -m repro_torch.launch.tracetool``.
* ``--serve-smoke`` swaps the one-shot solve for the selection service
  (:mod:`repro_torch.serve`): ingest once, a mixed request stream answered
  cold then warm (bit for bit, no recapture of a CUDA graph), a burst
  through the dispatcher, a ~1% delta, a NumPy re-score of a served
  coreset and a validated manifest.

Every report line of the run (``TREE``, ``ingest``, ``bytes``, ``engine``,
``autotune``, ``faults``, ``checkpoint``, ``adaptivity``, ``feasibility``,
``recheck``, ``serve``) is formatted from its manifest by
:func:`repro_torch.engine.format_report`; the lines the CLI formats itself
are the JAX CLI's byte for byte.  The header reports ``devices=1``: the
run uses one device.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import time

import numpy as np

from repro_torch.core import (STORAGE_DTYPES, ArraySource, ChunkedSource,
                              ExemplarClustering, GroundSetSource,
                              Intersection, Knapsack, PartitionMatroid,
                              QuantizedSource, TorchPlan, TreeConfig,
                              centralized_greedy, check_feasible,
                              constraint_from_spec, dtype_itemsize,
                              n_parts, randgreedi, tree_maximize)
from repro_torch.core.tree import PERMUTATIONS
from repro_torch.data import datasets
from repro_torch.data.selection import fp32_recheck
from repro_torch.data.sources import ShardedSource
from repro_torch.device import as_tensor, resolve_device
from repro_torch.engine import (ENGINES, FaultInjector, FaultPolicy,
                                FaultProfile, Tracer, build_manifest,
                                format_report, profiler_session,
                                suggest_prefetch_depth)


@dataclasses.dataclass
class CLIRun:
    """What one CLI run gives back: its manifest and every line it
    printed, in order."""
    manifest: object
    lines: list[str]


def synth_attrs(constraint, n: int, seed: int) -> np.ndarray | None:
    """Deterministic per-item attributes matching the constraint's columns.

    Knapsack columns get uniform weights in [0.2, 1.0); partition columns
    get uniform group ids in [0, len(caps)) — reproducible from ``--seed``
    alone.  (The constrained benchmark generates its *own* shard-keyed
    attribute streams so shards stay independently loadable; CLI runs and
    its sweeps are therefore not attribute-comparable.)
    """
    if constraint is None:
        return None

    def walk(c, cols: dict):
        if isinstance(c, Intersection):
            for p in c.parts:
                walk(p, cols)
        elif isinstance(c, (Knapsack, PartitionMatroid)):
            kind = "w" if isinstance(c, Knapsack) else len(c.caps)
            prev = cols.setdefault(c.col, kind)
            assert prev == kind, f"column {c.col} reused with a different role"
        return cols

    cols = walk(constraint, {})
    a = max(cols) + 1
    r = np.random.default_rng((seed, 0xA7725))
    attrs = np.zeros((n, a), np.float32)
    for col in range(a):
        kind = cols.get(col, "w")
        if kind == "w":
            attrs[:, col] = r.uniform(0.2, 1.0, n).astype(np.float32)
        else:
            attrs[:, col] = r.integers(0, kind, n).astype(np.float32)
    return attrs


def _np_exemplar_value(E, rows, mask) -> float:
    """Independent NumPy re-score of a served coreset under the exemplar
    objective — the serve smoke's recheck column (fp64 accumulate)."""
    E = np.asarray(E, np.float64)
    S = np.asarray(rows, np.float64)[np.asarray(mask, bool)]
    e0 = np.sum(E * E, axis=1)
    if len(S) == 0:
        return 0.0
    d2 = (e0[:, None] - 2.0 * E @ S.T
          + np.sum(S * S, axis=1)[None, :])
    cur = np.minimum(e0, d2.min(axis=1))
    return float(np.mean(e0) - np.mean(cur))


def _printer(lines: list[str]):
    def emit(line: str) -> None:
        print(line, flush=True)
        lines.append(line)
    return emit


def serve_smoke(args, plan=None) -> CLIRun:
    """CI-grepable exercise of the selection service without a daemon.

    Synthetic ingest through the wave engine, a mixed request stream
    (two cardinalities × {unconstrained, knapsack, partition, queried})
    issued twice as identical synchronous batches — the second pass must
    ride the warm compile cache (replayed CUDA graphs on the card) with no
    recapture and answer bit-identically — plus a burst through the
    threaded dispatcher for real queue-depth telemetry, then a ~1%
    ground-set delta with a block-local re-solve, a NumPy re-score of a
    served coreset (``recheck:`` line), and a validated manifest with the
    ``serve:`` report lines.

    ``plan`` (default: the service's own draws from ``--seed``) is a
    function ``(request_seed, ladder) -> plan`` of round plans: ingest
    takes round 0 of ``plan(0, (L,))``, the service every request's
    rounds ≥ 1 (how the parity tests replay the JAX service's draws).
    """
    from repro_torch.engine.telemetry import (RunManifest, config_dict,
                                              config_fingerprint)
    from repro_torch.serve import (Dispatcher, SelectionRequest,
                                   SelectionService, ingest, round_ladder,
                                   serve_batch)

    lines: list[str] = []
    emit = _printer(lines)
    dev = resolve_device(args.device)
    data = np.asarray(datasets.REGISTRY[args.dataset](), np.float32)
    n, d = data.shape
    r = np.random.default_rng(args.seed)
    E = data[r.choice(n, min(args.n_eval, n), replace=False)]
    # two attribute columns: knapsack weights (col 0) + 3 groups (col 1)
    attrs = np.zeros((n, 2), np.float32)
    attrs[:, 0] = r.uniform(0.2, 1.0, n).astype(np.float32)
    attrs[:, 1] = r.integers(0, 3, n).astype(np.float32)

    tracer = (Tracer() if (args.trace_out or args.metrics_out
                           or args.manifest_out) else None)
    cfg = TreeConfig(k=args.k, capacity=args.capacity,
                     algorithm=args.algorithm, eps=args.eps, seed=args.seed,
                     permutation=args.permutation, engine=args.engine,
                     hosts=args.hosts, telemetry=tracer)
    emit(f"serve-smoke: n={n} d={d} k={args.k} mu={args.capacity} "
         f"requests={args.serve_requests} engine={args.engine}")
    t0 = time.perf_counter()
    round0 = (None if plan is None
              else plan(0, (n_parts(n, args.capacity),)))
    st = ingest(ArraySource(data), cfg, attrs=attrs, plan=round0)
    t_ingest = time.perf_counter() - t0
    svc = SelectionService(st, E, algorithm=args.algorithm, eps=args.eps,
                           tracer=tracer, device=dev, tail_plan=plan)

    k2 = max(2, args.k // 2)
    budget = float(np.quantile(attrs[:, 0], 0.6)) * min(args.k, 8)
    cap3 = max(1, args.k // 3 + 1)
    reqs = []
    for i in range(args.serve_requests):
        k_i = args.k if i % 2 == 0 else k2
        kind = i % 4
        if kind == 0:
            reqs.append(SelectionRequest(k=k_i))
        elif kind == 1:
            reqs.append(SelectionRequest(
                k=k_i, constraint=f"knapsack:budget={budget:.4f}"))
        elif kind == 2:
            reqs.append(SelectionRequest(
                k=k_i,
                constraint=f"partition:caps={cap3},{cap3},{cap3}:col=1"))
        else:
            reqs.append(SelectionRequest(k=k_i, query=data[(7 * i) % n]))

    t1 = time.perf_counter()
    cold = serve_batch(svc, reqs)
    compiles_after_cold = svc.cache.compiles
    warm = serve_batch(svc, reqs)
    t_serve = time.perf_counter() - t1
    for c, w in zip(cold, warm):
        assert c.value == w.value and np.array_equal(c.rows, w.rows), \
            "warm-cache answers diverged from cold answers"
    assert svc.cache.compiles == compiles_after_cold, \
        "steady-state request recaptured a warm compile-cache entry"
    assert svc.cache.steady_retraces() == 0
    for res in cold:
        assert res.feasible, res.detail

    # threaded burst: opportunistic micro-batching under backpressure —
    # exercises the dispatcher and records true queue depth (compositions
    # are timing-dependent, so assert feasibility, not bit equality)
    dp = Dispatcher(svc, max_batch=8)
    try:
        for res in dp.map(reqs):
            assert res.feasible, res.detail
    finally:
        dp.close()
    assert svc.queue_depth_max >= 1

    # ~1% churn delta: block-local re-solve, then a warm re-query
    n_del = max(1, n // 100)
    del_ids = [int(x) for x in r.choice(n, n_del, replace=False)]
    ins_rows = data[r.choice(n, n_del, replace=False)] * np.float32(0.5)
    ins_attrs = np.zeros((n_del, 2), np.float32)
    ins_attrs[:, 0] = r.uniform(0.2, 1.0, n_del).astype(np.float32)
    ins_attrs[:, 1] = r.integers(0, 3, n_del).astype(np.float32)
    rep = svc.apply_delta(insert_rows=ins_rows, insert_attrs=ins_attrs,
                          delete_ids=del_ids)
    after = svc.query(reqs[0])
    assert after.feasible, after.detail

    npv = _np_exemplar_value(E, after.rows, after.mask)
    rel = abs(npv - after.value) / max(abs(npv), 1e-12)
    status = "PASS" if np.isfinite(after.value) and rel < 1e-3 else "FAIL"

    ladder = round_ladder(st.Mp, args.k, st.mu)
    run = {"n": n, "d": d, "k": args.k, "mu": args.capacity,
           "algorithm": args.algorithm, "seed": args.seed,
           "value": float(after.value), "rounds": len(ladder),
           "oracle_calls": int(after.oracle_calls),
           "machines_per_round": list(ladder),
           "round_values": [], "dataset": args.dataset}
    manifest = RunManifest(config=config_dict(cfg),
                           config_fingerprint=config_fingerprint(cfg),
                           run=run, dtype="fp32")
    manifest.phases = {"ingest_s": t_ingest, "serve_s": t_serve}
    manifest.serve = svc.serve_stats()
    manifest.recheck = {"fp32": npv, "solve": float(after.value),
                        "rel_gap": float(rel), "status": status}
    for line in format_report(manifest):
        emit(line)
    emit(f"delta: inserted={rep.inserted} deleted={rep.deleted} "
         f"changed_machines={len(rep.changed_machines)}/{st.Mp} "
         f"rebuilt={rep.rebuilt}")

    if tracer is not None:
        if args.trace_out:
            tracer.export_chrome_trace(args.trace_out)
        if args.metrics_out:
            tracer.metrics.export_json(args.metrics_out)
    if args.manifest_out:
        manifest.write(args.manifest_out)
    problems = manifest.validate()
    assert status == "PASS", (npv, after.value, rel)
    emit("manifest: OK" if not problems
         else f"manifest: INVALID {problems}")
    assert not problems, problems
    return CLIRun(manifest, lines)


def parse_args(argv: list[str] | None = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.submod",
        description="TREE-BASED COMPRESSION on one device (the card unless "
                    "--device cpu)")
    ap.add_argument("--dataset", default="csn-20k",
                    choices=sorted(datasets.REGISTRY))
    ap.add_argument("--k", type=int, default=50)
    ap.add_argument("--capacity", type=int, default=400)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the run executes: the card (default; no "
                         "fallback when there is none) or the CPU's plain "
                         "versions")
    ap.add_argument("--algorithm", default="greedy",
                    help="per-machine selection tier: greedy, "
                         "stochastic_greedy, threshold_greedy, or "
                         "threshold-batch (low-adaptivity τ-ladder)")
    ap.add_argument("--eps", type=float, default=0.5)
    ap.add_argument("--batch-eps", type=float, default=None,
                    help="τ-ladder decay ε for --algorithm threshold-batch "
                         "(overrides --eps for that tier; smaller ε = "
                         "tighter quality floor, deeper ladder)")
    ap.add_argument("--n-eval", type=int, default=512)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--source", default="resident",
                    choices=("resident", "chunked", "sharded"),
                    help="ground-set access path; non-resident streams "
                         "round 0 in capacity-bounded waves")
    ap.add_argument("--wave-machines", type=int, default=None,
                    help="streaming wave size W (default: one mesh sweep)")
    ap.add_argument("--engine", default="sync", choices=ENGINES,
                    help="wave execution engine; pipelined overlaps wave "
                         "t+1's gather with wave t's solve (bit-identical)")
    ap.add_argument("--hosts", type=int, default=1,
                    help="ingestion hosts sharding the round-0 gather "
                         "(emulated in-process; locality asserted)")
    ap.add_argument("--capacity-bytes", type=int, default=None,
                    help="device-byte wave budget; derives W from bytes "
                         "including attribute columns (weighted-μ capacity)")
    ap.add_argument("--wave-autotune", action="store_true",
                    help="rate-tuned wave autoscaler: retune W per wave "
                         "from measured gather/solve rates (bucket ladder, "
                         "log2-bounded distinct widths, bit-identical "
                         "output)")
    ap.add_argument("--async-checkpoint", action="store_true",
                    help="background round-boundary checkpoint writes "
                         "overlapping the next round (needs --ckpt-dir; "
                         "exact resume preserved)")
    ap.add_argument("--prefetch-depth", type=int, default=None,
                    help="chunk-prefetch depth for streamed source passes "
                         "(default: 2, or autotuner-suggested when "
                         "--wave-autotune measured the rates)")
    ap.add_argument("--chunk-rows", type=int, default=4096,
                    help="rows per chunk/shard for --source chunked|sharded")
    ap.add_argument("--dtype", default="fp32", choices=STORAGE_DTYPES,
                    help="ground-set storage dtype: bf16/int8 ship narrow "
                         "rows to device (dequantized in-kernel, same byte "
                         "budget admits wider waves); the reported coreset "
                         "is re-gathered at fp32 and exactly re-scored")
    ap.add_argument("--q-block-rows", type=int, default=4096,
                    help="int8 quantization block size (rows per "
                         "scale/zero-point block on the global index grid)")
    ap.add_argument("--autotune-cache", nargs="?", const="auto", default=None,
                    help="persist the autoscaler's converged rung to this "
                         "JSON file (bare flag: autotune_cache.json next to "
                         "--ckpt-dir); reruns seed the planner at the knee")
    ap.add_argument("--ckpt-delta-every", type=int, default=0,
                    help="K > 0: round checkpoints store row-index deltas "
                         "vs the previous round, full snapshot every K "
                         "rounds (resume bit-identical)")
    ap.add_argument("--constraint", default=None,
                    help="hereditary constraint spec, e.g. "
                         "'knapsack:budget=2.5' or 'partition:caps=4,4,4'")
    ap.add_argument("--permutation", default="dense", choices=PERMUTATIONS,
                    help="round-0 slot scheme: dense host permutation or "
                         "O(1)-state Feistel cipher")
    ap.add_argument("--baseline-machines", type=int, default=None,
                    help="RandGreedI machine count (default: ⌈n/μ⌉)")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--fail", default=None,
                    help="inject failures, e.g. '0:0,1,2' (round 0, ids)")
    ap.add_argument("--fault-profile", default=None,
                    help="seeded chaos spec for the wave-gather path, e.g. "
                         "'transient=0.3,seed=7,dead_host=1,kill=3,"
                         "slow=2,latency=0.5' (see FaultProfile.from_spec)")
    ap.add_argument("--fault-retries", type=int, default=None,
                    help="transient gather retry budget per wave "
                         "(default: FaultPolicy.max_retries)")
    ap.add_argument("--fault-backoff", type=float, default=None,
                    help="base retry backoff seconds (doubles per attempt)")
    ap.add_argument("--no-hedge", action="store_true",
                    help="disable hedged re-gathers of straggler waves")
    ap.add_argument("--max-dropped-fraction", type=float, default=None,
                    help="Lemma 3.4 degradation budget: abort once the "
                         "dropped row fraction exceeds this")
    ap.add_argument("--trace-out", default=None,
                    help="export the run's span stream as Chrome "
                         "trace_event JSON (loads in Perfetto / "
                         "chrome://tracing; one lane per thread and per "
                         "ingestion host)")
    ap.add_argument("--metrics-out", default=None,
                    help="export the labelled metrics registry snapshot "
                         "(counters/gauges/histograms) as JSON")
    ap.add_argument("--manifest-out", default=None,
                    help="write the RunManifest JSON here (with --ckpt-dir "
                         "and telemetry on it is also written next to the "
                         "checkpoints automatically)")
    ap.add_argument("--profile-dir", default=None,
                    help="bracket the run with a torch.profiler session and "
                         "write its Chrome trace (torch_profile.json) into "
                         "this directory")
    ap.add_argument("--no-centralized", action="store_true")
    ap.add_argument("--serve-smoke", action="store_true",
                    help="exercise the selection service instead of one "
                         "offline solve: ingest once, answer a mixed "
                         "k/constraint/query request stream twice (warm "
                         "compile cache asserted recapture-free), apply a "
                         "~1%% ground-set delta, print grep-able serve:/"
                         "recheck:/manifest lines")
    ap.add_argument("--serve-requests", type=int, default=12,
                    help="request-stream length for --serve-smoke")
    args = ap.parse_args(argv)
    # CLI spells the tier with a hyphen; internal names use underscores
    args.algorithm = args.algorithm.replace("-", "_")
    if args.algorithm == "threshold_batch" and args.batch_eps is not None:
        args.eps = args.batch_eps
    return args


def run(args: argparse.Namespace, *, plan=None,
        randgreedi_plan=None) -> CLIRun:
    """The CLI's run for parsed ``args``; prints its lines and returns them
    with the manifest.  ``plan`` is the tree's round plan (default
    ``TorchPlan(args.seed)``, as ``tree_maximize`` draws it; with
    ``--serve-smoke`` see :func:`serve_smoke`), ``randgreedi_plan`` the
    RandGreedI column's (default ``TorchPlan(args.seed)``)."""
    if args.serve_smoke:
        return serve_smoke(args, plan)

    lines: list[str] = []
    emit = _printer(lines)
    dev = resolve_device(args.device)
    data = datasets.REGISTRY[args.dataset]()
    r = np.random.default_rng(args.seed)
    E = data[r.choice(len(data), min(args.n_eval, len(data)), replace=False)]
    obj = ExemplarClustering(as_tensor(E, dev))
    dj = as_tensor(data, dev)

    constraint = constraint_from_spec(args.constraint) if args.constraint else None
    attrs = synth_attrs(constraint, len(data), args.seed)

    fail = None
    if args.fail:
        rd, ids = args.fail.split(":")
        fail = {int(rd): [int(i) for i in ids.split(",")]}

    injector = None
    if args.fault_profile:
        injector = FaultInjector(FaultProfile.from_spec(args.fault_profile))
    fault_policy = None
    overrides = {
        k: v for k, v in (("max_retries", args.fault_retries),
                          ("backoff_s", args.fault_backoff),
                          ("hedge", False if args.no_hedge else None),
                          ("max_dropped_fraction", args.max_dropped_fraction))
        if v is not None}
    if overrides or injector is not None:
        fault_policy = FaultPolicy(**overrides)

    if args.source == "chunked":
        ground = ChunkedSource.from_array(data, args.chunk_rows, attrs=attrs)
        attrs_arg = None          # attrs flow through the source's gathers
    elif args.source == "sharded":
        cr = args.chunk_rows
        shards = [data[s:s + cr] for s in range(0, len(data), cr)]
        ashards = (None if attrs is None else
                   [attrs[s:s + cr] for s in range(0, len(data), cr)])
        ground = ShardedSource.from_arrays(shards, attrs=ashards)
        attrs_arg = None
    else:
        ground = dj
        attrs_arg = attrs

    if args.dtype != "fp32":
        # narrow-storage run: wrap whatever access path was chosen in the
        # quantizing view — the wire format of every gather/chunk becomes
        # the storage dtype, and the tree solve dequantizes in-kernel
        base = (ArraySource(data, attrs=attrs) if args.source == "resident"
                else ground)
        ground = QuantizedSource(base, store_dtype=args.dtype,
                                 q_block_rows=args.q_block_rows)
        attrs_arg = None          # attrs flow through the source's gathers

    at_cache = args.autotune_cache
    if at_cache == "auto":
        at_cache = os.path.join(args.ckpt_dir or ".", "autotune_cache.json")

    emit(f"n={len(data)} d={data.shape[1]} k={args.k} mu={args.capacity} "
         f"devices=1 alg={args.algorithm} "
         f"source={args.source} dtype={args.dtype} "
         f"permutation={args.permutation} "
         f"engine={args.engine} hosts={args.hosts} "
         f"constraint={args.constraint or 'none'}")
    # telemetry: observation only — attaching a tracer never changes the
    # run's outputs (pinned bit-identical by tests/test_torch_telemetry.py)
    tracer = (Tracer() if (args.trace_out or args.metrics_out
                           or args.manifest_out) else None)
    cfg = TreeConfig(k=args.k, capacity=args.capacity,
                     algorithm=args.algorithm, eps=args.eps, seed=args.seed,
                     checkpoint_dir=args.ckpt_dir, resume=args.resume,
                     permutation=args.permutation, engine=args.engine,
                     hosts=args.hosts, capacity_bytes=args.capacity_bytes,
                     wave_autotune=args.wave_autotune,
                     async_checkpoint=args.async_checkpoint,
                     prefetch_depth=args.prefetch_depth,
                     fault_policy=fault_policy,
                     checkpoint_delta_every=args.ckpt_delta_every,
                     autotune_cache=at_cache, telemetry=tracer)
    with profiler_session(args.profile_dir):
        res = tree_maximize(obj, ground, cfg, device=dev, plan=plan,
                            fail_machines=fail,
                            wave_machines=args.wave_machines,
                            constraint=constraint, attrs=attrs_arg,
                            fault_injector=injector)

    manifest = res.manifest
    if manifest is None:
        # telemetry off: the report below is still manifest-driven — build
        # the same record the instrumented path gets, just don't export it
        qcols = ground.qcols if isinstance(ground, QuantizedSource) else 0
        fp = (ground.fingerprint()
              if isinstance(ground, GroundSetSource) else None)
        manifest = build_manifest(cfg, res, n=len(data), d=data.shape[1],
                                  dtype_label=args.dtype,
                                  itemsize=dtype_itemsize(args.dtype),
                                  qcols=qcols, source_fingerprint=fp)
    manifest.run["dataset"] = args.dataset

    if constraint is not None:
        ok, detail = check_feasible(constraint, res.sel_attrs, res.sel_mask)
        manifest.feasibility = {"ok": bool(ok), "detail": detail}
    if args.dtype != "fp32":
        # Barbosa-style exact validation: re-gather the selection from the
        # unquantized parent at fp32 and re-score with the exact objective
        rc = fp32_recheck(obj, ground, res.sel_rows, res.sel_mask,
                          solve_value=res.value)
        rel = abs(rc.value - res.value) / max(abs(rc.value), 1e-12)
        status = "PASS" if np.isfinite(rc.value) and rel < 5e-2 else "FAIL"
        manifest.recheck = {"fp32": float(rc.value),
                            "solve": float(res.value),
                            "rel_gap": float(rel), "status": status}

    # every grep-able report line (TREE/ingest/bytes/engine/autotune/
    # faults/checkpoint/feasibility/recheck) formats from the one manifest
    for line in format_report(manifest):
        emit(line)

    if tracer is not None:
        if args.trace_out:
            tracer.export_chrome_trace(args.trace_out)
        if args.metrics_out:
            tracer.metrics.export_json(args.metrics_out)
    if args.manifest_out:
        manifest.write(args.manifest_out)

    if manifest.feasibility is not None:
        assert manifest.feasibility["ok"], manifest.feasibility["detail"]
    if manifest.recheck is not None:
        assert manifest.recheck["status"] == "PASS", manifest.recheck
    if not args.no_centralized:
        # non-resident runs stream the centralized column too (chunked lazy
        # greedy) — nothing in the comparison needs the all-resident array.
        # prefetch depth: explicit flag, else the autotuner's measured rates
        depth = args.prefetch_depth
        if depth is None and args.wave_autotune and res.engine_stats is not None:
            depth = suggest_prefetch_depth(res.engine_stats.gather_s,
                                           res.engine_stats.solve_s)
            emit(f"prefetch-depth: {depth} (from autotuned gather/solve "
                 f"rates)")
        cg = centralized_greedy(
            obj, dj if args.source == "resident" else ground, args.k,
            constraint=constraint,
            attrs=attrs if args.source == "resident" else None,
            device=dev, chunk_rows=args.chunk_rows,
            prefetch_depth=depth or 2)
        emit(f"centralized greedy{' (constrained)' if constraint else ''}"
             f"{' [streamed]' if args.source != 'resident' else ''}: "
             f"f={float(cg.value):.6f} "
             f"(TREE at {res.value / float(cg.value):.2%})")
        m_base = args.baseline_machines or max(
            1, -(-len(data) // args.capacity))
        rg = randgreedi(obj, ground if args.source != "resident" else dj,
                        args.k, m_base,
                        (TorchPlan(args.seed) if randgreedi_plan is None
                         else randgreedi_plan),
                        constraint=constraint,
                        attrs=attrs if args.source == "resident" else None,
                        device=dev)
        if constraint is not None:
            ok, detail = check_feasible(constraint,
                                        np.asarray(rg.sel_attrs.cpu()),
                                        np.asarray(rg.sel_mask.cpu()))
            assert ok, detail
        emit(f"randgreedi (m={m_base}"
             f"{', constrained' if constraint else ''}): "
             f"f={float(rg.value):.6f} "
             f"(TREE at {res.value / float(rg.value):.2%})")
    return CLIRun(manifest, lines)


def main(argv: list[str] | None = None) -> CLIRun:
    return run(parse_args(argv))


if __name__ == "__main__":
    main()
