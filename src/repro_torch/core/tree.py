"""TREE-BASED COMPRESSION — Algorithm 1 of the paper (counterpart of
``repro.core.tree``).

  A₀ = V;  repeat: partition A_t into m_t = ⌈|A_t|/μ⌉ balanced parts →
  run the β-nice algorithm on every part in parallel → keep the best
  partial solution seen → A_{t+1} = union of partial solutions;
  until |A_t| ≤ μ, then solve the final block on one machine.

The candidate rows, the repartition and the best-solution fold stay on the
device between rounds; only scalars cross to the host inside the loop
(|A_t| for the next machine count, the round's best value).  Partitions
come from a round plan (:mod:`repro_torch.core.plan`).

A hereditary ``constraint`` applies to every machine's solve (Theorem 3.5);
its per-item ``attrs`` ride as trailing columns of the candidate matrix,
so rows and attributes move together through the partition, the
repartition, the fold and the union, and the returned coreset is checked
by the independent NumPy checker.

Round 0 runs resident (the whole ``(n, d)`` ground set on the device,
partitioned at once) or streams: given a :class:`GroundSetSource`,
``wave_machines`` or ``cfg.capacity_bytes``, its machine blocks are
gathered on the host and solved in waves of W machines, so at most W·μ
candidate rows are on the device at once.  A narrow source (bf16, int8)
ships its storage dtype, with the attributes and the dequant parameters
beside it as one fp32 ``meta`` matrix; the kernels dequantize, and the
selected rows come back as fp32, so later rounds do not change.  The
round-0 slots come from the plan's permutation (``dense``, the same the
resident round takes) or from a Feistel bijection evaluated per wave
(``feistel``, O(1) host state; the resident round materializes it).  For
one plan, streaming and resident give the same blocks, the same fold
order and the same result.

How round 0's waves execute is :mod:`repro_torch.engine`'s: ``cfg.engine``
picks the sync scheduler or the pipelined one (wave t + 1 gathered on a
producer thread while wave t is staged and solved), ``cfg.hosts`` shards
each gather over ingestion hosts, and a ``cfg.fault_policy`` or a
``fault_injector`` supervises the gathers (retries, hedges, host eviction,
waves dropped under the Lemma 3.4 budget and folded as machines that never
ran).  All of these are execution only: the result is the sync engine's,
bit for bit, but for dropped waves.  ``cfg.checkpoint_dir`` snapshots
every round boundary (inline, or on a writer thread with
``cfg.async_checkpoint``), and ``cfg.resume`` restarts from the newest
snapshot.  Each wave's width comes from a planner: a fixed W, a forced
``wave_schedule``, or with ``cfg.wave_autotune`` the rate-tuned
controller on a ladder of power-of-two widths (seeded from
``cfg.autotune_cache``); every trajectory gives the same result.
``cfg.telemetry`` (a :class:`repro_torch.engine.Tracer`) receives spans
from every seam and makes ``TreeResult.manifest``, written next to the
checkpoints; it observes only.
"""
from __future__ import annotations

import dataclasses
import math
import os
import time
import warnings
from typing import Any

import numpy as np
import torch

from repro_torch.core import constraints as cons_lib
from repro_torch.core import partition as part_lib
from repro_torch.core.distributed import (RoundResult, dead_wave_result,
                                          host_tensor, pack_wave, run_round,
                                          stage_wave_inputs)
from repro_torch.core.permute import FeistelPermutation, feistel_slot_items
from repro_torch.core.plan import TorchPlan, round_draws
from repro_torch.core.sources import (GroundSetSource, as_source,
                                      dtype_itemsize, host_rows)
from repro_torch.device import as_tensor, resolve_device
from repro_torch.engine import (ENGINES, MANIFEST_NAME,
                                AsyncCheckpointWriter, AutotuneCache,
                                AutotunePlanner, CheckpointStats,
                                EngineConfig, EngineStats, FaultInjector,
                                FaultPolicy, FaultStats, FaultSupervisor,
                                FixedWidthPlanner, HostWave, IngestionPlan,
                                RoundCheckpoint, ScheduledWidthPlanner,
                                WavePlanner, WaveTrace, bucket_ladder,
                                build_manifest, clean_stale_tmp, dtype_label,
                                feed_result_metrics, latest_round_checkpoint,
                                load_round_checkpoint, run_waves,
                                shape_bound, snap_down,
                                write_round_checkpoint)

PERMUTATIONS = ("dense", "feistel")


@dataclasses.dataclass(frozen=True)
class TreeConfig:
    k: int
    capacity: int                      # μ — max items per machine
    algorithm: str = "greedy"          # greedy | stochastic_greedy |
    #                                    threshold_greedy | threshold_batch
    eps: float = 0.5                   # for the stochastic/threshold variants
    seed: int = 0                      # seeds the default TorchPlan
    permutation: str = "dense"         # round-0 slot scheme: dense | feistel
    capacity_bytes: int | None = None  # device-byte wave budget (derives W)
    prefetch_depth: int | None = None  # the source's chunk-prefetch depth
    engine: str = "sync"               # round-0 wave engine: sync | pipelined
    hosts: int = 1                     # ingestion hosts sharding the gather
    max_in_flight: int = 2             # pipelined host wave buffers (≥ 2)
    fault_policy: FaultPolicy | None = None  # supervise round 0's gathers
    checkpoint_dir: str | None = None  # snapshot every round boundary here
    resume: bool = False               # restart from its newest snapshot
    async_checkpoint: bool = False     # write snapshots on a writer thread
    checkpoint_keep: int = 3           # rotated rounds kept (≤ 0: all)
    checkpoint_delta_every: int = 0    # K > 0: full snapshot every K rounds,
    #                                    row-index deltas between
    wave_autotune: bool = False        # rate-tuned per-wave width controller
    autotune_cache: str | None = None  # JSON file of converged rungs per
    #                                    (source fingerprint, μ, devices)
    telemetry: Any = None              # an engine.Tracer: spans from every
    #                                    seam and TreeResult.manifest;
    #                                    observation only

    def __post_init__(self):
        assert self.capacity > self.k, (
            f"paper requires μ > k (got μ={self.capacity}, k={self.k})")
        if self.permutation not in PERMUTATIONS:
            raise ValueError(f"permutation={self.permutation!r} not in "
                             f"{PERMUTATIONS}")
        if self.capacity_bytes is not None and self.capacity_bytes <= 0:
            raise ValueError(f"capacity_bytes={self.capacity_bytes} ≤ 0")
        if self.prefetch_depth is not None and self.prefetch_depth < 1:
            raise ValueError(f"prefetch_depth={self.prefetch_depth} < 1")
        if self.engine not in ENGINES:
            raise ValueError(f"engine={self.engine!r} not in {ENGINES}")
        if self.hosts < 1:
            raise ValueError(f"hosts={self.hosts} < 1")
        if self.max_in_flight < 2:
            raise ValueError(f"max_in_flight={self.max_in_flight} < 2")
        if self.checkpoint_delta_every < 0:
            raise ValueError(f"checkpoint_delta_every="
                             f"{self.checkpoint_delta_every} < 0")
        if self.async_checkpoint and not self.checkpoint_dir:
            raise ValueError("async_checkpoint=True without checkpoint_dir "
                             "would write nothing")

    def round_bound(self, n: int) -> int:
        """Prop. 3.1: r ≤ ⌈log_{μ/k}(n/μ)⌉ + 1."""
        mu, k = self.capacity, self.k
        if mu >= n:
            return 1
        return math.ceil(math.log(n / mu) / math.log(mu / k)) + 1

    def round_bound_exact(self, n: int) -> int:
        """Worst-case rounds from the exact recurrence
        |A_{t+1}| = ⌈|A_t|/μ⌉·k — tight even when μ ≈ k."""
        mu, k = self.capacity, self.k
        t, cur = 0, n
        while cur > mu and t < 100_000:
            cur = math.ceil(cur / mu) * k
            t += 1
        return t + 1


@dataclasses.dataclass
class IngestStats:
    """Accounting of a streaming round 0: the footprint bound's evidence
    and each wave's gather, H2D and solve seconds and bytes."""
    wave_machines: int          # W — machines per wave
    waves: int                  # waves of round 0
    peak_wave_rows: int         # most candidate rows of one wave
    peak_wave_bytes: int        # peak_wave_rows · (width · itemsize + 4 · meta)
    total_machines: int         # machines of round 0
    attr_dim: int = 0           # a — attribute columns riding with each row
    wave_seconds: list[float] = dataclasses.field(default_factory=list)
    wave_bytes: list[int] = dataclasses.field(default_factory=list)
    total_bytes: int = 0        # Σ wave_bytes (host → device)
    wall_seconds: float = 0.0   # the whole round 0, host clock
    traces: list[WaveTrace] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class TreeResult:
    sel_rows: np.ndarray        # (k, d) best solution rows (zero-padded)
    sel_mask: np.ndarray        # (k,)
    value: float
    rounds: int
    oracle_calls: int
    machines_per_round: list[int]
    round_values: list[float]   # best machine value per round
    round_walls: list[float]    # seconds per round (CUDA events on the card)
    depth_per_round: list[int]  # max over the round's machines of the
    #                             dependent launches their solve paid
    solve_depth: int            # Σ depth_per_round
    total_wall_s: float         # whole tree_maximize wall clock
    sel_attrs: np.ndarray | None = None  # (k, a) attributes of sel_rows
    ingest: IngestStats | None = None    # set by a streaming round 0
    engine_stats: EngineStats | None = None  # round 0's wave engine record
    checkpoint_stats: CheckpointStats | None = None  # per-round writes
    fault_stats: FaultStats | None = None  # supervision record (retries,
    #                                        hedges, evictions, drops)
    manifest: Any = None        # engine.RunManifest where cfg.telemetry is
    #                             set (also written next to the checkpoints)


def _round_plan(M: int, t: int, fail_machines, device) -> torch.Tensor:
    """Failure mask of round ``t``'s M machines."""
    dead = torch.zeros((M,), dtype=torch.bool)
    for mid in fail_machines.get(t, []):
        if mid < M:
            dead[mid] = True
    return dead.to(device)


def _draws(plan, cfg: TreeConfig, t: int, m0: int, m1: int, device):
    """Round t's stochastic draws of machines [m0, m1) (None unless the
    algorithm is stochastic_greedy)."""
    if cfg.algorithm != "stochastic_greedy":
        return None
    return round_draws(plan, t, m0, m1, cfg.capacity, device)


def _dispatch_round(obj, blocks, bmask, t, cfg: TreeConfig, fail_machines,
                    plan, attr_dim: int = 0, constraint=None) -> RoundResult:
    """Apply failure injection and solve one round."""
    M = blocks.shape[0]
    dead = _round_plan(M, t, fail_machines, blocks.device)
    return run_round(obj, blocks, bmask, k=cfg.k, alg=cfg.algorithm,
                     eps=cfg.eps, dead_mask=dead, attr_dim=attr_dim,
                     constraint=constraint,
                     draws=_draws(plan, cfg, t, 0, M, blocks.device))


def _attr_setup(constraint, attrs, source_a: int = 0) -> int:
    """The attribute width ``a``: of ``attrs`` ``(n, a)`` where given,
    else of the source's own attributes (``source_a``)."""
    if constraint is None:
        if attrs is not None:
            raise ValueError("attrs without a constraint have no consumer")
        return 0
    need = cons_lib.attr_dim(constraint)
    if attrs is not None and len(attrs.shape) != 2:
        raise ValueError(f"attrs must be (n, a), got {tuple(attrs.shape)}")
    a = source_a if attrs is None else attrs.shape[1]
    if a < max(1, need):
        raise ValueError(f"constraint needs attrs with ≥ {max(1, need)} "
                         f"columns, got {a} (pass attrs= or an attributed "
                         "source)")
    return a


def _finish_result(sel_wide: np.ndarray, sel_mask: np.ndarray, d: int,
                   a: int, constraint, **kw) -> TreeResult:
    """Split the carried wide rows back into (features, attrs) and verify
    the coreset against the independent NumPy feasibility checker."""
    sel_rows = sel_wide[:, :d] if a else sel_wide
    sel_attrs = sel_wide[:, d:] if a else None
    if constraint is not None:
        ok, detail = cons_lib.check_feasible(
            constraint, sel_attrs if a else np.zeros((len(sel_mask), 0)),
            sel_mask)
        assert ok, f"returned coreset violates the constraint: {detail}"
    return TreeResult(sel_rows=sel_rows, sel_mask=sel_mask,
                      sel_attrs=sel_attrs, **kw)


def _fold_round(res: RoundResult, best_rows, best_mask, best_val,
                total_calls):
    """Best-solution tracking across rounds; ties go to the lowest machine
    index and an equal value never replaces the held solution.  No host
    read (the winner is gathered by a device index), so a CUDA graph can
    capture it."""
    i_best = torch.argmax(res.values).reshape(1)   # lowest index on ties
    v_best = res.values.index_select(0, i_best)[0]
    improved = v_best > best_val
    best_rows = torch.where(improved, res.sol_rows.index_select(0, i_best)[0],
                            best_rows)
    best_mask = torch.where(improved, res.sol_mask.index_select(0, i_best)[0],
                            best_mask)
    best_val = torch.where(improved, v_best, best_val)
    total_calls = total_calls + torch.sum(res.oracle_calls)
    return best_rows, best_mask, best_val, total_calls, v_best


def _round0_partition(plan, n: int, L: int, mu: int, scheme: str,
                      device) -> part_lib.Partition:
    """Round 0's partition for the resident round: the plan's dense slot
    permutation, or the Feistel bijection of the plan's round-0 keys
    materialized (the one a streaming round 0 evaluates per wave)."""
    if scheme != "feistel":
        return part_lib.balanced_partition(plan, 0, n, L, cap=mu,
                                           device=device)
    perm = FeistelPermutation.from_keys(plan.feistel_keys(0), L * mu)
    idx = feistel_slot_items(perm, n, np.arange(L * mu, dtype=np.int64))
    idx = torch.from_numpy(idx.reshape(L, mu)).to(device)
    return part_lib.Partition(idx, idx >= 0)


def _round0_slot_blocks(plan, n: int, L: int, mu: int, scheme: str):
    """Round 0's slot assignment as ``slot_block(w0, w1) → (w1 − w0, μ)``
    int64 item indices (−1 on empty slots) of machines ``[w0, w1)``:
    slices of the plan's dense permutation (the resident round's, O(n)
    host memory), or the Feistel bijection evaluated per slice (O(1))."""
    if scheme == "feistel":
        perm = FeistelPermutation.from_keys(plan.feistel_keys(0), L * mu)

        def slot_block(w0: int, w1: int) -> np.ndarray:
            slots = (np.arange(w0, w1, dtype=np.int64)[:, None] * mu
                     + np.arange(mu, dtype=np.int64)[None, :])
            return feistel_slot_items(perm, n, slots)
        return slot_block
    slot_item = part_lib.balanced_partition(plan, 0, n, L, cap=mu).idx.numpy()
    return lambda w0, w1: slot_item[w0:w1]


def _wave_row_bytes(mu: int, width: int, itemsize: int = 4,
                    meta_cols: int = 0) -> int:
    """Device bytes of one machine's block: μ rows of ``width`` feature
    columns at the storage itemsize plus ``meta_cols`` fp32 columns
    (attributes and dequant parameters of a narrow wave); ``μ·(d + a)·4``
    on the fp32 path."""
    return mu * (width * itemsize + meta_cols * 4)


def _wave_size(cfg: TreeConfig, wave_machines, L: int, mu: int, width: int,
               itemsize: int = 4, meta_cols: int = 0) -> int:
    """W, the machines of a wave: ``wave_machines`` where given (checked
    against ``cfg.capacity_bytes``, a hard bound), else the most machines
    whose blocks fit ``cfg.capacity_bytes`` (rounded down; narrow rows fit
    proportionally more), else one.  ``ValueError`` where the budget does
    not hold one wave."""
    row_bytes = _wave_row_bytes(mu, width, itemsize, meta_cols)
    if wave_machines is not None:
        if wave_machines < 1:
            raise ValueError(f"wave_machines={wave_machines} < 1")
        W = min(L, int(wave_machines))
        if (cfg.capacity_bytes is not None
                and W * row_bytes > cfg.capacity_bytes):
            raise ValueError(
                f"wave_machines={wave_machines} needs {W * row_bytes} bytes "
                f"a wave, over capacity_bytes={cfg.capacity_bytes}")
        return W
    if cfg.capacity_bytes is not None:
        if cfg.capacity_bytes < row_bytes:
            raise ValueError(
                f"capacity_bytes={cfg.capacity_bytes} cannot fit one wave: "
                f"μ={mu} rows × ({width}×{itemsize} B + {meta_cols}×4 B) = "
                f"{row_bytes} bytes")
        return min(L, cfg.capacity_bytes // row_bytes)
    return min(L, 1)


def _wave_planner(cfg: TreeConfig, W0: int, L: int, mu: int, width: int,
                  wave_machines, wave_schedule, itemsize: int = 4,
                  meta_cols: int = 0
                  ) -> tuple[WavePlanner, list[int] | None]:
    """The width policy of one round-0 run: ``(planner, ladder or None)``.

    A ``wave_schedule`` first (forced trajectories), then
    ``cfg.wave_autotune`` (the rate controller on the bucket ladder), then
    the fixed width ``W0``.  The ladder's cap is the caller's statement of
    capacity: ``cfg.capacity_bytes`` (through :func:`_wave_size`, so the
    byte rule is the fixed path's), else an explicit ``wave_machines``
    (waves may shrink below it, never grow past it), else the machine
    count.  One device: the rungs are 1, 2, 4, ….  The ladder comes back
    so the caller can assert the shape bound.
    """
    if wave_schedule is not None:
        return ScheduledWidthPlanner(list(wave_schedule)), None
    if not cfg.wave_autotune:
        return FixedWidthPlanner(W0), None
    if cfg.capacity_bytes is not None:
        w_cap = _wave_size(cfg, None, L, mu, width, itemsize, meta_cols)
    elif wave_machines is not None:
        w_cap = W0
    else:
        w_cap = L
    ladder = bucket_ladder(1, max(w_cap, 1))
    return AutotunePlanner(ladder, snap_down(ladder, max(W0, 1))), ladder


def _stream_round0(obj, source: GroundSetSource, plan, L: int,
                   cfg: TreeConfig, dev, fail_machines, wave_machines, best,
                   constraint=None, attrs_np: np.ndarray | None = None,
                   fault_injector: FaultInjector | None = None,
                   wave_schedule=None):
    """Round 0 in waves of machines from ``source``.

    Each wave's blocks are filled on the host from the round-0 slot
    assignment (rows, and the attribute rows where constrained), staged
    on the device and solved; its solutions fold into ``best`` = (rows,
    mask, value, calls) in wave order, by strict improvement, so ties go
    to the lowest machine index as in the resident round.  An fp32 source
    ships ``(W, μ, d + a)`` fp32 blocks; a narrow one ``(W, μ, d)`` in its
    storage dtype with the fp32 ``meta`` ``(W, μ, a + qcols)``.  Padded
    slots are zero in both, so a masked row dequantizes to 0·0 + 0 = 0.

    The waves' spans come from :func:`_wave_planner` (a fixed W, a
    schedule, or the autotuner, seeded from and stored to
    ``cfg.autotune_cache`` under the source's fingerprint, μ and the device
    count); ``cfg.engine`` runs them (:func:`repro_torch.engine.run_waves`),
    ``cfg.hosts > 1`` gathers each through an :class:`IngestionPlan`, and a
    fault policy or injector supervises the gathers: a wave dropped past
    its budget folds :func:`dead_wave_result`.  The round's depth and best
    value are carried on the device and read once by the caller.
    Returns (best, round depth, round value, A₁ rows, A₁ mask, ingest
    stats, engine stats).
    """
    n, d, mu = source.n, source.d, cfg.capacity
    a = 0
    if constraint is not None:
        a = attrs_np.shape[1] if attrs_np is not None else source.a
    feat_dtype = np.dtype(source.dtype)
    narrow = feat_dtype != np.dtype(np.float32)
    qcols = source.qcols if narrow else 0
    itemsize = dtype_itemsize(feat_dtype) if narrow else 4
    meta_cols = a + qcols if narrow else 0
    width = d if narrow else d + a          # feature-block columns shipped
    W = _wave_size(cfg, wave_machines, L, mu, width, itemsize, meta_cols)
    slot_block = _round0_slot_blocks(plan, n, L, mu, cfg.permutation)
    if cfg.prefetch_depth is not None:
        source.prefetch_depth = cfg.prefetch_depth
    ecfg = EngineConfig(mode=cfg.engine, max_in_flight=cfg.max_in_flight,
                        hosts=cfg.hosts)
    planner, ladder = _wave_planner(cfg, W, L, mu, width, wave_machines,
                                    wave_schedule, itemsize, meta_cols)
    tracer = cfg.telemetry
    if tracer is not None and isinstance(planner, AutotunePlanner):
        planner.tracer = tracer       # rung moves → "autotune" instants
    cache = cache_key = None
    if cfg.autotune_cache and isinstance(planner, AutotunePlanner):
        cache = AutotuneCache(cfg.autotune_cache)
        cache_key = f"{source.fingerprint()}|mu={mu}|ndev=1"
        seeded = cache.get(cache_key)
        if seeded is not None and seeded >= ladder[0]:
            planner.seed(snap_down(ladder, min(int(seeded), ladder[-1])))
    pinned = dev.type == "cuda"
    dead = _round_plan(L, 0, fail_machines, dev)
    # the cursor and the host plan (swapped on an eviction) are touched by
    # the gather side only, one wave at a time
    state = {"w0": 0, "hosts": (IngestionPlan.build(source, cfg.hosts)
                                if cfg.hosts > 1 else None)}
    supervisor = None
    if cfg.fault_policy is not None or fault_injector is not None:
        def evict_host(host: int) -> bool:
            hp = state["hosts"]
            if hp is None or hp.hosts < 2 or host not in hp.host_ids:
                return False
            state["hosts"] = hp.evict(host)
            return True

        supervisor = FaultSupervisor(
            cfg.fault_policy or FaultPolicy(), total_rows=n,
            injector=fault_injector, rate_hint=planner.gather_rate,
            concurrent_ok=source.supports_concurrent_gather,
            evict_cb=evict_host, tracer=tracer)

    def next_span():
        w0 = state["w0"]
        if w0 >= L:
            return None
        w1 = state["w0"] = w0 + min(planner.next_width(L - w0), L - w0)
        return w0, w1

    def gather_rows(idx_flat: np.ndarray, wave: int, fault_hook=None):
        """Rows (and attribute rows) of one wave in one pass of the source
        (a sequential source is not re-streamed per matrix), host by host
        where there are ingestion hosts."""
        hp = state["hosts"]
        if hp is not None:
            rows, src_attrs, per_host = hp.gather(
                idx_flat, with_attrs=bool(a) and attrs_np is None,
                parallel=ecfg.mode == "pipelined", fault_hook=fault_hook,
                tracer=tracer, wave=wave)
            if a and attrs_np is not None:
                src_attrs = attrs_np[idx_flat]
            return rows, src_attrs, per_host
        if not a:
            return source.gather(idx_flat), None, None
        if attrs_np is not None:
            return source.gather(idx_flat), attrs_np[idx_flat], None
        rows, row_attrs = source.gather_with_attrs(idx_flat)
        return rows, row_attrs, None

    def gather(i: int) -> HostWave | None:
        """The host side of wave i: source reads and block assembly (on
        the producer thread under the pipelined engine: no launches)."""
        span = next_span()
        if span is None:
            return None
        w0, w1 = span
        idx_w = slot_block(w0, w1)
        idx_flat = np.maximum(idx_w, 0).reshape(-1)
        valid = idx_w >= 0
        if supervisor is None:
            rows, row_attrs, per_host = gather_rows(idx_flat, i)
        else:
            def attempt_fn(attempt: int):
                hook = (fault_injector.host_hook(i, attempt)
                        if fault_injector is not None else None)
                return gather_rows(idx_flat, i, fault_hook=hook)

            got, dropped = supervisor.gather(
                i, machines=w1 - w0, rows=int(valid.sum()),
                attempt_fn=attempt_fn)
            if dropped:         # folds as machines that never ran
                return HostWave((None, None, None, w0, w1), w1 - w0,
                                (w1 - w0) * mu, 0)
            rows, row_attrs, per_host = got
        # the blocks are packed here, on the producer side, straight into
        # the page-locked buffers the copy to the card reads
        mask = host_tensor(valid, pinned)
        if narrow:
            feat = pack_wave(np.asarray(rows).reshape(w1 - w0, mu, d), valid,
                             pinned)
            cols = [np.asarray(row_attrs, np.float32)] if a else []
            if qcols:
                cols.append(source.gather_qmeta(idx_flat))
            meta = (pack_wave(np.concatenate(cols, axis=1).reshape(
                w1 - w0, mu, meta_cols), valid, pinned) if cols
                else torch.zeros((w1 - w0, mu, 0)))
            return HostWave((feat, meta, mask, w0, w1), w1 - w0,
                            (w1 - w0) * mu, feat.nbytes + meta.nbytes,
                            per_host)
        rows = np.asarray(rows, np.float32)
        if a:
            rows = np.concatenate([rows, np.asarray(row_attrs, np.float32)],
                                  axis=1)
        blocks = pack_wave(rows.reshape(w1 - w0, mu, d + a), valid, pinned)
        return HostWave((blocks, None, mask, w0, w1), w1 - w0,
                        (w1 - w0) * mu, blocks.nbytes, per_host)

    copy_stream = torch.cuda.Stream(dev) if dev.type == "cuda" else None

    def stage(payload):
        blocks, meta, valid, w0, w1 = payload
        if blocks is None:                  # a dropped wave moves nothing
            return None, w0, w1
        staged = stage_wave_inputs(dev, blocks, valid, meta, copy_stream)
        return staged, w0, w1

    sol_rows, sol_mask = [], []
    carry = {"best": best,
             "depth": torch.zeros((), dtype=torch.long, device=dev),
             "v": torch.tensor(-torch.inf, device=dev)}

    def solve(i: int, staged) -> None:
        tensors, w0, w1 = staged
        if tensors is None:
            res = dead_wave_result(w1 - w0, cfg.k, d + a, dev)
        else:
            res = run_round(obj, tensors[0], tensors[1], k=cfg.k,
                            alg=cfg.algorithm, eps=cfg.eps,
                            dead_mask=dead[w0:w1], attr_dim=a,
                            constraint=constraint,
                            meta=tensors[2] if len(tensors) == 3 else None,
                            draws=_draws(plan, cfg, 0, w0, w1, dev))
        *carry["best"], v_wave = _fold_round(res, *carry["best"])
        carry["depth"] = torch.maximum(carry["depth"], torch.max(res.depth))
        carry["v"] = torch.maximum(carry["v"], v_wave)
        sol_rows.append(res.sol_rows)
        sol_mask.append(res.sol_mask)

    estats = run_waves(gather, stage, solve, ecfg, dev,
                       on_trace=planner.observe, tracer=tracer)
    if supervisor is not None:
        estats.fault_stats = supervisor.stats
    traces = estats.traces
    if state["w0"] != L or sum(t.machines for t in traces) != L:
        raise RuntimeError(f"round 0 solved {state['w0']} of {L} machines")
    if ladder is not None:
        # every width a rung: at most shape_bound distinct wave widths
        if not set(estats.width_trajectory) <= set(ladder):
            raise RuntimeError(f"widths {estats.width_trajectory} off the "
                               f"ladder {ladder}")
        if estats.distinct_shapes > shape_bound(1, ladder[-1]):
            raise RuntimeError(f"{estats.distinct_shapes} distinct widths, "
                               f"over the bound "
                               f"{shape_bound(1, ladder[-1])}")
    if cache is not None:
        cache.put(cache_key, planner.converged_width())
    peak_rows = max(t.rows for t in traces)
    stats = IngestStats(
        wave_machines=W, waves=len(traces), peak_wave_rows=peak_rows,
        peak_wave_bytes=peak_rows * (width * itemsize + meta_cols * 4),
        total_machines=L, attr_dim=a,
        wave_seconds=[t.gather_s + t.h2d_s + t.solve_s for t in traces],
        wave_bytes=[t.bytes_moved for t in traces],
        total_bytes=estats.bytes_moved, wall_seconds=estats.wall_s,
        traces=traces)
    if (cfg.capacity_bytes is not None
            and stats.peak_wave_bytes > cfg.capacity_bytes):
        raise RuntimeError(f"a wave took {stats.peak_wave_bytes} bytes, over "
                           f"capacity_bytes={cfg.capacity_bytes}")
    rows_in = torch.cat(sol_rows).reshape(-1, d + a)       # the union A₁
    mask_in = torch.cat(sol_mask).reshape(-1)
    return (carry["best"], carry["depth"], carry["v"], rows_in, mask_in,
            stats, estats)


def _host_copy(x: torch.Tensor) -> np.ndarray:
    """A NumPy copy of ``x`` that nothing else holds (a checkpoint writer
    thread owns it); a synchronous copy from the card."""
    return x.detach().to("cpu", copy=True).numpy()


def _save_round(d: str, round_idx: int, rows, mask, best_rows, best_mask,
                best_val, calls, keep: int = 3, delta_every: int = 0):
    """One round-boundary snapshot: the rotated per-round file and the
    latest pointer, both atomic (:mod:`repro_torch.engine.checkpoint`
    owns the layout, the JAX package's)."""
    write_round_checkpoint(d, round_idx, keep=keep, delta_every=delta_every,
                           rows=rows, mask=mask, best_rows=best_rows,
                           best_mask=best_mask, best_val=best_val,
                           calls=calls)


def _resume_path(d: str) -> str | None:
    """The newest complete checkpoint, after sweeping a crashed writer's
    tmp files."""
    removed = clean_stale_tmp(d)
    if removed:
        warnings.warn(f"removed {len(removed)} stale checkpoint tmp file(s) "
                      f"left by a crashed writer in {d}", RuntimeWarning)
    return latest_round_checkpoint(d)


def _load_resume(path: str, width: int, dev):
    """Round, A_t rows and mask, and the fold state of a checkpoint."""
    ck = load_round_checkpoint(path)
    if ck["rows"].ndim != 2 or ck["rows"].shape[1] != width:
        raise ValueError(f"checkpoint {path} holds rows {ck['rows'].shape}, "
                         f"the run carries {width} columns")
    rows = torch.from_numpy(np.asarray(ck["rows"], np.float32)).to(dev)
    mask = torch.from_numpy(np.asarray(ck["mask"], bool)).to(dev)
    best = (torch.from_numpy(np.asarray(ck["best_rows"], np.float32)).to(dev),
            torch.from_numpy(np.asarray(ck["best_mask"], bool)).to(dev),
            torch.tensor(float(ck["best_val"]), dtype=torch.float32,
                         device=dev),
            torch.tensor(int(ck["calls"]), dtype=torch.long, device=dev))
    return int(ck["round"]), rows, mask, best


class _RoundClock:
    """Per-round wall times: CUDA events on the card, the host clock on
    the CPU."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.marks: list = []

    def mark(self):
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.marks.append(ev)
        else:
            self.marks.append(time.perf_counter())

    def walls(self) -> list[float]:
        pairs = zip(self.marks[0::2], self.marks[1::2])
        if self.cuda:
            torch.cuda.synchronize()
            return [a.elapsed_time(b) / 1e3 for a, b in pairs]
        return [b - a for a, b in pairs]


def tree_maximize(obj, data, cfg: TreeConfig, *, device="cuda", plan=None,
                  fail_machines: dict[int, list[int]] | None = None,
                  constraint=None, attrs=None,
                  wave_machines: int | None = None,
                  fault_injector: FaultInjector | None = None,
                  wave_schedule: list[int] | None = None) -> TreeResult:
    """Run Algorithm 1 over a ground set.

    ``data`` is an ``(n, d)`` array (resident round 0) or a
    :class:`GroundSetSource`.  A source, ``wave_machines``,
    ``cfg.capacity_bytes``, a pipelined engine, ``cfg.hosts > 1``, a fault
    policy or a ``fault_injector`` streams round 0 in waves (see the module
    docstring), with the result of the resident run for the same plan.
    Runs on the card unless ``device="cpu"``; with no card the default
    raises.  ``plan`` supplies each round's slot permutation and round 0's
    Feistel keys (default ``TorchPlan(cfg.seed)``); ``fail_machines`` maps
    a round to the machine ids whose output is dropped.  ``constraint``
    (from :mod:`repro_torch.core.constraints`) applies to every machine's
    solve, with per-item ``attrs`` ``(n, a)`` or an attributed source; the
    result carries ``sel_attrs`` and is asserted feasible by
    ``constraints.check_feasible``.  ``cfg.algorithm`` is ``"greedy"``,
    ``"stochastic_greedy"`` (its draws from ``plan.stochastic_scores``, a
    function of the machine index, so streaming and resident agree),
    ``"threshold_greedy"`` or ``"threshold_batch"`` (with ``cfg.eps``).
    ``fault_injector`` is the
    seeded chaos harness of :mod:`repro_torch.engine.faults`.
    ``wave_schedule`` forces round 0's wave widths (an exhausted schedule
    repeats its last width); ``cfg.wave_autotune`` hands them to the
    autotuner.  Either streams round 0 and gives the fixed-width result.

    With ``cfg.checkpoint_dir`` every round boundary is snapshotted on the
    caller thread and written inline or, with ``cfg.async_checkpoint``, on
    a writer thread whose barrier is joined before the result (drained on
    an error).  ``cfg.resume`` restarts from the newest snapshot.  The plan
    is indexed by round, so a run resumed at round t asks
    ``plan.slot_permutation(t, ·)`` and needs no key fast-forward: it ends
    as the uninterrupted run would.

    A streaming run sets ``TreeResult.ingest`` and ``engine_stats`` (and
    ``fault_stats`` under supervision); a checkpointed one
    ``checkpoint_stats``; one with ``cfg.telemetry`` ``manifest``.
    """
    dev = resolve_device(device)
    if obj.device != dev:
        raise ValueError(f"objective lives on {obj.device}, run asks {dev}")
    streaming = (isinstance(data, GroundSetSource) or wave_machines is not None
                 or cfg.capacity_bytes is not None or cfg.engine != "sync"
                 or cfg.hosts > 1 or cfg.fault_policy is not None
                 or fault_injector is not None or cfg.wave_autotune
                 or wave_schedule is not None)
    if streaming:
        source = as_source(data)
        n, d = source.n, source.d
        a = _attr_setup(constraint, attrs, source.a)
        attrs_np = (None if attrs is None
                    else np.asarray(host_rows(attrs), np.float32))
    else:
        data = as_tensor(data, dev)
        n, d = data.shape
        a = _attr_setup(constraint, attrs)
        if a:   # attributes ride as trailing columns of the candidate matrix
            data = torch.cat([data, as_tensor(attrs, dev)], dim=1)
    plan = TorchPlan(cfg.seed) if plan is None else plan
    fail_machines = fail_machines or {}
    mu, k = cfg.capacity, cfg.k

    best = (torch.zeros((k, d + a), dtype=torch.float32, device=dev),
            torch.zeros((k,), dtype=torch.bool, device=dev),
            torch.tensor(-torch.inf, device=dev),
            torch.zeros((), dtype=torch.long, device=dev))
    rows_in = mask_in = ingest = engine_stats = None
    t = 0
    ckpt = cfg.checkpoint_dir
    if ckpt is not None:
        resume_from = _resume_path(ckpt) if cfg.resume else None
        if resume_from is not None:
            t, rows_in, mask_in, best = _load_resume(resume_from, d + a, dev)
        elif not cfg.resume:
            clean_stale_tmp(ckpt)           # a crashed writer's litter
    # the writer calls the module's _save_round when it runs, so the two
    # paths share one serializer
    tracer = cfg.telemetry
    writer = (AsyncCheckpointWriter(lambda *wa: _save_round(*wa),
                                    tracer=tracer)
              if cfg.async_checkpoint else None)
    ckpt_rounds: list[RoundCheckpoint] = []
    n_items = n
    machines_per_round: list[int] = []
    round_values: list[float] = []
    depth_per_round: list[int] = []
    r_bound = cfg.round_bound_exact(n)
    clock = _RoundClock(dev)
    t_run0 = time.perf_counter()
    try:
        while True:
            clock.mark()
            rt0 = time.perf_counter()
            if t != 0:
                n_items = int(torch.sum(mask_in))
            L = part_lib.n_parts(n_items, mu)
            if t == 0 and streaming:
                machines_per_round.append(L)
                (best, depth, v_best, rows_in, mask_in, ingest,
                 engine_stats) = _stream_round0(
                    obj, source, plan, L, cfg, dev, fail_machines,
                    wave_machines, best, constraint=constraint,
                    attrs_np=attrs_np, fault_injector=fault_injector,
                    wave_schedule=wave_schedule)
            else:
                if t == 0:
                    part = _round0_partition(plan, n, L, mu, cfg.permutation,
                                             dev)
                    blocks, bmask = part_lib.gather_partition(data, part)
                else:
                    blocks, bmask = part_lib.repartition_rows(
                        rows_in, mask_in, plan, t, L, mu)
                machines_per_round.append(blocks.shape[0])
                res = _dispatch_round(obj, blocks, bmask, t, cfg,
                                      fail_machines, plan, attr_dim=a,
                                      constraint=constraint)
                *best, v_best = _fold_round(res, *best)
                depth = torch.max(res.depth)
                # union of partial solutions = next A (device-resident)
                rows_in = res.sol_rows.reshape(-1, d + a)
                mask_in = res.sol_mask.reshape(-1)
            round_values.append(float(v_best))
            depth_per_round.append(int(depth))
            t += 1
            if ckpt is not None:
                # the snapshot: synchronous copies into arrays the writer
                # owns; then the write, inline or under the next round
                ts0 = time.perf_counter()
                snap = (ckpt, t, _host_copy(rows_in), _host_copy(mask_in),
                        _host_copy(best[0]), _host_copy(best[1]),
                        float(best[2]), int(best[3]), cfg.checkpoint_keep,
                        cfg.checkpoint_delta_every)
                if tracer is not None:
                    tracer.emit("ckpt-snapshot", "ckpt", ts0,
                                time.perf_counter(), round=t)
                if writer is not None:
                    writer.submit(t, *snap)
                else:
                    t0 = time.perf_counter()
                    _save_round(*snap)
                    dt = time.perf_counter() - t0
                    if tracer is not None:
                        tracer.emit("ckpt-write", "ckpt", t0, t0 + dt,
                                    round=t)
                    ckpt_rounds.append(RoundCheckpoint(round=t, write_s=dt,
                                                       wait_s=dt))
            clock.mark()
            if tracer is not None:
                # the round's depth rides on its span: the τ-levels and
                # greedy steps run inside its launches
                tracer.emit("round", "round", rt0, time.perf_counter(),
                            round=t - 1, machines=machines_per_round[-1],
                            depth=depth_per_round[-1])
            if L == 1:        # that was the final single-machine round
                break
            assert t <= r_bound + 1, (
                f"round bound violated: {t} > {r_bound} (Prop 3.1)")
    except BaseException:
        if writer is not None:
            writer.abort()    # drain the write in flight; keep the cause
        raise
    ckpt_stats = None
    if writer is not None:
        writer.wait()         # the final barrier: every round is on disk
        ckpt_stats = writer.stats()
    elif ckpt is not None:
        ckpt_stats = CheckpointStats(mode="sync", rounds=ckpt_rounds)
    best_rows, best_mask, best_val, total_calls = best
    sel_wide, sel_mask = best_rows.cpu().numpy(), best_mask.cpu().numpy()
    value = float(best_val)
    t_run1 = time.perf_counter()
    if tracer is not None:
        tracer.emit("run", "run", t_run0, t_run1, rounds=t, value=value)
    result = _finish_result(
        sel_wide, sel_mask, d, a, constraint,
        value=value, rounds=t, oracle_calls=int(total_calls),
        machines_per_round=machines_per_round, round_values=round_values,
        round_walls=clock.walls(), depth_per_round=depth_per_round,
        solve_depth=sum(depth_per_round),
        total_wall_s=t_run1 - t_run0, ingest=ingest,
        engine_stats=engine_stats, checkpoint_stats=ckpt_stats,
        fault_stats=None if engine_stats is None else engine_stats.fault_stats)
    if tracer is not None:
        result.manifest = _build_run_manifest(
            cfg, result, n, d, source if streaming else None, tracer)
    return result


def _build_run_manifest(cfg: TreeConfig, result: TreeResult, n: int, d: int,
                        source, tracer):
    """The run's :class:`repro_torch.engine.RunManifest`: built from the
    result, the result's stats fed to the tracer's registry, and written
    atomically next to the checkpoints where there is a checkpoint
    directory.  ``source`` is the streamed source (None: resident)."""
    if source is not None:
        feat_dtype = np.dtype(source.dtype)
        narrow = feat_dtype != np.dtype(np.float32)
        itemsize = dtype_itemsize(feat_dtype) if narrow else 4
        qcols = source.qcols if narrow else 0
        label, fingerprint = dtype_label(feat_dtype), source.fingerprint()
    else:
        itemsize, qcols, label, fingerprint = 4, 0, "fp32", None
    manifest = build_manifest(cfg, result, n=n, d=d, dtype_label=label,
                              itemsize=itemsize, qcols=qcols,
                              source_fingerprint=fingerprint)
    feed_result_metrics(tracer.metrics, result)
    if cfg.checkpoint_dir:
        manifest.write(os.path.join(cfg.checkpoint_dir, MANIFEST_NAME))
    return manifest
