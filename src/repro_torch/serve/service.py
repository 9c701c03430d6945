"""Submodular selection as a service: queries against a resident tree
(counterpart of ``repro.serve.service``).

A :class:`SelectionService` amortizes the tree's pass over the ground set:
the ground set is ingested once into a resident
:class:`repro_torch.serve.session.SessionState`, and each
:class:`SelectionRequest` (its own k, its own constraint, optionally a
query vector that reweights the exemplar objective) is answered by the
tree's solve rounds over the resident machine blocks.

* **Static round geometry.**  Per fuse key ``(k, algorithm, eps,
  constraint signature, weighted?, Mp, μ, d, a, n_eval)`` the machine
  ladder is fixed: round 0 over all Mp blocks, then ``m_{t+1} = ⌈m_t k /
  μ⌉`` (strictly decreasing, else the request is rejected) down to one
  machine, so every request of a fuse key solves the same shapes.
* **Per-request parameters are device operands.**  Budgets and caps
  (``DynamicKnapsack``, ``DynamicPartitionMatroid``: the kernels read the
  knapsack limit and the caps from device memory), query weights
  (``WeightedExemplarClustering``'s eval weights) and the tail's slot
  permutations (drawn on the host before the launch, staged as tensors:
  :class:`TailDraws`) enter the solve as tensors, so one captured solve
  serves every request of its fuse key.
* **The compile cache is CUDA-graph capture.**  :class:`CompileCache`
  keeps the JAX package's key ``(kind, fuse key, bucket)``, LRU bound and
  counters.  On the card an entry is a captured ``torch.cuda.CUDAGraph``
  of the batched round 0 or the batched tail: its first call runs the
  body eagerly (the answer of that call, and the warm-up) and captures it;
  later calls copy the request operands into the graph's static inputs
  and replay it.  The resident blocks and the eval set are the graph's
  fixed inputs: after a delta the service copies the changed machines
  into the same device tensors, and a fixed input that moved forces a
  recapture, which ``steady_retraces()`` counts.  A body that reads the
  host (THRESHOLD-BATCH, once a τ-level) runs eagerly on every call;
  ``serve_stats()`` says which entries are graphs.  On the CPU every entry
  runs eagerly and is counted the same way.
* **Per-machine solution reuse.**  Round-0 solutions do not depend on
  the request seed, so they are cached per ``(fuse key, request
  fingerprint, generation)``; after a delta only the machines whose
  membership version moved are re-solved (each with its own draws),
  which gives the bits of a full re-solve.

Randomness: round 0 takes the session's plan (its slot permutation laid
out the blocks; stochastic greedy's round-0 draws come from it too), so
its solves never depend on the request.  Rounds ≥ 1 take a plan per
request seed: ``tail_plan(request_seed, ladder)``, by default
``TorchPlan`` seeded from (session seed, request seed); the parity tests
replay the JAX package's ``fold_in(key1, seed)`` chain through an
``ArrayPlan``.

A round-0 batch solves its B requests one after another over the shared
blocks (JAX's ``lax.map`` is a sequential loop too); a batch is padded to
its power-of-two bucket by repeating its last request.
"""
from __future__ import annotations

import collections
import dataclasses
import hashlib
import time
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.core.constraints import (DynamicKnapsack,
                                          DynamicPartitionMatroid,
                                          Intersection, Knapsack,
                                          PartitionMatroid, Unconstrained,
                                          check_feasible, from_spec)
from repro_torch.core.distributed import RoundResult, run_round
from repro_torch.core.objectives import (ExemplarClustering,
                                         WeightedExemplarClustering)
from repro_torch.core.partition import n_parts, repartition_rows
from repro_torch.core.plan import TorchPlan, machine_draws, round_draws
from repro_torch.core.tree import _fold_round
from repro_torch.device import resolve_device
from repro_torch.engine.telemetry import Histogram
from repro_torch.kernels import _build
from repro_torch.serve.session import SessionState

# ---------------------------------------------------------------------------
# requests / results
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class SelectionRequest:
    """One query against the resident ground set.

    ``constraint`` is a constraint of :mod:`repro_torch.core.constraints`,
    a spec string (``"knapsack:budget=2.5"``) or None; ``query`` an
    optional (d,) vector that reweights the exemplar objective toward
    nearby eval points (:func:`query_relevance_weights`); ``seed`` draws
    the partitions of rounds ≥ 1 only.  ``algorithm`` / ``eps`` pick the
    request's solve tier (None: the service's); both are fuse-key parts.
    """
    k: int
    constraint: Any = None
    query: Any = None
    seed: int = 0
    algorithm: str | None = None
    eps: float | None = None


@dataclasses.dataclass
class SelectionResult:
    rows: np.ndarray            # (k, d) selected feature rows (masked → 0)
    attrs: np.ndarray           # (k, a) their attribute rows
    mask: np.ndarray            # (k,) validity
    value: float                # objective value (reweighted if queried)
    oracle_calls: int
    feasible: bool
    detail: str
    latency_s: float = 0.0
    batch_size: int = 1
    solve_depth: int = 0        # Σ over rounds of the per-round machine max


# ---------------------------------------------------------------------------
# query → eval-point relevance weights
# ---------------------------------------------------------------------------


def query_relevance_weights(query, eval_set) -> np.ndarray:
    """RBF relevance of each eval point to the query, mean-normalized.

    ``w_j = n · exp(−‖e_j − q‖² / s) / Σ_i exp(−‖e_i − q‖² / s)`` with ``s``
    the median squared distance.  Mean 1, so the reweighted objective stays
    on the unweighted one's scale, and a uniform profile is exactly
    ``w = 1``, which the weighted kernels treat as the unweighted path.
    The JAX package's NumPy arithmetic, step for step.
    """
    E = np.asarray(eval_set, np.float32)
    q = np.asarray(query, np.float32).reshape(-1)
    if q.shape[0] != E.shape[1]:
        raise ValueError(f"query of {q.shape[0]} features against eval rows "
                         f"of {E.shape[1]}")
    d2 = np.sum((E - q[None, :]) ** 2, axis=1, dtype=np.float64)
    scale = float(np.median(d2))
    if scale <= 0.0:
        return np.ones((E.shape[0],), np.float32)
    rel = np.exp(-d2 / scale)
    w = rel * (rel.shape[0] / rel.sum())
    return np.asarray(w, np.float32)


# ---------------------------------------------------------------------------
# constraint (signature, params) packing: structure static, values operands
# ---------------------------------------------------------------------------


def constraint_signature(c) -> tuple:
    """Static identity of a constraint: class structure, columns and group
    count (everything that shapes the solve); the budget and cap values
    travel as operands."""
    if c is None or isinstance(c, Unconstrained):
        return ("none",)
    if isinstance(c, (Knapsack, DynamicKnapsack)):
        return ("knapsack", int(c.col))
    if isinstance(c, (PartitionMatroid, DynamicPartitionMatroid)):
        return ("partition", int(c.col), int(len(c.caps)))
    if isinstance(c, Intersection):
        return ("intersection",) + tuple(
            constraint_signature(p) for p in c.parts)
    raise TypeError(f"unsupported constraint {type(c).__name__}")


def constraint_params(c) -> np.ndarray:
    """The constraint's parameter values as one fp32 vector in signature
    order: the operand paired with :func:`constraint_signature`."""
    if c is None or isinstance(c, Unconstrained):
        return np.zeros((0,), np.float32)
    if isinstance(c, Knapsack):
        return np.asarray([c.budget], np.float32).reshape(1)
    if isinstance(c, DynamicKnapsack):
        return np.asarray([float(c.budget)], np.float32).reshape(1)
    if isinstance(c, PartitionMatroid):
        return np.asarray(c.caps, np.float32).reshape(-1)
    if isinstance(c, DynamicPartitionMatroid):
        return c.caps.cpu().numpy().astype(np.float32).reshape(-1)
    if isinstance(c, Intersection):
        parts = [constraint_params(p) for p in c.parts]
        return (np.concatenate(parts) if parts
                else np.zeros((0,), np.float32))
    raise TypeError(f"unsupported constraint {type(c).__name__}")


def build_constraint(sig: tuple, params: torch.Tensor):
    """The constraint of (static sig, params tensor), the inverse of the
    packing above: the ``Dynamic*`` classes over slices of ``params``, so
    no parameter value is read by the host."""
    c, used = _build_cons(sig, params, 0)
    if used != params.shape[0]:
        raise ValueError(f"signature {sig} takes {used} parameters, got "
                         f"{params.shape[0]}")
    return c


def _build_cons(sig, params, off):
    kind = sig[0]
    if kind == "none":
        return None, off
    if kind == "knapsack":
        return DynamicKnapsack(budget=params[off], col=sig[1]), off + 1
    if kind == "partition":
        G = sig[2]
        return (DynamicPartitionMatroid(
            caps=params[off:off + G].to(torch.int32), col=sig[1]), off + G)
    if kind != "intersection":
        raise ValueError(f"unknown constraint signature {sig}")
    parts = []
    for sub in sig[1:]:
        p, off = _build_cons(sub, params, off)
        parts.append(p)
    return Intersection(tuple(parts)), off


def _static_constraint(c):
    """The static twin of a (possibly dynamic) constraint: what the
    independent NumPy feasibility check takes."""
    if c is None or isinstance(c, (Unconstrained, Knapsack, PartitionMatroid)):
        return c
    if isinstance(c, DynamicKnapsack):
        return Knapsack(float(c.budget), c.col)
    if isinstance(c, DynamicPartitionMatroid):
        return PartitionMatroid(tuple(int(v) for v in c.caps.cpu().tolist()),
                                c.col)
    if not isinstance(c, Intersection):
        raise TypeError(f"unsupported constraint {type(c).__name__}")
    return Intersection(tuple(_static_constraint(p) for p in c.parts))


# ---------------------------------------------------------------------------
# solve bodies: functions of (static fuse key) × (tensor operands)
# ---------------------------------------------------------------------------

# fuse key layout: (k, alg, eps, cons_sig, weighted, Mp, mu, d, a, n_eval)


def round_ladder(Mp: int, k: int, mu: int) -> tuple[int, ...]:
    """Machine counts per round, fixed by (Mp, k, μ): ``m_0 = Mp``,
    ``m_{t+1} = ⌈m_t k / μ⌉`` until one machine.  Raises where the ladder
    stalls (k too close to μ), at request validation."""
    ms = [Mp]
    while ms[-1] > 1:
        nxt = n_parts(ms[-1] * k, mu)
        if nxt >= ms[-1]:
            raise ValueError(
                f"round ladder stalls at {ms[-1]} machines: k={k} too close "
                f"to capacity mu={mu} (need ceil(m*k/mu) < m)")
        ms.append(nxt)
    return tuple(ms)


def request_plan(session_seed: int, request_seed: int) -> TorchPlan:
    """The native plan of a request's rounds ≥ 1: a ``TorchPlan`` seeded
    from (session seed, request seed)."""
    h = hashlib.sha256(f"{int(session_seed)}:{int(request_seed)}".encode())
    return TorchPlan(int.from_bytes(h.digest()[:8], "little") >> 1)


class TailDraws:
    """A request's draws for rounds ≥ 1 as tensors, read by the tail as its
    plan: ``perms[t − 1]`` the slot permutation of round t and, for
    stochastic greedy, ``scores[t − 1]`` its ``(m_t, k, μ)`` scores.  They
    are drawn on the host before the launch (:func:`tail_draws`), so a
    captured tail draws nothing."""

    def __init__(self, perms, scores=None):
        self.perms, self.scores = list(perms), scores

    def slot_permutation(self, t: int, n_slots: int) -> torch.Tensor:
        perm = self.perms[t - 1]
        if tuple(perm.shape) != (n_slots,):
            raise ValueError(f"round {t}: staged permutation of "
                             f"{tuple(perm.shape)}, the partition has "
                             f"{n_slots} slots")
        return perm

    def stochastic_scores(self, t: int, m0: int, m1: int, j: int, cap: int,
                          device) -> torch.Tensor:
        return self.scores[t - 1][m0:m1, j]


def tail_draws(plan, fuse_key) -> list[torch.Tensor]:
    """The host tensors of a request's :class:`TailDraws` from its plan:
    each round's permutation (int64), then, for stochastic greedy, each
    round's scores."""
    k, alg, _eps, _sig, _w, Mp, mu, *_ = fuse_key
    ladder = round_ladder(Mp, k, mu)
    out = [plan.slot_permutation(t, m * mu).to(torch.int64)
           for t, m in enumerate(ladder[1:], start=1)]
    if alg == "stochastic_greedy":
        out += [torch.stack([plan.stochastic_scores(t, 0, m, j, mu, "cpu")
                             for j in range(k)], dim=1)
                for t, m in enumerate(ladder[1:], start=1)]
    return out


def _objective(eval_set, ew, weighted: bool):
    if weighted:
        return WeightedExemplarClustering(eval_set, eval_weights=ew)
    return ExemplarClustering(eval_set)


def make_round0_fn(fuse_key, plan):
    """Round 0 over the resident blocks for ONE request's (eval weights,
    constraint params): ``round0(blocks, bmask, machines, eval_set, ew,
    cparams)`` → the per-machine ``(sol_rows, sol_mask, values, calls,
    depth)``, the unit of the solution cache.  ``machines`` (an int64
    tensor, or None for all) picks the machines of a partial re-solve;
    stochastic greedy draws each machine's own scores from ``plan``."""
    k, alg, eps, sig, weighted, _Mp, mu, _d, a, _n_eval = fuse_key

    def round0(blocks, bmask, machines, eval_set, ew, cparams):
        dev = blocks.device
        draws = None
        if machines is not None:
            blocks = blocks.index_select(0, machines)
            bmask = bmask.index_select(0, machines)
            if alg == "stochastic_greedy":
                draws = machine_draws(plan, 0, machines, mu, dev)
        elif alg == "stochastic_greedy":
            draws = round_draws(plan, 0, 0, blocks.shape[0], mu, dev)
        res = run_round(_objective(eval_set, ew, weighted), blocks, bmask,
                        k=k, alg=alg, eps=eps, attr_dim=a,
                        constraint=build_constraint(sig, cparams),
                        draws=draws)
        return (res.sol_rows, res.sol_mask, res.values, res.oracle_calls,
                res.depth)

    return round0


def make_tail_fn(fuse_key):
    """The fold of round 0 and rounds ≥ 1 from one request's per-machine
    round-0 results: ``tail(sol_rows, sol_mask, values, calls, depth,
    eval_set, ew, cparams, draws)`` → ``(best_rows, best_mask, best_val,
    total_calls, solve_depth)``; ``draws`` is the request's
    :class:`TailDraws`.  No host read."""
    k, alg, eps, sig, weighted, Mp, mu, d, a, _n_eval = fuse_key
    ladder = round_ladder(Mp, k, mu)
    w = d + a

    def tail(sol_rows, sol_mask, values, calls, depth, eval_set, ew,
             cparams, draws):
        dev = sol_rows.device
        obj = _objective(eval_set, ew, weighted)
        cons = build_constraint(sig, cparams)
        best = (torch.zeros((k, w), dtype=torch.float32, device=dev),
                torch.zeros((k,), dtype=torch.bool, device=dev),
                torch.full((), -torch.inf, dtype=torch.float32, device=dev),
                torch.zeros((), dtype=torch.long, device=dev))
        *best, _ = _fold_round(RoundResult(sol_rows, sol_mask, values, calls,
                                           depth), *best)
        solve_depth = torch.max(depth)
        rows_in, mask_in = sol_rows.reshape(-1, w), sol_mask.reshape(-1)
        for t, m in enumerate(ladder[1:], start=1):
            blk, bm = repartition_rows(rows_in, mask_in, draws, t, m, mu)
            res = run_round(obj, blk, bm, k=k, alg=alg, eps=eps, attr_dim=a,
                            constraint=cons,
                            draws=(round_draws(draws, t, 0, m, mu, dev)
                                   if alg == "stochastic_greedy" else None))
            *best, _ = _fold_round(res, *best)
            solve_depth = solve_depth + torch.max(res.depth)
            rows_in = res.sol_rows.reshape(-1, w)
            mask_in = res.sol_mask.reshape(-1)
        return (*best, solve_depth)

    return tail


def _batched_round0(fuse_key, plan, partial: bool):
    """Round 0 of a bucket of requests, one after another over the shared
    blocks: ``(blocks, bmask, eval_set[, machines], ews, cps)`` → the five
    results stacked over the bucket."""
    body = make_round0_fn(fuse_key, plan)

    def batched(blocks, bmask, eval_set, *ops):
        machines, ews, cps = ops if partial else (None, *ops)
        outs = [body(blocks, bmask, machines, eval_set, ews[b], cps[b])
                for b in range(ews.shape[0])]
        return tuple(torch.stack(x) for x in zip(*outs))

    return batched


def _tail_draws_of(fuse_key, draws) -> TailDraws:
    """The :class:`TailDraws` of one request's :func:`tail_draws` list."""
    k, _alg, _eps, _sig, _w, Mp, mu, *_ = fuse_key
    rounds = len(round_ladder(Mp, k, mu)) - 1
    return TailDraws(draws[:rounds], draws[rounds:] or None)


def _batched_tail(fuse_key):
    """The tail of a bucket of requests: ``(eval_set, sol_rows, sol_mask,
    values, calls, depth, ews, cps, *draws)`` with every operand stacked
    over the bucket → the five results stacked."""
    body = make_tail_fn(fuse_key)

    def batched(eval_set, srows, smask, svals, scalls, sdepth, ews, cps,
                *draws):
        outs = [body(srows[b], smask[b], svals[b], scalls[b], sdepth[b],
                     eval_set, ews[b], cps[b],
                     _tail_draws_of(fuse_key, [x[b] for x in draws]))
                for b in range(srows.shape[0])]
        return tuple(torch.stack(x) for x in zip(*outs))

    return batched


# ---------------------------------------------------------------------------
# compile cache: entries keyed (kind, fuse key, bucket)
# ---------------------------------------------------------------------------


def _layout(t: torch.Tensor) -> tuple:
    return (t.data_ptr(), tuple(t.shape), t.dtype, t.device)


class _EagerEntry:
    """A body run eagerly on every call (the CPU, or a body that reads the
    host); its first call counts as its one build."""

    graph = False

    def __init__(self, cache: "CompileCache", key: tuple, fn: Callable):
        self.cache, self.key, self.fn, self.built = cache, key, fn, False

    def __call__(self, fixed: tuple, inputs: tuple) -> tuple:
        if not self.built:
            self.built = True
            self.cache._count(self.key)
        return self.fn(*fixed, *(x.to(self.cache.device) for x in inputs))


class _GraphEntry:
    """A body captured in a ``torch.cuda.CUDAGraph``.

    ``fixed`` are resident tensors the graph reads where they lie (the
    staged blocks, the eval set); ``inputs`` the request operands, copied
    into the graph's static buffers before each replay.  The first call
    (and a call whose fixed tensors moved: a recapture) runs the body
    eagerly on the static buffers, which is that call's answer and the
    warm-up, then captures it on the cache's side stream in thread-local
    mode.  A replay returns the graph's static outputs, valid until the
    next call.  The kernel launches counted while capturing are taken back
    and added again at each replay, so ``launch_counts`` counts what runs.
    """

    graph = True

    def __init__(self, cache: "CompileCache", key: tuple, fn: Callable):
        self.cache, self.key, self.fn = cache, key, fn
        self.g = self.layout = self.static_in = self.static_out = None
        self.launches: dict[str, int] = {}

    def __call__(self, fixed: tuple, inputs: tuple) -> tuple:
        layout = tuple(_layout(t) for t in fixed)
        if self.g is None or layout != self.layout:
            return self._capture(fixed, inputs, layout)
        for dst, src in zip(self.static_in, inputs):
            dst.copy_(src)
        self.g.replay()
        for name, n in self.launches.items():
            _build.launch_counts[name] += n
        self.cache.replays += 1
        return self.static_out

    def _capture(self, fixed, inputs, layout) -> tuple:
        dev = self.cache.device
        self.static_in = [torch.empty(x.shape, dtype=x.dtype, device=dev)
                          .copy_(x) for x in inputs]
        out = self.fn(*fixed, *self.static_in)          # the eager answer
        torch.cuda.synchronize(dev)
        before = dict(_build.launch_counts)
        g = torch.cuda.CUDAGraph()
        side = self.cache.side_stream()
        with torch.cuda.graph(g, stream=side,
                              capture_error_mode="thread_local"):
            self.static_out = self.fn(*fixed, *self.static_in)
        torch.cuda.current_stream(dev).wait_stream(side)
        self.launches = {k: v - before[k]
                         for k, v in _build.launch_counts.items()
                         if v != before[k]}
        _build.launch_counts.update(before)    # capture launched nothing
        self.g, self.layout = g, layout
        self.cache._count(self.key)
        return out


class CompileCache:
    """Solve entries with capture accounting and LRU eviction.

    ``entry(kind, fuse_key, bucket, build, capture)`` returns the entry of
    that key, building it on first use: a :class:`_GraphEntry` on the card
    where ``capture`` (the body reads no host value), else an eager one.
    ``compiles`` counts captures (first calls of eager entries) across all
    entries; ``steady_retraces()`` counts captures beyond the first per
    entry, which a warm service must leave at 0 (the JAX package's retrace
    probe).  ``capacity`` bounds the entries: a hit refreshes recency, an
    insert past the bound evicts the least recently used entry and its
    graph (a later rebuild is a fresh capture, not a retrace).
    """

    def __init__(self, capacity: int | None = None, metrics=None,
                 device="cpu"):
        if capacity is not None and capacity < 1:
            raise ValueError(f"capacity={capacity} < 1")
        self._fns: "collections.OrderedDict[tuple, Any]" = \
            collections.OrderedDict()
        self.capacity = capacity
        self.device = torch.device(device)
        self.compiles = 0            # captures / eager first calls
        self.hits = 0                # entry() calls served by an entry
        self.evictions = 0           # LRU entries dropped at capacity
        self.replays = 0             # graph replays
        self.metrics = metrics       # telemetry MetricsRegistry, or None
        self._trace_counts: dict[tuple, int] = {}
        self._stream = None

    @property
    def keys(self) -> list[tuple]:
        return list(self._fns)

    @property
    def graph_keys(self) -> list[tuple]:
        return [k for k, e in self._fns.items() if e.graph]

    def steady_retraces(self) -> int:
        """Captures beyond the first per entry: nonzero means a warm entry
        was captured again."""
        return sum(max(0, c - 1) for c in self._trace_counts.values())

    def side_stream(self) -> torch.cuda.Stream:
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
        return self._stream

    def _count(self, key) -> None:
        self.compiles += 1
        self._trace_counts[key] = self._trace_counts.get(key, 0) + 1

    def entry(self, kind: str, fuse_key: tuple, bucket, build,
              capture: bool = True):
        key = (kind, fuse_key, bucket)
        ent = self._fns.get(key)
        if ent is not None:
            self.hits += 1
            self._fns.move_to_end(key)             # refresh LRU recency
            return ent
        cls = (_GraphEntry if capture and self.device.type == "cuda"
               else _EagerEntry)
        ent = self._fns[key] = cls(self, key, build())
        while self.capacity is not None and len(self._fns) > self.capacity:
            old_key, _ = self._fns.popitem(last=False)
            self._trace_counts.pop(old_key, None)
            self.evictions += 1
            if self.metrics is not None:
                self.metrics.counter("serve_compile_cache_evictions").inc()
        if self.metrics is not None:
            self.metrics.gauge("serve_compile_cache_entries").set(
                len(self._fns))
        return ent


def _bucket(n: int) -> int:
    """Pad counts to powers of two so batch sizes hit few distinct shapes."""
    b = 1
    while b < n:
        b *= 2
    return b


def _pad(xs: list, B: int) -> list:
    """``xs`` padded to B by repeating its last element."""
    return xs + [xs[-1]] * (B - len(xs))


# ---------------------------------------------------------------------------
# the service
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class _Prep:
    req: SelectionRequest
    cons_static: Any
    sig: tuple
    weighted: bool
    ew: np.ndarray               # (n_eval,) fp32, or (0,) when unweighted
    cparams: np.ndarray          # (P,) fp32
    fuse_key: tuple
    fp: str                      # request fingerprint (sol-cache key part)


class SelectionService:
    """Answers :class:`SelectionRequest` s against a resident session.

    ``serve(requests)`` groups a micro-batch by fuse key, pads each group
    to a power-of-two bucket, and solves each group through the compile
    cache's entries (see the module docstring).  Runs on the card unless
    ``device="cpu"``.  Round 0 takes the session's plan (else
    ``TorchPlan(session.seed)``); ``tail_plan(request_seed, ladder)``
    gives a request's plan of rounds ≥ 1 (default :func:`request_plan`).
    Answers are deterministic per (fuse key, bucket), and the bucket-1
    path equals :func:`offline_solve` bit for bit.
    """

    def __init__(self, session: SessionState, eval_set, *,
                 algorithm: str = "greedy", eps: float = 0.5,
                 tracer=None, compile_cache_capacity: int | None = None,
                 sol_cache_capacity: int | None = None, device="cuda",
                 tail_plan=None):
        if sol_cache_capacity is not None and sol_cache_capacity < 1:
            raise ValueError(f"sol_cache_capacity={sol_cache_capacity} < 1")
        self.device = resolve_device(device)
        self.session = session
        self.eval_set = np.asarray(eval_set, np.float32)
        self._eval_dev = torch.tensor(self.eval_set, device=self.device)
        self.algorithm = algorithm
        self.eps = eps
        self.tracer = tracer
        self.plan = _session_plan(session)
        self.tail_plan = tail_plan or (
            lambda seed, _ladder: request_plan(session.seed, seed))
        self.cache = CompileCache(
            capacity=compile_cache_capacity,
            metrics=tracer.metrics if tracer is not None else None,
            device=self.device)
        # keys embed the session generation, so a superseded generation's
        # entries never hit again and drain first once capacity binds
        self._sol_cache: "collections.OrderedDict[tuple, dict]" = \
            collections.OrderedDict()
        self.sol_cache_capacity = sol_cache_capacity
        self.sol_evictions = 0
        self._dev: dict[str, dict] = {}
        self.requests_served = 0
        self.batches = 0
        self.deltas = 0
        self.delta_changed = 0
        self.rebuilds = 0
        self.sol_hits = 0
        self.partial_resolves = 0
        self.queue_depth_max = 0
        self.latencies_s: list[float] = []
        self.last_value = 0.0
        self.last_calls = 0
        self.last_rounds = 0
        self.last_depth = 0

    # -- staging -----------------------------------------------------------
    def _staged(self, wide: bool) -> tuple[torch.Tensor, torch.Tensor]:
        """Device copies of the resident blocks (with the attribute columns
        where ``wide``) and their mask.  They stay in the same storage: a
        delta copies its changed machines in place, a rebuild of the same
        geometry every machine; only a new geometry allocates anew."""
        s = self.session
        name = "wide" if wide else "narrow"
        ent = self._dev.get(name)
        shape = (s.Mp, s.mu, s.d + (s.a if wide else 0))
        if ent is None or tuple(ent["blocks"].shape) != shape:
            ent = self._dev[name] = {
                "blocks": _device_blocks(s, wide, self.device),
                "bmask": torch.tensor(s.valid, device=self.device)}
        elif ent["generation"] != s.generation:
            ent["blocks"].copy_(_device_blocks(s, wide, self.device))
            ent["bmask"].copy_(torch.from_numpy(s.valid))
        else:
            changed = np.flatnonzero(ent["versions"] != s.versions)
            if changed.size:
                idx = torch.from_numpy(changed).to(self.device)
                ent["blocks"].index_copy_(0, idx, _device_blocks(
                    s, wide, self.device, changed))
                ent["bmask"].index_copy_(
                    0, idx, torch.from_numpy(s.valid[changed]).to(
                        self.device))
        ent["generation"], ent["versions"] = s.generation, s.versions.copy()
        return ent["blocks"], ent["bmask"]

    def _capturable(self, alg: str) -> bool:
        """Whether the solves of ``alg`` read no host value: GREEDY, and
        stochastic greedy with a plan that hashes its draws on the device
        (THRESHOLD-BATCH and threshold greedy read the host per level)."""
        return alg == "greedy" or (alg == "stochastic_greedy"
                                   and isinstance(self.plan, TorchPlan))

    # -- request preparation -----------------------------------------------
    def _prepare(self, req: SelectionRequest) -> _Prep:
        s = self.session
        if not 0 < req.k < s.mu:
            raise ValueError(f"request k={req.k} must satisfy 0 < k < "
                             f"mu={s.mu}")
        cons = (from_spec(req.constraint) if isinstance(req.constraint, str)
                else req.constraint)
        sig = constraint_signature(cons)
        cparams = constraint_params(cons)
        weighted = req.query is not None
        ew = (query_relevance_weights(req.query, self.eval_set) if weighted
              else np.zeros((0,), np.float32))
        if sig != ("none",) and s.a == 0:
            raise ValueError("constrained request against an attribute-less "
                             "session: ingest with attrs")
        a_used = 0 if sig == ("none",) else s.a
        alg = self.algorithm if req.algorithm is None else req.algorithm
        eps = self.eps if req.eps is None else req.eps
        fuse_key = (req.k, alg, eps, sig, weighted,
                    s.Mp, s.mu, s.d, a_used, self.eval_set.shape[0])
        round_ladder(s.Mp, req.k, s.mu)       # validate early (may raise)
        h = hashlib.sha1()
        h.update(repr(fuse_key).encode())
        h.update(cparams.tobytes())
        h.update(ew.tobytes())
        return _Prep(req=req, cons_static=_static_constraint(cons), sig=sig,
                     weighted=weighted, ew=ew, cparams=cparams,
                     fuse_key=fuse_key, fp=h.hexdigest())

    # -- serving -------------------------------------------------------------
    def query(self, req: SelectionRequest) -> SelectionResult:
        return self.serve([req])[0]

    def serve(self, requests: list[SelectionRequest]
              ) -> list[SelectionResult]:
        if not requests:
            return []
        results: list[SelectionResult | None] = [None] * len(requests)
        groups: dict[tuple, list[tuple[int, _Prep]]] = {}
        for i, req in enumerate(requests):
            prep = self._prepare(req)
            groups.setdefault(prep.fuse_key, []).append((i, prep))
        for fk, items in groups.items():
            t0 = time.perf_counter()
            outs = self._serve_group(fk, items)
            t1 = time.perf_counter()
            lat = t1 - t0
            for (i, _prep), out in zip(items, outs):
                out.latency_s = lat
                out.batch_size = len(items)
                results[i] = out
                self.latencies_s.append(lat)
            self.requests_served += len(items)
            self.batches += 1
            if self.tracer is not None:
                self.tracer.emit("request-batch", "serve", t0, t1,
                                 track="serve", batch=len(items),
                                 k=fk[0], constraint=str(fk[3][0]))
                m = self.tracer.metrics
                m.counter("serve_requests").inc(len(items))
                m.counter("serve_batches").inc()
                m.histogram("serve_batch_size").observe(len(items))
                for _ in items:
                    m.histogram("serve_request_latency_s").observe(lat)
        return results                                 # type: ignore

    def _serve_group(self, fk, items) -> list[SelectionResult]:
        s = self.session
        k, alg, _eps, _sig, _weighted, Mp, mu, d, a, _n_eval = fk
        blocks, bmask = self._staged(a > 0)
        gen = s.generation

        # per-request round-0 solutions: cache → partial → batched miss
        sols: list[tuple | None] = [None] * len(items)
        misses: list[int] = []
        for j, (_i, prep) in enumerate(items):
            ck = (fk, prep.fp, gen)
            ent = self._sol_cache.get(ck)
            if ent is None:
                misses.append(j)
                continue
            self._sol_cache.move_to_end(ck)        # refresh LRU recency
            changed = np.flatnonzero(ent["versions"] != s.versions)
            if changed.size:
                self._partial_resolve(fk, prep, ent, changed, blocks, bmask)
            else:
                self.sol_hits += 1
            sols[j] = ent["sols"]
        if misses:
            self._solve_misses(fk, items, misses, sols, blocks, bmask)

        # the tail: fold + rounds ≥ 1, batched over the group
        B = _bucket(len(items))
        preps = _pad([p for _i, p in items], B)
        sols = _pad(sols, B)
        draws = [tail_draws(self.tail_plan(p.req.seed,
                                           round_ladder(Mp, k, mu)), fk)
                 for p in preps]
        inputs = ([torch.stack([sv[c] for sv in sols]) for c in range(5)]
                  + [torch.from_numpy(np.stack([p.ew for p in preps])),
                     torch.from_numpy(np.stack([p.cparams for p in preps]))]
                  + [torch.stack(x) for x in zip(*draws)])
        fn = self.cache.entry("tail", fk, B, lambda: _batched_tail(fk),
                              capture=self._capturable(alg))
        out = fn((self._eval_dev,), tuple(inputs))
        brows, bmasks, bvals, bcalls, bdepth = (x.cpu().numpy() for x in out)

        outs = []
        for j, (_i, prep) in enumerate(items):
            rows, attrs = brows[j][:, :d], brows[j][:, d:]
            ok, detail = check_feasible(prep.cons_static, attrs, bmasks[j])
            self.last_value = float(bvals[j])
            self.last_calls = int(bcalls[j])
            self.last_rounds = len(round_ladder(Mp, k, mu))
            self.last_depth = int(bdepth[j])
            outs.append(SelectionResult(
                rows=rows, attrs=attrs, mask=bmasks[j], value=float(bvals[j]),
                oracle_calls=int(bcalls[j]), feasible=bool(ok),
                detail=detail, solve_depth=int(bdepth[j])))
        return outs

    def _solve_misses(self, fk, items, misses, sols, blocks, bmask) -> None:
        """Round 0 of the requests with no cached solutions, through one
        entry; the results land in the solution cache."""
        s = self.session
        B = _bucket(len(misses))
        preps = _pad([items[j][1] for j in misses], B)
        fn = self.cache.entry(
            "round0", fk, (B, s.Mp),
            lambda: _batched_round0(fk, self.plan, partial=False),
            capture=self._capturable(fk[1]))
        out = fn((blocks, bmask, self._eval_dev),
                 (torch.from_numpy(np.stack([p.ew for p in preps])),
                  torch.from_numpy(np.stack([p.cparams for p in preps]))))
        for b, j in enumerate(misses):
            sv = tuple(x[b].clone() for x in out)
            self._sol_cache[(fk, items[j][1].fp, s.generation)] = {
                "versions": s.versions.copy(), "sols": sv}
            sols[j] = sv
        while (self.sol_cache_capacity is not None
               and len(self._sol_cache) > self.sol_cache_capacity):
            self._sol_cache.popitem(last=False)
            self.sol_evictions += 1
            if self.tracer is not None:
                self.tracer.metrics.counter("serve_sol_cache_evictions").inc()
        if self.tracer is not None:
            self.tracer.metrics.gauge("serve_sol_cache_entries").set(
                len(self._sol_cache))

    def _partial_resolve(self, fk, prep, ent, changed, blocks, bmask) -> None:
        """Re-solve only the machines whose membership version moved since
        the request's round-0 solutions were cached, each with its own
        draws, and scatter them into the cached solutions: the delta fast
        path.  A bucket that would reach every machine solves them all
        through the full round-0 entry."""
        s = self.session
        C = int(changed.size)
        Cp = _bucket(C)
        ew = torch.from_numpy(prep.ew[None])
        cp = torch.from_numpy(prep.cparams[None])
        if Cp >= s.Mp:
            changed = np.arange(s.Mp)
            C = s.Mp
            fn = self.cache.entry(
                "round0", fk, (1, s.Mp),
                lambda: _batched_round0(fk, self.plan, partial=False),
                capture=self._capturable(fk[1]))
            out = fn((blocks, bmask, self._eval_dev), (ew, cp))
        else:
            idx = np.concatenate([changed, np.repeat(changed[-1:], Cp - C)])
            fn = self.cache.entry(
                "round0", fk, (1, Cp),
                lambda: _batched_round0(fk, self.plan, partial=True),
                capture=self._capturable(fk[1]))
            out = fn((blocks, bmask, self._eval_dev),
                     (torch.from_numpy(idx.astype(np.int64)), ew, cp))
        at = torch.from_numpy(changed.astype(np.int64)).to(self.device)
        for sv, new in zip(ent["sols"], out):
            sv.index_copy_(0, at, new[0, :C])
        ent["versions"] = s.versions.copy()
        self.partial_resolves += 1
        if self.tracer is not None:
            self.tracer.instant("partial-resolve", "serve", track="serve",
                                machines=C)

    # -- ground-set deltas ---------------------------------------------------
    def apply_delta(self, insert_rows=None, delete_ids=None,
                    insert_attrs=None):
        t0 = time.perf_counter()
        rep = self.session.apply_delta(insert_rows=insert_rows,
                                       delete_ids=delete_ids,
                                       insert_attrs=insert_attrs)
        self.deltas += 1
        self.delta_changed += len(rep.changed_machines)
        self.rebuilds += int(rep.rebuilt)
        if self.tracer is not None:
            self.tracer.emit("delta", "serve", t0, time.perf_counter(),
                             track="serve", inserted=rep.inserted,
                             deleted=rep.deleted,
                             changed=len(rep.changed_machines),
                             rebuilt=rep.rebuilt)
        return rep

    def note_queue_depth(self, depth: int) -> None:
        self.queue_depth_max = max(self.queue_depth_max, int(depth))
        if self.tracer is not None:
            self.tracer.metrics.gauge("serve_queue_depth").set(depth)
            self.tracer.metrics.histogram(
                "serve_queue_depth_hist").observe(depth)

    # -- reporting -------------------------------------------------------------
    def serve_stats(self) -> dict:
        h = Histogram()
        for v in self.latencies_s:
            h.observe(v)
        sm = h.summary()
        return {
            "requests": self.requests_served,
            "batches": self.batches,
            "latency_p50_ms": 1e3 * (sm.get("p50") or 0.0),
            "latency_p95_ms": 1e3 * (sm.get("p95") or 0.0),
            "queue_depth_max": int(self.queue_depth_max),
            "cache_keys": len(self.cache.keys),
            "graph_entries": len(self.cache.graph_keys),
            "compiles": self.cache.compiles,
            "cache_hits": self.cache.hits,
            "cache_evictions": self.cache.evictions,
            "cache_capacity": self.cache.capacity,
            "replays": self.cache.replays,
            "steady_retraces": self.cache.steady_retraces(),
            "sol_cache_hits": self.sol_hits,
            "sol_cache_entries": len(self._sol_cache),
            "sol_cache_evictions": self.sol_evictions,
            "sol_cache_capacity": self.sol_cache_capacity,
            "partial_resolves": self.partial_resolves,
            "deltas": self.deltas,
            "changed_machines": self.delta_changed,
            "rebuilds": self.rebuilds,
        }


def _device_blocks(session: SessionState, wide: bool, device,
                   machines=None) -> torch.Tensor:
    """A fresh device copy of the resident blocks (of ``machines`` where
    given), with the attribute columns appended where ``wide``: each host
    array crosses as it is and the columns join on the device."""
    parts = [session.blocks] + ([session.attrs] if wide else [])
    return torch.cat([torch.from_numpy(
        p if machines is None else p[machines]).to(device) for p in parts],
        dim=2)


def _session_plan(session: SessionState):
    """Round 0's plan: the session's (its slots), else the default of its
    seed (a session loaded from files)."""
    return session.plan if session.plan is not None else TorchPlan(
        session.seed)


# ---------------------------------------------------------------------------
# offline reference: the same bodies, called once, eagerly
# ---------------------------------------------------------------------------


def offline_solve(session: SessionState, eval_set, req: SelectionRequest, *,
                  algorithm: str = "greedy", eps: float = 0.5,
                  device="cuda", tail_plan=None) -> SelectionResult:
    """Direct solve of one request against the resident state: the round
    bodies the service caches, called once eagerly on freshly staged
    blocks, with no batching, caching, capture or partial re-solve.
    Served == offline says the serving apparatus is execution policy
    only.  ``tail_plan`` as :class:`SelectionService`'s."""
    dev = resolve_device(device)
    svc = SelectionService.__new__(SelectionService)     # prep helpers only
    svc.session = session
    svc.eval_set = np.asarray(eval_set, np.float32)
    svc.algorithm = algorithm
    svc.eps = eps
    prep = svc._prepare(req)
    fk = prep.fuse_key
    k, _alg, _eps, _sig, _w, Mp, mu, d, a, _n_eval = fk
    plan = _session_plan(session)
    tail_plan = tail_plan or (
        lambda seed, _ladder: request_plan(session.seed, seed))
    ev = torch.tensor(svc.eval_set, device=dev)
    ew = torch.from_numpy(prep.ew).to(dev)
    cp = torch.from_numpy(prep.cparams).to(dev)
    r0 = make_round0_fn(fk, plan)(
        _device_blocks(session, a > 0, dev),
        torch.tensor(session.valid, device=dev), None, ev, ew, cp)
    draws = [x.to(dev) for x in tail_draws(
        tail_plan(req.seed, round_ladder(Mp, k, mu)), fk)]
    out = make_tail_fn(fk)(*r0, ev, ew, cp, _tail_draws_of(fk, draws))
    brows, bmask, bval, bcalls, bdepth = (x.cpu().numpy() for x in out)
    rows, attrs = brows[:, :d], brows[:, d:]
    ok, detail = check_feasible(prep.cons_static, attrs, bmask)
    return SelectionResult(rows=rows, attrs=attrs, mask=bmask,
                           value=float(bval), oracle_calls=int(bcalls),
                           feasible=bool(ok), detail=detail,
                           solve_depth=int(bdepth))
