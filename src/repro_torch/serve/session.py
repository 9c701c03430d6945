"""Resident session state for the selection service (counterpart of
``repro.serve.session``).

A :class:`SessionState` is what a long-running server owns: the ground
set, ingested once through the round-0 wave engine (sync or pipelined
scheduler, fixed, scheduled or autotuned widths, ingestion hosts, fault
supervision) into per-machine candidate blocks laid out as round 0 of the
tree would see them: the same slot permutation of the plan (dense or
Feistel), the same machine count, zero rows in empty slots.  Requests then
solve against these blocks (:mod:`repro_torch.serve.service`) without
reading the source again.

Ingestion is round 0 of :func:`repro_torch.core.tree.tree_maximize` with a
store in place of the solve.  Narrow (bf16, int8) sources are dequantized
on the host at store time by :meth:`QuantizedSource.dequantize` (the
kernels' dequant arithmetic), so the resident state is fp32 and every
solve path downstream takes one row type.  The host arrays are the truth;
the service stages device copies of them.

:meth:`SessionState.apply_delta` edits membership in place: deletes clear
slots, inserts fill free slots lowest linear index first (machine-major),
and each changed machine's ``versions`` entry is bumped so the service
re-solves only those blocks.  :meth:`SessionState.rebuild` re-ingests the
base source and replays the delta log through the same placement rule, so
the resident arrays after a delta and after a rebuild are equal element
for element; ``apply_delta`` falls back to it when the free slots run out.

Files written by :meth:`SessionState.save` load in either package, and
:meth:`SessionState.fingerprint` gives the JAX package's string.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
from typing import Any

import numpy as np
import torch

from repro_torch.core.partition import n_parts
from repro_torch.core.plan import TorchPlan
from repro_torch.core.sources import (GroundSetSource, QuantizedSource,
                                      as_source, dtype_itemsize, take_rows)
from repro_torch.core.tree import (IngestStats, TreeConfig,
                                   _round0_slot_blocks, _wave_planner,
                                   _wave_size)
from repro_torch.engine import (AutotunePlanner, EngineConfig, FaultPolicy,
                                FaultSupervisor, HostWave, IngestionPlan,
                                run_waves)

#: the JSON metadata of a saved session, the JAX package's keys
_META = ("mu", "d", "a", "L", "Mp", "seed", "permutation", "n_base",
         "next_id", "generation", "dropped_rows")


@dataclasses.dataclass
class DeltaReport:
    """Outcome of one :meth:`SessionState.apply_delta` call."""
    inserted: int
    deleted: int
    changed_machines: list[int]
    rebuilt: bool = False


@dataclasses.dataclass
class SessionState:
    """Resident per-machine ground-set blocks, attributes and membership.

    ``blocks[m, s]`` is the fp32 row of the item in machine m, slot s
    (zeros where ``valid[m, s]`` is False), ``attrs`` its attribute row and
    ``item_ids`` its stable id (base items ``0 .. n_base − 1`` in source
    order, inserts counting up from there, −1 empty).  ``versions[m]``
    grows whenever machine m's membership changes; the service's round-0
    solution cache compares against it.  ``plan`` is the round plan of
    ingestion (round 0's slots), kept for :meth:`rebuild`.
    """

    blocks: np.ndarray          # (Mp, mu, d) fp32
    attrs: np.ndarray           # (Mp, mu, a) fp32 (a may be 0)
    valid: np.ndarray           # (Mp, mu) bool
    item_ids: np.ndarray        # (Mp, mu) int64, -1 empty
    versions: np.ndarray        # (Mp,) int64
    mu: int
    d: int
    a: int
    L: int
    Mp: int
    seed: int
    permutation: str
    n_base: int
    next_id: int
    generation: int = 0         # bumped by rebuild
    dropped_rows: int = 0       # rows forfeited by fault-budget wave drops
    cfg: TreeConfig | None = None
    source: GroundSetSource | None = None    # base source (rebuild reads it)
    plan: Any = None
    base_attrs: np.ndarray | None = None     # ingest's attrs= override
    delta_log: list[dict] = dataclasses.field(default_factory=list)
    ingest_stats: IngestStats | None = None
    engine_stats: Any = None
    fault_stats: Any = None
    # id → linear slot m·μ + s of the item (−1: not resident), one int64 per
    # id ever issued: a vectorized index, where the JAX package keeps a
    # Python dict (45M entries at Webscope, about a minute to build)
    _slot: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros((0,), np.int64))

    @property
    def n_items(self) -> int:
        return int(self.valid.sum())

    @property
    def free_slots(self) -> int:
        return self.valid.size - self.n_items

    def position(self, item_id: int) -> tuple[int, int]:
        """(machine, slot) of a resident item; ``KeyError`` otherwise."""
        lin = (int(self._slot[item_id]) if 0 <= item_id < self._slot.size
               else -1)
        if lin < 0:
            raise KeyError(f"item {item_id} is not resident")
        return divmod(lin, self.mu)

    def fingerprint(self) -> str:
        """Identity of the resident membership (not the row bytes): the
        JAX package's digest of the same arrays."""
        h = hashlib.sha256()
        h.update(np.ascontiguousarray(self.item_ids, np.int64).tobytes())
        h.update(np.asarray([self.generation, self.Mp, self.mu],
                            np.int64).tobytes())
        return h.hexdigest()[:16]

    # -- incremental membership --------------------------------------------
    def apply_delta(self, insert_rows: np.ndarray | None = None,
                    delete_ids=None, insert_attrs: np.ndarray | None = None,
                    _log: bool = True) -> DeltaReport:
        """Insert and delete items in place, machine by machine.

        Deletes clear the slot of each given id (``KeyError`` for an id
        not resident); inserts take fresh sequential ids and fill free
        slots lowest linear index first, the placement rule the rebuild
        replays.  Inserts beyond the free slots fall back to
        :meth:`rebuild` (the geometry grows).  ``changed_machines`` lists
        every machine whose ``versions`` entry was bumped.
        """
        ins = (np.zeros((0, self.d), np.float32) if insert_rows is None
               else np.asarray(insert_rows, np.float32).reshape(-1, self.d))
        dels = [int(i) for i in (delete_ids if delete_ids is not None else [])]
        if self.a and len(ins) and insert_attrs is None:
            raise ValueError("the session carries attribute columns: "
                             "inserts need insert_attrs")
        iattrs = (np.zeros((len(ins), self.a), np.float32)
                  if insert_attrs is None
                  else np.asarray(insert_attrs, np.float32).reshape(
                      len(ins), self.a))
        new_ids = list(range(self.next_id, self.next_id + len(ins)))
        if _log:
            self.delta_log.append({
                "insert_rows": ins.copy(), "insert_attrs": iattrs.copy(),
                "insert_ids": list(new_ids), "delete_ids": list(dels)})

        changed: set[int] = set()
        for did in dels:
            try:
                m, s = self.position(did)
            except KeyError:
                raise KeyError(f"delete of unknown/already-deleted id "
                               f"{did}") from None
            self._slot[did] = -1
            self.valid[m, s] = False
            self.item_ids[m, s] = -1
            self.blocks[m, s] = 0.0
            if self.a:
                self.attrs[m, s] = 0.0
            changed.add(m)

        if len(ins) > self.free_slots:
            # the log entry above holds this delta, so the replay has it
            self.rebuild()
            return DeltaReport(inserted=len(ins), deleted=len(dels),
                               changed_machines=list(range(self.Mp)),
                               rebuilt=True)

        free = np.flatnonzero(~self.valid.reshape(-1))[:len(ins)]
        self._slot = np.concatenate([self._slot, free.astype(np.int64)])
        for j, lin in enumerate(free):
            m, s = divmod(int(lin), self.mu)
            self.valid[m, s] = True
            self.item_ids[m, s] = new_ids[j]
            self.blocks[m, s] = ins[j]
            if self.a:
                self.attrs[m, s] = iattrs[j]
            changed.add(m)
        self.next_id += len(ins)
        for m in sorted(changed):
            self.versions[m] += 1
        return DeltaReport(inserted=len(ins), deleted=len(dels),
                           changed_machines=sorted(changed))

    def rebuild(self) -> None:
        """Re-ingest the base source and replay the delta log.

        The replay applies every logged delta through the incremental
        placement rule, so without a geometry change the arrays equal
        those the deltas left.  The geometry grows (a larger L) only where
        the live items' high-water mark outruns the capacity.
        """
        if self.source is None or self.cfg is None:
            raise RuntimeError("rebuild needs the base source (sessions "
                               "restored from a checkpoint are frozen)")
        live = high = self.n_base
        for e in self.delta_log:
            live += len(e["insert_ids"]) - len(e["delete_ids"])
            high = max(high, live)
        L_new = self.L if high <= self.L * self.mu else n_parts(high, self.mu)
        log = self.delta_log
        fresh = ingest(self.source, self.cfg, attrs=self.base_attrs,
                       plan=self.plan, _L=L_new)
        for f in ("blocks", "attrs", "valid", "item_ids", "versions",
                  "L", "Mp", "next_id", "_slot", "dropped_rows"):
            setattr(self, f, getattr(fresh, f))
        self.delta_log = []
        for e in log:
            rep = self.apply_delta(insert_rows=e["insert_rows"],
                                   insert_attrs=e["insert_attrs"],
                                   delete_ids=e["delete_ids"], _log=False)
            if rep.rebuilt or (e["insert_ids"] and list(range(
                    self.next_id - len(e["insert_ids"]), self.next_id))
                    != e["insert_ids"]):
                raise RuntimeError("the rebuilt geometry does not replay "
                                   "the delta log onto its ids")
        self.delta_log = log
        self.generation += 1

    # -- persistence ---------------------------------------------------------
    def save(self, path: str) -> None:
        """Atomic checkpoint of the resident state: ``session.npz`` and
        ``session.json``, the JAX package's layout."""
        os.makedirs(path, exist_ok=True)
        tmp = os.path.join(path, ".session.tmp.npz")   # np.savez wants .npz
        np.savez(tmp, blocks=self.blocks, attrs=self.attrs,
                 valid=self.valid, item_ids=self.item_ids,
                 versions=self.versions)
        os.replace(tmp, os.path.join(path, "session.npz"))
        meta = {k: getattr(self, k) for k in _META}
        tmpj = os.path.join(path, ".session.json.tmp")
        with open(tmpj, "w") as f:
            json.dump(meta, f)
        os.replace(tmpj, os.path.join(path, "session.json"))

    @classmethod
    def load(cls, path: str) -> "SessionState":
        """A frozen session (no source: :meth:`rebuild` raises) from the
        files :meth:`save` or the JAX package's ``save`` wrote."""
        with open(os.path.join(path, "session.json")) as f:
            meta = json.load(f)
        with np.load(os.path.join(path, "session.npz")) as z:
            arrays = {k: z[k] for k in ("blocks", "attrs", "valid",
                                        "item_ids", "versions")}
        st = cls(**arrays, **{k: meta[k] for k in _META})
        st._index_slots()
        return st

    def _index_slots(self) -> None:
        ids = torch.from_numpy(self.item_ids.reshape(-1))
        live = torch.nonzero(ids >= 0).flatten()
        slot = torch.full((self.next_id,), -1, dtype=torch.int64)
        slot[ids[live]] = live
        self._slot = slot.numpy()


def _rows(x) -> torch.Tensor:
    """A gathered host matrix as an fp32 tensor (sharing its memory where
    it is a writable fp32 array)."""
    x = np.asarray(x, np.float32)
    return torch.from_numpy(x if x.flags.writeable else x.copy())


def ingest(source, cfg: TreeConfig, *, attrs: np.ndarray | None = None,
           plan=None, fault_injector=None, wave_schedule=None,
           _L: int | None = None) -> SessionState:
    """Stream a ground set into a resident session through the wave engine.

    Round 0 of the tree without the solve: the plan's round-0 slots
    (``cfg.permutation``; ``plan`` defaults to ``TorchPlan(cfg.seed)``), the
    wave planner (fixed width, ``cfg.capacity_bytes``, autotuned, or a
    ``wave_schedule``), the sync or pipelined scheduler, ingestion hosts and
    fault supervision (waves dropped past the retry budget leave their
    machines empty and count in ``dropped_rows``).  Each wave's rows land in
    the session's host arrays, so every engine, width and host count gives
    the same resident state.  Nothing runs on the card.

    ``source`` is a :class:`GroundSetSource` or an ``(n, d)`` array;
    ``attrs`` overrides the source's attribute channel (``(n, a)`` fp32);
    ``_L`` is the rebuild's geometry.
    """
    source = as_source(source)
    plan = TorchPlan(cfg.seed) if plan is None else plan
    n, d, mu = source.n, source.d, cfg.capacity
    attrs_np = None if attrs is None else np.asarray(attrs, np.float32)
    a = attrs_np.shape[1] if attrs_np is not None else source.a
    feat_dtype = np.dtype(source.dtype)
    narrow = feat_dtype != np.dtype(np.float32)
    qcols = source.qcols if narrow else 0
    itemsize = dtype_itemsize(feat_dtype) if narrow else 4
    meta_cols = a + qcols if narrow else 0
    blk_width = d if narrow else d + a

    L = _L if _L is not None else n_parts(n, mu)
    Mp = L                                  # one device: no mesh padding
    slot_block = _round0_slot_blocks(plan, n, L, mu, cfg.permutation)
    W = _wave_size(cfg, None, Mp, mu, blk_width, itemsize, meta_cols)
    planner, _ladder = _wave_planner(cfg, W, Mp, mu, blk_width, None,
                                     wave_schedule, itemsize, meta_cols)
    tracer = cfg.telemetry
    if tracer is not None and isinstance(planner, AutotunePlanner):
        planner.tracer = tracer
    ecfg = EngineConfig(mode=cfg.engine, max_in_flight=cfg.max_in_flight,
                        hosts=cfg.hosts)
    if cfg.prefetch_depth is not None:
        source.prefetch_depth = cfg.prefetch_depth
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
        if w0 >= Mp:
            return None
        w1 = state["w0"] = w0 + min(planner.next_width(Mp - w0), Mp - w0)
        return w0, w1

    def gather_rows(idx_flat, wave, fault_hook=None):
        hp = state["hosts"]
        if hp is not None:
            rows, src_attrs, per_host = hp.gather(
                idx_flat, with_attrs=bool(a) and attrs_np is None,
                parallel=ecfg.mode == "pipelined", fault_hook=fault_hook,
                tracer=tracer, wave=wave)
            if a and attrs_np is not None:
                src_attrs = take_rows(attrs_np, idx_flat)
            return rows, src_attrs, per_host
        if not a:
            return source.gather(idx_flat), None, None
        if attrs_np is not None:
            return source.gather(idx_flat), take_rows(attrs_np, idx_flat), None
        rows, row_attrs = source.gather_with_attrs(idx_flat)
        return rows, row_attrs, None

    def gather(i: int) -> HostWave | None:
        span = next_span()
        if span is None:
            return None
        w0, w1 = span
        idx_w = slot_block(w0, w1)                          # (W, mu)
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
            if dropped:             # the machines stay empty
                return HostWave((None, None, idx_w, w0, w1), w1 - w0,
                                (w1 - w0) * mu, 0)
            rows, row_attrs, per_host = got
        wire = np.asarray(rows).nbytes + (
            np.asarray(row_attrs).nbytes if row_attrs is not None else 0)
        if narrow:
            qmeta = source.gather_qmeta(idx_flat) if qcols else None
            wire += qmeta.nbytes if qmeta is not None else 0
            rows = QuantizedSource.dequantize(np.asarray(rows), qmeta)
        return HostWave((rows, row_attrs, idx_w, w0, w1), w1 - w0,
                        (w1 - w0) * mu, wire, per_host)

    blocks = np.zeros((Mp, mu, d), np.float32)
    attr_blk = np.zeros((Mp, mu, a), np.float32)
    vmask = np.zeros((Mp, mu), bool)
    ids = np.full((Mp, mu), -1, np.int64)
    dropped_rows = [0]

    def store(i: int, payload) -> None:
        rows, row_attrs, idx_w, w0, w1 = payload
        valid = idx_w >= 0
        if rows is None:            # a forfeited wave
            dropped_rows[0] += int(valid.sum())
            return
        keep = torch.from_numpy(valid)[..., None]
        for dst, src, c in ((blocks, rows, d), (attr_blk, row_attrs, a)):
            if c:   # rows of empty slots zeroed, written where they live
                torch.where(keep, _rows(src).reshape(w1 - w0, mu, c),
                            torch.zeros((), dtype=torch.float32),
                            out=torch.from_numpy(dst[w0:w1]))
        vmask[w0:w1] = valid
        ids[w0:w1] = np.where(valid, idx_w, -1)

    estats = run_waves(gather, lambda payload: payload, store, ecfg,
                       torch.device("cpu"), on_trace=planner.observe,
                       tracer=tracer)
    if supervisor is not None:
        estats.fault_stats = supervisor.stats
    if state["w0"] != Mp:
        raise RuntimeError(f"ingest stored {state['w0']} of {Mp} machines")

    traces = estats.traces
    peak_rows = max(t.rows for t in traces)
    stats = IngestStats(
        wave_machines=W, waves=estats.waves, peak_wave_rows=peak_rows,
        peak_wave_bytes=peak_rows * (blk_width * itemsize + meta_cols * 4),
        total_machines=Mp, attr_dim=a,
        wave_seconds=[t.gather_s + t.h2d_s + t.solve_s for t in traces],
        wave_bytes=[t.bytes_moved for t in traces],
        total_bytes=estats.bytes_moved, wall_seconds=estats.wall_s,
        traces=traces)
    if (cfg.capacity_bytes is not None
            and stats.peak_wave_bytes > cfg.capacity_bytes):
        raise RuntimeError(f"a wave took {stats.peak_wave_bytes} bytes, over "
                           f"capacity_bytes={cfg.capacity_bytes}")

    st = SessionState(
        blocks=blocks, attrs=attr_blk, valid=vmask, item_ids=ids,
        versions=np.zeros((Mp,), np.int64), mu=mu, d=d, a=a, L=L, Mp=Mp,
        seed=cfg.seed, permutation=cfg.permutation, n_base=n, next_id=n,
        dropped_rows=dropped_rows[0], cfg=cfg, source=source, plan=plan,
        base_attrs=attrs_np, ingest_stats=stats, engine_stats=estats,
        fault_stats=getattr(estats, "fault_stats", None))
    st._index_slots()
    return st
