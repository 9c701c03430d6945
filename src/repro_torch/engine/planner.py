"""Ingestion hosts: round 0's gather sharded over hosts (counterpart of
``repro.engine.planner``).

Every wave's (machine, slot) → item assignment is a function of the round
plan alone, so the gather can shard over processes with nothing shared but
the plan: host p owns a contiguous item range [lo_p, hi_p) of the ground
set and serves exactly the wave slots whose items fall in it.

  * :meth:`IngestionPlan.build` splits the ground set into per-host
    :class:`HostShard` views, aligned to the source's shard boundaries
    where it has them (no lazy shard is split between hosts);
  * :meth:`IngestionPlan.gather` routes a wave's item indices to their
    owners, gathers each host's share from its local view, and stitches
    the rows back in index order: the same bytes as one gather of the
    whole wave.

One process emulates every host here: each shard's ``SlicedSource`` still
refuses indices it does not own, so the locality a multi-process
deployment depends on is checked, and ``parallel`` runs the hosts' gathers
on threads, as hosts would read their shards at once.
"""
from __future__ import annotations

import dataclasses
import time
from concurrent.futures import ThreadPoolExecutor
from typing import TYPE_CHECKING, Callable

import numpy as np
import torch

if TYPE_CHECKING:   # a runtime import would cycle: core.tree imports engine
    from repro_torch.core.sources import GroundSetSource


@dataclasses.dataclass
class HostShard:
    """One ingestion host's slice of the ground set."""
    host: int                   # stable host id (survives evictions)
    lo: int                     # first owned global item index
    hi: int                     # one past the last owned index
    source: "GroundSetSource"   # local view; refuses non-local indices


class IngestionPlan:
    """Routing table from global item indices to ingestion hosts."""

    def __init__(self, shards: list[HostShard],
                 parent: "GroundSetSource | None" = None):
        if not shards or shards[0].lo != 0:
            raise ValueError("host ranges must start at 0")
        for a, b in zip(shards, shards[1:]):
            if a.hi != b.lo:
                raise ValueError("host ranges must tile [0, n)")
        self.shards = shards
        self.parent = parent          # the unsliced source; evict() needs it
        self.n = shards[-1].hi
        self._los = np.asarray([s.lo for s in shards], np.int64)

    @property
    def hosts(self) -> int:
        return len(self.shards)

    @property
    def host_ids(self) -> list[int]:
        return [s.host for s in self.shards]

    @classmethod
    def build(cls, source: "GroundSetSource", hosts: int) -> "IngestionPlan":
        """``hosts`` near-equal contiguous shards of ``source``, split at
        :meth:`GroundSetSource.host_split_points`."""
        if not 1 <= hosts <= source.n:
            raise ValueError(f"hosts={hosts} outside [1, n={source.n}]")
        bounds = source.host_split_points(hosts)
        return cls([HostShard(host=p, lo=lo, hi=hi,
                              source=source.slice(lo, hi))
                    for p, (lo, hi) in enumerate(zip(bounds, bounds[1:]))],
                   parent=source)

    def evict(self, host: int) -> "IngestionPlan":
        """The plan without a lost host: its range goes to its neighbours
        (split at the midpoint between two; whole to an end host's single
        neighbour), each survivor with a fresh view of its wider range.
        Gathers stitch by global index, so a gather after the eviction
        gives the same rows as before it.  Host ids stay stable."""
        if self.parent is None:
            raise ValueError("plan built without its parent source")
        if self.hosts < 2:
            raise ValueError("cannot evict the only ingestion host")
        pos = [i for i, s in enumerate(self.shards) if s.host == host]
        if not pos:
            raise ValueError(f"host {host} not in the plan")
        i = pos[0]
        dead = self.shards[i]
        survivors = [dataclasses.replace(s) for s in self.shards
                     if s.host != host]
        if i == 0:
            survivors[0].lo = dead.lo
        elif i == len(self.shards) - 1:
            survivors[-1].hi = dead.hi
        else:
            mid = (dead.lo + dead.hi) // 2
            survivors[i - 1].hi = mid
            survivors[i].lo = mid
        return IngestionPlan([dataclasses.replace(
            s, source=self.parent.slice(s.lo, s.hi)) for s in survivors],
            parent=self.parent)

    def owner_of(self, idx: np.ndarray) -> np.ndarray:
        """Position in ``shards`` of each global index's owner."""
        return self._owner(torch.from_numpy(
            np.asarray(idx, np.int64))).numpy()

    def _owner(self, idx: torch.Tensor) -> torch.Tensor:
        return torch.searchsorted(torch.from_numpy(self._los), idx,
                                  right=True) - 1

    def gather(self, idx: np.ndarray, *, with_attrs: bool = False,
               parallel: bool = False,
               fault_hook: Callable[[HostShard], None] | None = None,
               tracer=None, wave: int | None = None,
               ) -> tuple[np.ndarray, np.ndarray | None, list[int]]:
        """Rows (and attribute rows) of global ``idx``, host by host.

        Returns ``(rows, attrs or None, per_host_rows)`` in the order of
        ``idx``, the same as one gather of ``idx`` from the unsharded
        source for any plan whose shards tile [0, n).  ``per_host_rows[p]``
        counts the rows ``shards[p]`` served.  ``parallel`` runs the hosts'
        gathers on a thread pool where every view allows concurrent
        gathers.  ``fault_hook(shard)`` is called on the pulling thread
        just before a host's gather, where a real deployment's request to
        that host would fail.

        ``tracer`` (a :class:`repro_torch.engine.telemetry.Tracer`) gets one
        ``host-gather`` span per host that served rows, on the named track
        ``host-<id>`` whichever pool thread served it, labelled with
        ``wave``.

        Each host finds its positions with torch's multi-threaded
        ``nonzero`` of its owner mask (in ``idx`` order), and its rows are
        stitched into place by one ``index_copy_``, as raw bytes.
        """
        idx = np.asarray(idx, np.int64).reshape(-1)
        idx_t = torch.from_numpy(idx)
        owner = self._owner(idx_t)
        first = self.shards[0].source
        rows = np.zeros((idx.size, first.d), first.dtype)
        attrs = (np.zeros((idx.size, first.a), np.float32) if with_attrs
                 else None)

        def pull(pos_shard):
            pos, shard = pos_shard
            sel = torch.nonzero(owner == pos).squeeze(1)
            if sel.numel() == 0:
                return sel, None, None
            if fault_hook is not None:
                fault_hook(shard)
            local = idx_t.index_select(0, sel).numpy()
            t0 = time.perf_counter() if tracer is not None else 0.0
            if with_attrs:
                r, a = shard.source.gather_with_attrs(local)
            else:
                r, a = shard.source.gather(local), None
            if tracer is not None:
                tracer.emit("host-gather", "host", t0, time.perf_counter(),
                            track=f"host-{shard.host}", host=shard.host,
                            rows=int(local.size),
                            **({} if wave is None else {"wave": wave}))
            return sel, r, a

        parallel = parallel and len(self.shards) > 1 and all(
            s.source.supports_concurrent_gather for s in self.shards)
        if parallel:
            with ThreadPoolExecutor(max_workers=len(self.shards)) as ex:
                results = list(ex.map(pull, enumerate(self.shards)))
        else:
            results = [pull(ps) for ps in enumerate(self.shards)]
        for sel, r, a in results:
            if r is not None:
                _stitch(rows, sel, r)
                if with_attrs:
                    _stitch(attrs, sel, a)
        return rows, attrs, [int(sel.numel()) for sel, _, _ in results]


def _stitch(out: np.ndarray, sel: torch.Tensor, part: np.ndarray) -> None:
    """``out[sel] = part`` row by row, as bytes (any dtype)."""
    part = np.ascontiguousarray(part, out.dtype).reshape(
        (len(sel),) + out.shape[1:])
    torch.from_numpy(out.view(np.uint8)).index_copy_(
        0, sel, torch.from_numpy(part.view(np.uint8)))
