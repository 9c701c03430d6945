"""Ground-set sources — capacity-bounded access to the (n, d) item universe
(counterpart of ``repro.core.sources``).

The paper keeps the per-machine capacity μ fixed while n grows; a ground
set that must sit on the card whole is the failure mode it attributes to
GreeDi.  A :class:`GroundSetSource` says how a streaming round 0 reaches
item rows, so ``tree_maximize`` never holds the whole set on the card:

  * :class:`ArraySource` — an in-memory host array, random access;
  * :class:`ChunkedSource` — a host iterator that can only be re-streamed
    in chunks (file readers, generators); a gather re-streams the chunks
    and picks the requested rows out as they go by;
  * :class:`SlicedSource` — a contiguous window of a parent, with global
    indices (the view one ingestion host owns);
  * :class:`QuantizedSource` — a parent's rows stored narrow: fp32, bf16,
    or int8 with a per-block affine;
  * ``repro_torch.data.sources.ShardedSource`` — lazily loaded shards.

Every source has ``n``/``d``/``dtype``, ``iter_chunks()`` in index order
and ``gather(idx)`` (host int indices → ``(len(idx), d)`` rows, by
value).  Constrained runs add an ``(n, a)`` fp32 attribute matrix served
by ``gather_attrs`` for the same indices; int8 sources serve their dequant
parameters out of band by ``gather_qmeta`` (``qcols`` columns).

Sources stay on the host, in NumPy.  NumPy has no bfloat16 without
``ml_dtypes``, so bf16 rows are held as their 16-bit patterns
(:data:`BF16`, uint16): the cast is torch's fp32 → bf16 (round to nearest
even, the bits ``ml_dtypes`` gives), and :func:`bf16_to_fp32` is the exact
upcast.  The ingestion hosts of :mod:`repro_torch.engine.planner` split a
source at ``host_split_points`` into ``slice`` views; a view marked lost
raises :class:`HostLostError`.  ``fingerprint`` is the autotuner's cache
key, letter for letter the JAX package's for the same source.
"""
from __future__ import annotations

import queue
import threading
from typing import Callable, Iterator, Tuple

import numpy as np
import torch

#: canonical storage dtypes of bytes-lean ingestion
STORAGE_DTYPES = ("fp32", "bf16", "int8")
#: bf16 rows on the host: their bit patterns
BF16 = np.dtype(np.uint16)
_STORAGE_NP = {"fp32": np.dtype(np.float32), "bf16": BF16,
               "int8": np.dtype(np.int8)}
_ITEMSIZE_ALIAS = {"fp32": 4, "bf16": 2, "bfloat16": 2, "int8": 1}


def dtype_itemsize(dtype) -> int:
    """Bytes per element of a storage dtype: the names ``fp32``/``bf16``/
    ``int8`` (and ``bfloat16``), a ``torch.dtype``, or anything
    ``np.dtype`` takes (:data:`BF16` counts 2)."""
    if isinstance(dtype, str) and dtype in _ITEMSIZE_ALIAS:
        return _ITEMSIZE_ALIAS[dtype]
    if isinstance(dtype, torch.dtype):
        return dtype.itemsize
    return int(np.dtype(dtype).itemsize)


def storage_np_dtype(name: str) -> np.dtype:
    """The host dtype of a canonical storage-dtype name."""
    if name not in _STORAGE_NP:
        raise ValueError(f"storage dtype {name!r} not in {STORAGE_DTYPES}")
    return _STORAGE_NP[name]


def fp32_to_bf16(x: np.ndarray) -> np.ndarray:
    """fp32 → bf16 bit patterns (uint16), round to nearest even."""
    t = torch.from_numpy(np.ascontiguousarray(x, np.float32))
    return t.to(torch.bfloat16).view(torch.int16).numpy().view(BF16)


def bf16_to_fp32(bits: np.ndarray) -> np.ndarray:
    """bf16 bit patterns → fp32, exact."""
    return (np.asarray(bits, BF16).astype(np.uint32) << 16).view(np.float32)


def take_rows(data: np.ndarray, idx: np.ndarray) -> np.ndarray:
    """``data[idx]`` for int64 ``idx``: the same bytes, copied by torch's
    ``index_select``, which runs on every host core (NumPy's fancy index
    runs on one, and a round-0 wave reads millions of scattered rows)."""
    bf16 = data.dtype == BF16
    if not (bf16 or data.dtype in (np.float32, np.int8)):
        return data[idx]
    t = torch.from_numpy(data.view(np.int16) if bf16 else data)
    out = t.index_select(0, torch.from_numpy(idx)).numpy()
    return out.view(BF16) if bf16 else out


def host_rows(x) -> np.ndarray:
    """Rows as a host NumPy array: a torch tensor comes to the host (bf16
    as its bit patterns), anything else through ``np.asarray``."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(BF16)
        return x.numpy()
    return np.asarray(x)


class HostLostError(RuntimeError):
    """An ingestion host (its :class:`SlicedSource` view) is gone for good.

    Unlike a transient error, retrying the same host is pointless: the
    fault supervisor evicts it (``IngestionPlan.evict`` re-routes its range
    to the survivors) and retries against them.
    """

    def __init__(self, host: int, msg: str = ""):
        super().__init__(msg or f"ingestion host {host} lost")
        self.host = int(host)


class GroundSetSource:
    """Abstract capacity-bounded view of the ground set V (n items, d dims)."""

    n: int
    d: int
    a: int = 0              # per-item attribute width (0: no attrs)
    # dequant parameter width served by gather_qmeta (int8: scale, zp)
    qcols: int = 0
    dtype: np.dtype
    # chunk-prefetch depth of the default re-stream gathers (the next
    # chunk's read overlaps this chunk's row picking); order and content
    # do not depend on it.  ``tree_maximize`` sets it from
    # TreeConfig.prefetch_depth.
    prefetch_depth: int = 2
    # may gather() run on several threads at once?  The sources here keep
    # no state between calls; one over a shared non-reentrant reader says
    # False, and the ingestion hosts then gather one after another
    supports_concurrent_gather: bool = True

    def iter_chunks(self, chunk_rows: int = 8192
                    ) -> Iterator[Tuple[int, np.ndarray]]:
        """Yield ``(start, rows)`` covering items [0, n) in index order;
        ``chunk_rows`` is advisory."""
        raise NotImplementedError

    def iter_chunks_attrs(self, chunk_rows: int = 8192
                          ) -> Iterator[Tuple[int, np.ndarray, np.ndarray]]:
        """Yield ``(start, rows, attrs)``, attrs ``(len(rows), a)``."""
        for start, rows in self.iter_chunks(chunk_rows):
            yield start, rows, self._attr_slice(start, len(rows))

    def _attr_slice(self, start: int, count: int) -> np.ndarray:
        return np.zeros((count, self.a), np.float32)

    def gather(self, idx: np.ndarray) -> np.ndarray:
        """Rows for host int indices ``idx`` (flat order): re-streams the
        chunks through :func:`prefetch_chunks` and picks the rows."""
        idx = np.asarray(idx, np.int64).reshape(-1)
        out = np.zeros((idx.size, self.d), self.dtype)
        for start, rows in prefetch_chunks(self, depth=self.prefetch_depth):
            hit = (idx >= start) & (idx < start + len(rows))
            if hit.any():
                out[hit] = rows[idx[hit] - start]
        return out

    def gather_attrs(self, idx: np.ndarray) -> np.ndarray:
        """Attribute rows for ``idx`` — ``(len(idx), a)`` fp32."""
        return self.gather_with_attrs(idx)[1]

    def gather_with_attrs(self, idx: np.ndarray
                          ) -> Tuple[np.ndarray, np.ndarray]:
        """Rows and attribute rows for ``idx`` in one pass of the chunks."""
        idx = np.asarray(idx, np.int64).reshape(-1)
        rows = np.zeros((idx.size, self.d), self.dtype)
        attrs = np.zeros((idx.size, self.a), np.float32)
        for start, chunk_rows, chunk_attrs in prefetch_chunks(
                self, depth=self.prefetch_depth, with_attrs=True):
            hit = (idx >= start) & (idx < start + len(chunk_rows))
            if hit.any():
                rows[hit] = chunk_rows[idx[hit] - start]
                attrs[hit] = chunk_attrs[idx[hit] - start]
        return rows, attrs

    def gather_qmeta(self, idx: np.ndarray) -> np.ndarray:
        """Dequant parameters for ``idx`` — ``(len(idx), qcols)`` fp32
        (zero columns here)."""
        idx = np.asarray(idx, np.int64).reshape(-1)
        return np.zeros((idx.size, self.qcols), np.float32)

    def fingerprint(self) -> str:
        """Stable identity of the source for the autotuner's cache key:
        class name, shape and dtype (a wrapper appends its transform, so
        the bf16 and fp32 views of one ground set never share an entry).
        bf16 bit patterns (:data:`BF16`) are named ``bfloat16``, as the
        JAX package names them, so a cache file serves both packages."""
        name = ("bfloat16" if np.dtype(self.dtype) == BF16
                else np.dtype(self.dtype).name)
        return f"{type(self).__name__}:{self.n}x{self.d}:{name}"

    def materialize(self) -> np.ndarray:
        """The full (n, d) host array — tests and small references only."""
        return np.concatenate([rows for _, rows in self.iter_chunks()], axis=0)

    def materialize_attrs(self) -> np.ndarray:
        """The full (n, a) host attribute matrix — tests only."""
        return np.concatenate([a for _, _, a in self.iter_chunks_attrs()],
                              axis=0)

    def host_split_points(self, hosts: int) -> list[int]:
        """``hosts + 1`` bounds from 0 to n of contiguous host-owned
        ranges, near-equal (shard-backed sources align them to their
        shards, so each lazy shard belongs to one host)."""
        if not 1 <= hosts <= self.n:
            raise ValueError(f"hosts={hosts} outside [1, n={self.n}]")
        return [round(p * self.n / hosts) for p in range(hosts + 1)]

    def slice(self, lo: int, hi: int) -> "SlicedSource":
        """A host-local view of items ``[lo, hi)``, globally indexed."""
        return SlicedSource(self, lo, hi)


def _as_attrs(attrs) -> np.ndarray:
    attrs = np.asarray(attrs, np.float32)
    if attrs.ndim != 2:
        raise ValueError(f"attrs must be (n, a), got {attrs.shape}")
    return attrs


class ArraySource(GroundSetSource):
    """An in-memory (n, d) host array (a torch tensor comes to the host)."""

    def __init__(self, data, attrs=None):
        self._data = host_rows(data)
        self.n, self.d = int(self._data.shape[0]), int(self._data.shape[1])
        self.dtype = self._data.dtype
        self._attrs = None if attrs is None else _as_attrs(attrs)
        self.a = 0 if self._attrs is None else self._attrs.shape[1]
        if self._attrs is not None and len(self._attrs) != self.n:
            raise ValueError(f"attrs hold {len(self._attrs)} rows, n={self.n}")

    def iter_chunks(self, chunk_rows: int = 8192):
        for s in range(0, self.n, chunk_rows):
            yield s, self._data[s:s + chunk_rows]

    def _attr_slice(self, start: int, count: int) -> np.ndarray:
        if self._attrs is None:
            return np.zeros((count, 0), np.float32)
        return self._attrs[start:start + count]

    def gather(self, idx: np.ndarray) -> np.ndarray:
        return take_rows(self._data, np.asarray(idx, np.int64).reshape(-1))

    def gather_attrs(self, idx: np.ndarray) -> np.ndarray:
        idx = np.asarray(idx, np.int64).reshape(-1)
        if self._attrs is None:
            return np.zeros((idx.size, 0), np.float32)
        return self._attrs[idx]

    def gather_with_attrs(self, idx):
        return self.gather(idx), self.gather_attrs(idx)


class ChunkedSource(GroundSetSource):
    """A sequential host iterator (no random access).

    ``chunks_fn`` returns a *fresh* iterator each call: the stream is read
    once per gather and never held whole.  Chunks are ``rows`` arrays or
    ``(rows, attrs)`` pairs (declare the attribute width ``a``).
    """

    def __init__(self, chunks_fn: Callable[[], Iterator], n: int, d: int,
                 dtype=np.float32, a: int = 0):
        self._chunks_fn = chunks_fn
        self.n, self.d, self.a = int(n), int(d), int(a)
        self.dtype = np.dtype(dtype)

    @classmethod
    def from_array(cls, data, chunk_rows: int, attrs=None) -> "ChunkedSource":
        """An array that pretends to be only chunk-streamable."""
        arr = host_rows(data)
        att = None if attrs is None else _as_attrs(attrs)

        def chunks():
            for s in range(0, len(arr), chunk_rows):
                if att is None:
                    yield arr[s:s + chunk_rows]
                else:
                    yield arr[s:s + chunk_rows], att[s:s + chunk_rows]

        return cls(chunks, arr.shape[0], arr.shape[1], arr.dtype,
                   a=0 if att is None else att.shape[1])

    def _split(self, chunk):
        if isinstance(chunk, tuple):
            rows, attrs = chunk
            return host_rows(rows), np.asarray(attrs, np.float32)
        rows = host_rows(chunk)
        return rows, np.zeros((len(rows), self.a), np.float32)

    def iter_chunks(self, chunk_rows: int = 8192):
        for start, rows, _ in self.iter_chunks_attrs(chunk_rows):
            yield start, rows

    def iter_chunks_attrs(self, chunk_rows: int = 8192):
        start = 0
        for chunk in self._chunks_fn():
            rows, attrs = self._split(chunk)
            if attrs.shape != (len(rows), self.a):
                raise ValueError(f"chunk attrs {attrs.shape}, a={self.a}")
            yield start, rows, attrs
            start += len(rows)
        if start != self.n:
            raise ValueError(f"chunk stream yielded {start} rows, n={self.n}")


class SlicedSource(GroundSetSource):
    """A contiguous ``[lo, hi)`` window of a parent source: the local shard
    one ingestion host owns.  Indices stay global, and a gather refuses
    any index outside the window (the locality a multi-host deployment
    relies on).  Gathers delegate to the parent; a view marked lost
    raises :class:`HostLostError` on every gather."""

    def __init__(self, parent: GroundSetSource, lo: int, hi: int):
        if not 0 <= lo < hi <= parent.n:
            raise ValueError(f"window [{lo}, {hi}) outside [0, {parent.n})")
        self._parent = parent
        self.lo, self.hi = int(lo), int(hi)
        self.n = parent.n                 # global addressing
        self.d, self.a, self.qcols = parent.d, parent.a, parent.qcols
        self.dtype = parent.dtype
        self.supports_concurrent_gather = parent.supports_concurrent_gather
        self._lost: int | None = None     # host id once marked lost

    @property
    def local_n(self) -> int:
        return self.hi - self.lo

    def mark_lost(self, host: int) -> None:
        """Declare the host behind this view dead: every later gather
        raises :class:`HostLostError` (a machine that stopped answering
        and stays stopped across retries)."""
        self._lost = int(host)

    def _check_local(self, idx: np.ndarray) -> np.ndarray:
        if self._lost is not None:
            raise HostLostError(self._lost)
        idx = np.asarray(idx, np.int64).reshape(-1)
        if idx.size and (idx.min() < self.lo or idx.max() >= self.hi):
            raise ValueError(f"non-local gather: the view holds [{self.lo}, "
                             f"{self.hi}), got [{idx.min()}, {idx.max()}]")
        return idx

    def iter_chunks(self, chunk_rows: int = 8192):
        for start, rows, _ in self.iter_chunks_attrs(chunk_rows):
            yield start, rows

    def iter_chunks_attrs(self, chunk_rows: int = 8192):
        for start, rows, attrs in self._parent.iter_chunks_attrs(chunk_rows):
            s, e = max(start, self.lo), min(start + len(rows), self.hi)
            if s < e:
                yield s, rows[s - start:e - start], attrs[s - start:e - start]

    def gather(self, idx: np.ndarray) -> np.ndarray:
        return self._parent.gather(self._check_local(idx))

    def gather_attrs(self, idx: np.ndarray) -> np.ndarray:
        return self._parent.gather_attrs(self._check_local(idx))

    def gather_with_attrs(self, idx: np.ndarray):
        return self._parent.gather_with_attrs(self._check_local(idx))

    def gather_qmeta(self, idx: np.ndarray) -> np.ndarray:
        return self._parent.gather_qmeta(self._check_local(idx))


class QuantizedSource(GroundSetSource):
    """Bytes-lean view of a parent source: rows stored and shipped narrow.

    ``store_dtype``:

      * ``fp32`` — passthrough (one code path covers all three);
      * ``bf16`` — round to nearest even, 2 bytes an element, no
        parameters (host rows are the bit patterns, :data:`BF16`);
      * ``int8`` — a per-block affine on a fixed grid of ``q_block_rows``
        global indices: block b holds ``q = clip(rint((x − zp_b) /
        scale_b), −127, 127)`` with ``zp_b = (lo_b + hi_b)/2`` and
        ``scale_b`` = ``(hi_b − lo_b)/254`` rounded up to a power of two
        (1 for a constant block), from one pass over the parent at
        construction.  Rows carry ``(scale, zp)`` out of band
        (:meth:`gather_qmeta`, ``qcols = 2``).  With a power-of-two scale
        ``q · scale`` is exact, so an FMA and the two-rounding
        ``q * scale + zp`` agree.

    Parameters are a function of the global index only, so any access
    order quantizes a row to the same bytes: streamed and resident views
    agree.  Attributes pass through untouched.  :meth:`gather_fp32`
    re-reads the parent at fp32 for the exact re-check.
    """

    def __init__(self, parent: GroundSetSource, store_dtype: str = "bf16",
                 q_block_rows: int = 4096):
        self.dtype = storage_np_dtype(store_dtype)
        if q_block_rows < 1:
            raise ValueError(f"q_block_rows={q_block_rows} < 1")
        self._parent = parent
        self.store_dtype = store_dtype
        self.q_block_rows = int(q_block_rows)
        self.n, self.d, self.a = parent.n, parent.d, parent.a
        self.supports_concurrent_gather = parent.supports_concurrent_gather
        self.qcols = 2 if store_dtype == "int8" else 0
        self._scale = self._zp = None
        if store_dtype == "int8":
            self._fit_block_params()

    def _fit_block_params(self) -> None:
        """One pass over the parent: each block's [lo, hi] range."""
        B = self.q_block_rows
        nblocks = (self.n + B - 1) // B
        lo = np.full((nblocks,), np.inf, np.float32)
        hi = np.full((nblocks,), -np.inf, np.float32)
        for start, rows in self._parent.iter_chunks():
            rows = np.asarray(rows, np.float32)
            pos = start
            while pos < start + len(rows):
                b = pos // B
                end = min((b + 1) * B, start + len(rows))
                seg = rows[pos - start:end - start]
                lo[b] = min(lo[b], float(seg.min()))
                hi[b] = max(hi[b], float(seg.max()))
                pos = end
        # a constant block: zp is every value, q = 0
        span = np.maximum(hi - lo, 0.0)
        raw = np.where(span > 0, span / 254.0, 1.0)
        self._scale = np.exp2(np.ceil(np.log2(raw))).astype(np.float32)
        self._zp = ((lo + hi) * 0.5).astype(np.float32)

    def _params_for(self, idx: np.ndarray):
        b = np.asarray(idx, np.int64).reshape(-1) // self.q_block_rows
        return self._scale[b], self._zp[b]

    def _narrow(self, rows: np.ndarray, idx: np.ndarray) -> np.ndarray:
        rows = np.asarray(rows, np.float32)
        if self.store_dtype == "fp32":
            return rows
        if self.store_dtype == "bf16":
            return fp32_to_bf16(rows)
        scale, zp = self._params_for(idx)
        # rint((x − zp) / scale) clipped to ±127, on every host core: torch's
        # fp32 subtract and divide round as NumPy's, round() is to even
        q = torch.round((torch.from_numpy(np.ascontiguousarray(rows))
                         - torch.from_numpy(zp)[:, None])
                        / torch.from_numpy(scale)[:, None])
        return q.clamp_(-127, 127).to(torch.int8).numpy()

    @staticmethod
    def dequantize(rows: np.ndarray, qmeta: np.ndarray | None) -> np.ndarray:
        """Host-side inverse of the wire format → fp32 rows: bf16 patterns
        by the exact upcast, int8 by ``q * scale + zp`` per row (fp32, two
        roundings, the kernels' dequant) with ``qmeta`` its
        :meth:`gather_qmeta` slice."""
        rows = np.asarray(rows)
        if rows.dtype == BF16:
            return bf16_to_fp32(rows)
        if qmeta is None or qmeta.shape[-1] == 0:
            return rows.astype(np.float32)
        q = rows.astype(np.float32)
        return q * qmeta[..., 0:1].astype(np.float32) \
            + qmeta[..., 1:2].astype(np.float32)

    def host_split_points(self, hosts: int) -> list[int]:
        return self._parent.host_split_points(hosts)

    def fingerprint(self) -> str:
        return (f"{self._parent.fingerprint()}|q={self.store_dtype}"
                f":B={self.q_block_rows}")

    def iter_chunks(self, chunk_rows: int = 8192):
        for start, rows in self._parent.iter_chunks(chunk_rows):
            idx = np.arange(start, start + len(rows), dtype=np.int64)
            yield start, self._narrow(rows, idx)

    def iter_chunks_attrs(self, chunk_rows: int = 8192):
        for start, rows, attrs in self._parent.iter_chunks_attrs(chunk_rows):
            idx = np.arange(start, start + len(rows), dtype=np.int64)
            yield start, self._narrow(rows, idx), attrs

    def gather(self, idx: np.ndarray) -> np.ndarray:
        idx = np.asarray(idx, np.int64).reshape(-1)
        return self._narrow(self._parent.gather(idx), idx)

    def gather_attrs(self, idx: np.ndarray) -> np.ndarray:
        return self._parent.gather_attrs(idx)

    def gather_with_attrs(self, idx: np.ndarray):
        idx = np.asarray(idx, np.int64).reshape(-1)
        rows, attrs = self._parent.gather_with_attrs(idx)
        return self._narrow(rows, idx), attrs

    def gather_qmeta(self, idx: np.ndarray) -> np.ndarray:
        idx = np.asarray(idx, np.int64).reshape(-1)
        if self.qcols == 0:
            return np.zeros((idx.size, 0), np.float32)
        scale, zp = self._params_for(idx)
        return np.stack([scale, zp], axis=1).astype(np.float32)

    def gather_fp32(self, idx: np.ndarray) -> np.ndarray:
        """Parent rows at full precision — the exact re-check path."""
        return np.asarray(self._parent.gather(idx), np.float32)

    def dequantized(self) -> np.ndarray:
        """The full (n, d) fp32 array the *solve* sees after dequant — the
        resident reference of the streaming runs."""
        out = np.zeros((self.n, self.d), np.float32)
        for start, rows in self.iter_chunks(1 << 20):
            idx = np.arange(start, start + len(rows), dtype=np.int64)
            out[start:start + len(rows)] = self.dequantize(
                rows, self.gather_qmeta(idx))
        return out


def prefetch_chunks(source: GroundSetSource, chunk_rows: int = 8192, *,
                    depth: int = 2, with_attrs: bool = False) -> Iterator:
    """Chunk iteration with a background reader: yields what
    ``iter_chunks`` (``iter_chunks_attrs``) would, in the same order,
    while a daemon thread reads up to ``depth`` chunks ahead.  The reader's
    exceptions re-raise here; abandoning the generator stops the reader."""
    if depth < 1:
        raise ValueError(f"depth={depth} < 1")
    q: queue.Queue = queue.Queue(maxsize=depth)
    done = object()
    abandoned = threading.Event()

    def put(item) -> bool:
        while not abandoned.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def produce():
        try:
            it = (source.iter_chunks_attrs(chunk_rows) if with_attrs
                  else source.iter_chunks(chunk_rows))
            for item in it:
                if not put(item):
                    return
            put(done)
        except BaseException as exc:   # surfaced on the consumer's thread
            put(exc)

    threading.Thread(target=produce, daemon=True,
                     name="chunk-prefetch").start()
    try:
        while True:
            item = q.get()
            if item is done:
                return
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        abandoned.set()


def as_source(data, attrs=None) -> GroundSetSource:
    """An (n, d) array as an :class:`ArraySource`; sources pass through."""
    if isinstance(data, GroundSetSource):
        if attrs is not None:
            raise ValueError("pass attrs through the source, not beside it")
        return data
    return ArraySource(data, attrs=attrs)
