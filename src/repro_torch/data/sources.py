"""Sharded and pipeline-backed ground-set sources (counterpart of
``repro.data.sources``).

The candidate pool lives as shards reached through lazy loaders; a gather
calls only the loaders whose shard holds a requested row, so host memory
stays O(shard + request) while n is unbounded.
:func:`synthetic_sharded_source` (the same NumPy draws as the JAX package,
shard by shard) and :func:`lm_embedding_source` (pooled embeddings of the
port's synthetic LM batches) are deterministic instances.
"""
from __future__ import annotations

from typing import Callable, Sequence

import numpy as np
import torch

from repro_torch.core.sources import GroundSetSource, host_rows


class ShardedSource(GroundSetSource):
    """A ground set split into shards with per-shard lazy loaders.

    ``loaders[i]()`` returns shard i as a ``(shard_sizes[i], d)`` host
    array; nothing is loaded until a chunk iteration or a gather needs it.
    ``attr_loaders[i]()`` (optional) returns its ``(sizes[i], a)`` attribute
    rows, as lazily.
    """

    def __init__(self, loaders: Sequence[Callable[[], np.ndarray]],
                 shard_sizes: Sequence[int], d: int, dtype=np.float32,
                 attr_loaders: Sequence[Callable[[], np.ndarray]] | None = None,
                 a: int = 0):
        if len(loaders) != len(shard_sizes):
            raise ValueError("one size per loader")
        self._loaders = list(loaders)
        self._sizes = [int(s) for s in shard_sizes]
        self._starts = np.concatenate([[0], np.cumsum(self._sizes)]).astype(
            np.int64)
        self.n = int(self._starts[-1])
        self.d = int(d)
        self.dtype = np.dtype(dtype)
        self._attr_loaders = None if attr_loaders is None else list(
            attr_loaders)
        if self._attr_loaders is not None and (
                len(self._attr_loaders) != len(self._loaders) or a <= 0):
            raise ValueError("attr_loaders need one loader per shard and an "
                             "explicit attribute width a")
        self.a = int(a) if self._attr_loaders is not None else 0

    @classmethod
    def from_arrays(cls, arrays: Sequence[np.ndarray],
                    attrs: Sequence[np.ndarray] | None = None
                    ) -> "ShardedSource":
        arrays = [host_rows(x) for x in arrays]
        attr_loaders, a = None, 0
        if attrs is not None:
            attrs = [np.asarray(x, np.float32) for x in attrs]
            if [len(x) for x in attrs] != [len(x) for x in arrays]:
                raise ValueError("attribute shards do not match the rows")
            attr_loaders = [(lambda x=x: x) for x in attrs]
            a = attrs[0].shape[1]
        return cls([(lambda x=x: x) for x in arrays],
                   [len(x) for x in arrays], arrays[0].shape[1],
                   arrays[0].dtype, attr_loaders=attr_loaders, a=a)

    def host_split_points(self, hosts: int) -> list[int]:
        """Host bounds at shard boundaries (a lazy shard then belongs to
        one host): for each near-equal target the nearest interior shard
        start after the previous bound; the near-equal item split where
        there are fewer shards than hosts or the starts run out."""
        if hosts > len(self._sizes):
            return super().host_split_points(hosts)
        bounds = [0]
        for p in range(1, hosts):
            target = p * self.n / hosts
            cands = [int(s) for s in self._starts[1:-1] if s > bounds[-1]]
            if not cands:
                return super().host_split_points(hosts)
            bounds.append(min(cands, key=lambda s: abs(s - target)))
        return bounds + [self.n]

    def _shard(self, i: int) -> np.ndarray:
        rows = host_rows(self._loaders[i]())
        if len(rows) != self._sizes[i]:
            raise ValueError(f"shard {i}: {len(rows)} rows, {self._sizes[i]} "
                             "declared")
        return rows

    def _attr_shard(self, i: int) -> np.ndarray:
        if self._attr_loaders is None:
            return np.zeros((self._sizes[i], 0), np.float32)
        attrs = np.asarray(self._attr_loaders[i](), np.float32)
        if attrs.shape != (self._sizes[i], self.a):
            raise ValueError(f"attribute shard {i}: {attrs.shape}")
        return attrs

    def iter_chunks(self, chunk_rows: int = 8192):
        for i in range(len(self._loaders)):
            yield int(self._starts[i]), self._shard(i)

    def iter_chunks_attrs(self, chunk_rows: int = 8192):
        for i in range(len(self._loaders)):
            yield int(self._starts[i]), self._shard(i), self._attr_shard(i)

    def gather_with_attrs(self, idx: np.ndarray):
        """Rows and attribute rows, loading only the shards with hits."""
        idx = np.asarray(idx, np.int64).reshape(-1)
        rows = np.zeros((idx.size, self.d), self.dtype)
        attrs = np.zeros((idx.size, self.a), np.float32)
        shard_of = np.searchsorted(self._starts, idx, side="right") - 1
        for i in np.unique(shard_of):
            hit = shard_of == i
            local = idx[hit] - self._starts[i]
            rows[hit] = self._shard(i)[local]
            if self.a:
                attrs[hit] = self._attr_shard(i)[local]
        return rows, attrs

    def gather(self, idx: np.ndarray) -> np.ndarray:
        idx = np.asarray(idx, np.int64).reshape(-1)
        out = np.zeros((idx.size, self.d), self.dtype)
        shard_of = np.searchsorted(self._starts, idx, side="right") - 1
        for i in np.unique(shard_of):
            hit = shard_of == i
            out[hit] = self._shard(i)[idx[hit] - self._starts[i]]
        return out


def synthetic_sharded_source(n: int, d: int, shard_rows: int = 50_000,
                             seed: int = 0, n_clusters: int = 20,
                             spread: float = 0.3, attr_gen=None,
                             a: int = 0) -> ShardedSource:
    """A clustered point cloud generated shard by shard: shard i is a pure
    function of ``(seed, i)``, the JAX package's draws, so no host buffer
    ever holds all n rows.  ``attr_gen(rng, rows) → (rows, a)`` draws the
    attribute shard from the same per-shard stream after the rows."""
    centers = np.random.default_rng(seed).standard_normal(
        (n_clusters, d)).astype(np.float32)

    def make_loader(i: int, rows: int):
        def load():
            r = np.random.default_rng((seed, i))
            assign = r.integers(0, n_clusters, rows)
            return (centers[assign] + spread * r.standard_normal(
                (rows, d)).astype(np.float32))
        return load

    def make_attr_loader(i: int, rows: int):
        def load():
            r = np.random.default_rng((seed, i))
            r.integers(0, n_clusters, rows)             # skip the row stream
            r.standard_normal((rows, d))
            return np.asarray(attr_gen(r, rows), np.float32)
        return load

    sizes = [min(shard_rows, n - s) for s in range(0, n, shard_rows)]
    attr_loaders = None
    if attr_gen is not None:
        if a <= 0:
            raise ValueError("attr_gen needs an explicit attribute width a")
        attr_loaders = [make_attr_loader(i, sz) for i, sz in enumerate(sizes)]
    return ShardedSource([make_loader(i, sz) for i, sz in enumerate(sizes)],
                         sizes, d, attr_loaders=attr_loaders, a=a)


def lm_embedding_source(params, dcfg, n_batches: int,
                        embed_fn=None) -> ShardedSource:
    """Shard b = the pooled embeddings of the port's deterministic LM batch
    b (:class:`repro_torch.data.pipeline.SyntheticLM`, made where
    ``params["emb"]`` lives), so a selection runs over any number of
    batches without the whole feature matrix."""
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.data.selection import mean_pool_embeddings

    embed_fn = mean_pool_embeddings if embed_fn is None else embed_fn
    stream = SyntheticLM(dcfg, device=params["emb"].device)

    def make_loader(b: int):
        def load():
            pooled = embed_fn(params, stream.batch(b)["tokens"])
            return torch.as_tensor(pooled).float().cpu().numpy()
        return load

    return ShardedSource([make_loader(b) for b in range(n_batches)],
                         [dcfg.global_batch] * n_batches, dcfg.d_model)
