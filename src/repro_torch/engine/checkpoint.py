"""Round-boundary checkpoints: file layout, resume lookup and the async
writer (counterpart of ``repro.engine.checkpoint``).

The tree's round loop snapshots ``A_t`` (rows, mask, best solution, its
value and the oracle calls so far) at every round boundary, so a run
restarts at any round.  The snapshot is taken on the caller thread (device → host
copies into fresh NumPy arrays); the serialize-and-write runs inline or on
the :class:`AsyncCheckpointWriter`'s thread, under the next round:

    round_t → snapshot ┐
                       ├ (background write of ckpt_t)
    round_{t+1} ───────┘            wall ≈ max(round_{t+1}, ckpt_t)

Layout, the JAX package's byte for byte so either package loads the
other's files: one ``tree_round_r{t:04d}.npz`` per boundary (``round``,
``rows``, ``mask``, ``best_rows``, ``best_mask``, ``best_val``, ``calls``,
or the ``delta_*`` keys in place of ``rows``), written to a tmp file and
renamed, plus the latest pointer ``tree_round.npz`` (hard link and
rename).  ``keep`` rotates to the newest rounds; a crash leaves only
``*.tmp*`` litter, which :func:`clean_stale_tmp` sweeps at the next start.
"""
from __future__ import annotations

import os
import re
import shutil
import threading
import time
from typing import Any, Callable

import numpy as np

from repro_torch.engine.stats import CheckpointStats, RoundCheckpoint

_LEGACY_NAME = "tree_round.npz"
_ROUND_RE = re.compile(r"tree_round_r(\d+)\.npz")


def round_checkpoint_path(d: str, round_idx: int) -> str:
    return os.path.join(d, f"tree_round_r{round_idx:04d}.npz")


def _encode_delta(prev_rows: np.ndarray, cur_rows: np.ndarray
                  ) -> dict[str, np.ndarray]:
    """Row-index delta of ``cur_rows`` against ``prev_rows``.

    ``A_{t+1}`` is a union of selected ``A_t`` rows, so nearly every
    current row is a byte copy of a previous one (masked slots are zero).
    One int a current row: a previous row's index (the lowest on ties),
    −1 for an all-zero row, −2 for a row stored verbatim in the ``extra``
    arrays.  Byte matching, so the rebuilt rows are the same bits.
    """
    prev = np.ascontiguousarray(prev_rows)
    cur = np.ascontiguousarray(cur_rows)
    lut: dict[bytes, int] = {}
    for i in range(len(prev)):
        lut.setdefault(prev[i].tobytes(), i)
    zero = np.zeros((cur.shape[1],), cur.dtype).tobytes()
    idx = np.full((len(cur),), -2, np.int64)
    extra: list[int] = []
    for i in range(len(cur)):
        b = cur[i].tobytes()
        j = lut.get(b)
        if j is not None:
            idx[i] = j
        elif b == zero:
            idx[i] = -1
        else:
            extra.append(i)
    ep = np.asarray(extra, np.int64)
    return {"delta_idx": idx,
            "delta_extra_pos": ep,
            "delta_extra_rows": cur[ep] if len(ep) else
            np.zeros((0, cur.shape[1]), cur.dtype),
            "delta_nrows": np.int64(cur.shape[0]),
            "delta_width": np.int64(cur.shape[1])}


def load_round_checkpoint(path: str) -> dict[str, np.ndarray]:
    """One round checkpoint as host arrays; a delta file loads its base
    round from the same directory (rotation keeps every ancestor down to a
    full snapshot) and rebuilds ``rows`` to the bit."""
    with np.load(path) as z:
        out = {k: z[k] for k in z.files}
    if "delta_base" not in out:
        return out
    base = int(out.pop("delta_base"))
    prev = load_round_checkpoint(
        round_checkpoint_path(os.path.dirname(path) or ".", base))
    prev_rows = np.asarray(prev["rows"])
    idx = np.asarray(out.pop("delta_idx"), np.int64)
    rows = np.zeros((int(out.pop("delta_nrows")), int(out.pop("delta_width"))),
                    prev_rows.dtype)
    hit = idx >= 0
    if hit.any():
        rows[hit] = prev_rows[idx[hit]]
    ep = np.asarray(out.pop("delta_extra_pos"), np.int64)
    extra = out.pop("delta_extra_rows")
    if len(ep):
        rows[ep] = extra
    out["rows"] = rows
    return out


def _chain_rounds(d: str, rounds: list[int]) -> set[int]:
    """``rounds`` and every delta ancestor down to a full snapshot."""
    need: set[int] = set()
    stack = list(rounds)
    while stack:
        r = stack.pop()
        if r in need:
            continue
        need.add(r)
        p = round_checkpoint_path(d, r)
        if os.path.exists(p):
            with np.load(p) as z:
                if "delta_base" in z.files:
                    stack.append(int(z["delta_base"]))
    return need


def write_round_checkpoint(d: str, round_idx: int, keep: int = 3,
                           delta_every: int = 0, **arrays: Any) -> str:
    """Write one round's snapshot atomically and rotate to the newest
    ``keep`` rounds (``keep ≤ 0`` keeps every round).

    ``delta_every`` > 0 stores ``rows`` as a delta against the previous
    round's file where it exists, with a full snapshot every
    ``delta_every`` rounds (and wherever the base is missing); rotation
    keeps each retained round's ancestors, so every kept round loads.
    """
    os.makedirs(d, exist_ok=True)
    path = round_checkpoint_path(d, round_idx)
    payload = dict(arrays)
    if (delta_every > 0 and round_idx % delta_every != 0
            and "rows" in payload):
        prev_path = round_checkpoint_path(d, round_idx - 1)
        if os.path.exists(prev_path):
            prev = load_round_checkpoint(prev_path)
            rows = np.asarray(payload.pop("rows"))
            payload.update(_encode_delta(np.asarray(prev["rows"]), rows),
                           delta_base=np.int64(round_idx - 1))
    tmp = path + ".tmp.npz"               # np.savez appends .npz otherwise
    np.savez(tmp, round=round_idx, **payload)
    os.replace(tmp, path)
    _refresh_latest(d, path)
    if keep > 0:
        existing = list_round_checkpoints(d)
        need = _chain_rounds(d, [r for r, _ in existing[-keep:]])
        for old_round, old_path in existing[:-keep]:
            if old_round != round_idx and old_round not in need:
                os.unlink(old_path)
    return path


def _refresh_latest(d: str, path: str) -> None:
    """Point ``tree_round.npz`` at ``path`` atomically."""
    tmp = os.path.join(d, _LEGACY_NAME + ".tmp")
    if os.path.exists(tmp):
        os.unlink(tmp)
    try:
        os.link(path, tmp)                # no data copy
    except OSError:                       # a filesystem without hard links
        shutil.copyfile(path, tmp)
    os.replace(tmp, os.path.join(d, _LEGACY_NAME))


def list_round_checkpoints(d: str) -> list[tuple[int, str]]:
    """Rotated round checkpoints as ``(round, path)``, oldest first."""
    if not os.path.isdir(d):
        return []
    return sorted((int(m.group(1)), os.path.join(d, f))
                  for f in os.listdir(d) if (m := _ROUND_RE.fullmatch(f)))


def latest_round_checkpoint(d: str) -> str | None:
    """The newest complete round checkpoint, else the latest pointer (a
    directory written before rotation holds only that), else None."""
    rounds = list_round_checkpoints(d)
    if rounds:
        return rounds[-1][1]
    legacy = os.path.join(d, _LEGACY_NAME)
    return legacy if os.path.exists(legacy) else None


def clean_stale_tmp(d: str) -> list[str]:
    """Remove the ``tree_round*.tmp*`` files a crashed writer left; every
    live checkpoint is a renamed ``.npz`` without ``.tmp`` in its name.
    Returns the removed paths."""
    removed: list[str] = []
    if not os.path.isdir(d):
        return removed
    for f in os.listdir(d):
        if ".tmp" in f and f.startswith("tree_round"):
            p = os.path.join(d, f)
            os.unlink(p)
            removed.append(p)
    return removed


class AsyncCheckpointWriter:
    """Round checkpoints written on a background thread, one at a time.

    ``submit`` first waits out the previous write (the only checkpoint
    time the round loop pays, recorded as that round's ``wait_s``), then
    hands the new snapshot, NumPy arrays the writer owns, to a fresh
    thread.  ``wait()`` is the barrier before the result and re-raises a
    write's error on the caller; ``abort()`` drains on an error path and
    keeps the caller's exception.  Either way no write is in flight when
    the run returns or raises.  ``tracer`` gets a ``ckpt-write`` span per
    write (on the writer thread's track) and a ``ckpt-wait`` span per
    barrier that waited on one (on the caller's).
    """

    def __init__(self, write_fn: Callable[..., None], tracer=None):
        self._write_fn = write_fn
        self._thread: threading.Thread | None = None
        self._pending_round: int | None = None
        self._exc: BaseException | None = None
        self._write_s: dict[int, float] = {}
        self._wait_s: dict[int, float] = {}
        self._order: list[int] = []
        self.tracer = tracer

    def _join_pending(self) -> None:
        if self._thread is None:
            return
        t0 = time.perf_counter()
        self._thread.join()
        t1 = time.perf_counter()
        self._thread = None
        if self._pending_round is not None:
            self._wait_s[self._pending_round] = t1 - t0
            if self.tracer is not None:
                self.tracer.emit("ckpt-wait", "ckpt", t0, t1,
                                 round=self._pending_round)
            self._pending_round = None

    def wait(self) -> None:
        """Block until no write is in flight; re-raise a write's error."""
        self._join_pending()
        if self._exc is not None:
            exc, self._exc = self._exc, None
            raise exc

    def abort(self) -> None:
        """Drain the write in flight and drop its error (the caller's own
        exception is the root cause)."""
        self._join_pending()
        self._exc = None

    def submit(self, round_idx: int, *args: Any, **kwargs: Any) -> None:
        """Write one round's host snapshot in the background, after the
        previous round's write has finished."""
        self.wait()

        def work():
            t0 = time.perf_counter()
            try:
                self._write_fn(*args, **kwargs)
            except BaseException as exc:  # re-raised at the next barrier
                self._exc = exc
            finally:
                t1 = time.perf_counter()
                self._write_s[round_idx] = t1 - t0
                if self.tracer is not None:
                    self.tracer.emit("ckpt-write", "ckpt", t0, t1,
                                     round=round_idx)

        self._pending_round = round_idx
        self._order.append(round_idx)
        self._thread = threading.Thread(
            target=work, name=f"ckpt-write-r{round_idx}", daemon=True)
        self._thread.start()

    def stats(self) -> CheckpointStats:
        """The per-round record (after the final barrier)."""
        if self._thread is not None:
            raise RuntimeError("stats() before the final barrier")
        return CheckpointStats(mode="async", rounds=[
            RoundCheckpoint(round=r, write_s=self._write_s.get(r, 0.0),
                            wait_s=self._wait_s.get(r, 0.0))
            for r in self._order])
