"""Request dispatcher: micro-batches concurrent selection requests
(counterpart of ``repro.serve.dispatcher``).

The service answers a *list* of requests with one entry per fuse key;
this module turns independent callers into such lists.
:class:`Dispatcher` runs one worker thread that drains its queue on every
wakeup: under load the drained slice is the micro-batch, so batching comes
from backpressure rather than from a timer (an idle server answers single
requests at once; a busy one spreads each replay over whatever queued).

Serving is deterministic per (fuse key, batch composition): a
``max_batch=1`` dispatcher equals direct single-request serving exactly.
Every launch, capture and replay of the service happens on the worker
thread; the service captures in thread-local mode on a side stream, so
callers on other threads may keep using the card.  The queue depth at each
drain goes to the service (``note_queue_depth``), so ``queue_depth_max``
and the ``serve`` metrics reflect real backpressure.
"""
from __future__ import annotations

import queue
import threading
from concurrent.futures import Future

from repro_torch.serve.service import SelectionRequest, SelectionService


def serve_batch(service: SelectionService, requests) -> list:
    """Synchronous grouping entry point: one call, many requests, answers
    in request order."""
    return service.serve(list(requests))


class Dispatcher:
    """Threaded micro-batching front end over a :class:`SelectionService`.

    ``submit`` returns a ``concurrent.futures.Future`` resolving to the
    request's :class:`SelectionResult`; ``max_batch`` caps how many queued
    requests one drain takes.  An error of a batch reaches every waiter of
    that batch.
    """

    def __init__(self, service: SelectionService, max_batch: int = 16):
        if max_batch < 1:
            raise ValueError(f"max_batch={max_batch} < 1")
        self.service = service
        self.max_batch = max_batch
        self._q: queue.Queue = queue.Queue()
        self._stop = object()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="serve-dispatcher")
        self._thread.start()

    def submit(self, req: SelectionRequest) -> Future:
        fut: Future = Future()
        self._q.put((req, fut))
        return fut

    def map(self, requests, timeout: float | None = None) -> list:
        """Submit many, wait for all; results in request order."""
        futs = [self.submit(r) for r in requests]
        return [f.result(timeout=timeout) for f in futs]

    def close(self, timeout: float | None = None) -> None:
        """Stop the worker after the requests queued before this call;
        raises if it has not stopped within ``timeout`` seconds."""
        self._q.put(self._stop)
        self._thread.join(timeout)
        if self._thread.is_alive():
            raise RuntimeError(f"dispatcher worker still running after "
                               f"{timeout} s")

    # -- worker ------------------------------------------------------------
    def _drain(self, first) -> tuple[list, bool]:
        """The queued slice behind ``first`` (≤ max_batch), and whether a
        stop token was seen while draining."""
        batch, stopped = [first], False
        while len(batch) < self.max_batch:
            try:
                item = self._q.get_nowait()
            except queue.Empty:
                break
            if item is self._stop:
                stopped = True
                break
            batch.append(item)
        return batch, stopped

    def _run(self) -> None:
        while True:
            item = self._q.get()
            if item is self._stop:
                return
            batch, stopped = self._drain(item)
            self.service.note_queue_depth(len(batch) + self._q.qsize())
            try:
                results = self.service.serve([r for r, _f in batch])
                for (_r, fut), res in zip(batch, results):
                    fut.set_result(res)
            except BaseException as exc:   # surface to every waiter
                for _r, fut in batch:
                    if not fut.done():
                        fut.set_exception(exc)
            if stopped:
                return
