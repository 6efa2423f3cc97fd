"""Bounded ingest queue — concurrent uploads coalesce into batched
store commits.

The front-end's handler threads do NOT call ``store.write`` directly
(thread-per-client commit was the seed's implied model). Instead each
admitted upload is enqueued as a :class:`concurrent.futures.Future`;
ONE committer thread drains up to ``batch_max`` pending uploads at a
time and lands them through ``store.write_batch`` — one registration
lock acquisition and one arrival notification per batch instead of per
update. The handler replies 200 only after its future resolves, i.e.
after the update is DURABLY registered (and, on a disk store, its blob
and sidecars staged).

Backpressure is explicit: a full queue raises
:class:`BackpressureError` immediately (the front-end maps it to 503 +
Retry-After) — the socket is never used as an invisible buffer.
"""
from __future__ import annotations

import queue
import threading
from concurrent.futures import Future
from typing import List, Optional, Tuple

from repro_torch.core.store import DEFAULT_TENANT

_SENTINEL = object()


class BackpressureError(RuntimeError):
    """The ingest queue is full — retry after ``retry_after`` s (503)."""

    def __init__(self, msg: str, retry_after: float = 0.05):
        super().__init__(msg)
        self.retry_after = retry_after


class IngestQueue:
    """Bounded queue of pending uploads + one batching committer.

    ``maxsize`` bounds queued-but-uncommitted uploads (the
    backpressure horizon); ``batch_max`` caps how many the committer
    folds into one ``store.write_batch`` call."""

    def __init__(self, store, maxsize: int = 256, batch_max: int = 32,
                 retry_after: float = 0.05):
        if maxsize < 1 or batch_max < 1:
            raise ValueError("maxsize and batch_max must be >= 1")
        self.store = store
        self.batch_max = int(batch_max)
        self.retry_after = float(retry_after)
        self._q: "queue.Queue" = queue.Queue(maxsize=maxsize)
        self._lock = threading.Lock()
        self._closed = False  # guarded-by: _lock
        self._submitted = 0  # guarded-by: _lock
        self._committed = 0  # guarded-by: _lock
        self._rejected = 0  # guarded-by: _lock
        self._shed = 0  # guarded-by: _lock
        self._batches = 0  # guarded-by: _lock
        self._max_batch = 0  # guarded-by: _lock
        self._thread = threading.Thread(
            target=self._run, name="ingest-committer", daemon=True
        )
        self._thread.start()

    # -- producer side -------------------------------------------------------
    def submit(self, client_id: str, update, weight: float = 1.0,
               tenant: str = DEFAULT_TENANT) -> "Future":
        """Enqueue one upload; resolves to the modeled write latency,
        or raises the store's exception (e.g. ``QuotaExceededError``).
        Raises :class:`BackpressureError` without queueing when full."""
        with self._lock:
            if self._closed:
                raise RuntimeError("IngestQueue is closed")
            self._submitted += 1
        fut: Future = Future()
        try:
            self._q.put_nowait((fut, (client_id, update, weight, tenant)))
        except queue.Full:
            with self._lock:
                self._shed += 1
            raise BackpressureError(
                f"ingest queue full ({self._q.maxsize} pending)",
                retry_after=self.retry_after,
            ) from None
        return fut

    # -- committer -----------------------------------------------------------
    def _drain(self) -> Tuple[List, bool]:
        """Block for one upload, then opportunistically batch whatever
        else is already queued (bounded by ``batch_max``)."""
        head = self._q.get()
        if head is _SENTINEL:
            return [], True
        batch = [head]
        stop = False
        while len(batch) < self.batch_max:
            try:
                nxt = self._q.get_nowait()
            except queue.Empty:
                break
            if nxt is _SENTINEL:
                stop = True
                break
            batch.append(nxt)
        return batch, stop

    def _run(self) -> None:
        while True:
            batch, stop = self._drain()
            if batch:
                futs = [f for f, _ in batch]
                items = [it for _, it in batch]
                try:
                    results = self.store.write_batch(items)
                except BaseException as exc:   # store hard-failed
                    for f in futs:
                        f.set_exception(exc)
                else:
                    ok = 0
                    for f, res in zip(futs, results):
                        if isinstance(res, BaseException):
                            f.set_exception(res)
                        else:
                            ok += 1
                            f.set_result(res)
                    with self._lock:
                        self._batches += 1
                        self._max_batch = max(self._max_batch,
                                              len(batch))
                        self._committed += ok
                        self._rejected += len(batch) - ok
            if stop:
                return

    # -- introspection / shutdown --------------------------------------------
    def depth(self) -> int:
        """Uploads queued but not yet handed to the committer."""
        return self._q.qsize()

    def stats(self) -> dict:
        with self._lock:
            return {
                "submitted": self._submitted,
                "committed": self._committed,
                "rejected": self._rejected,
                "shed": self._shed,
                "batches": self._batches,
                "max_batch": self._max_batch,
            }

    def close(self, timeout: Optional[float] = 10.0) -> None:
        """Stop accepting uploads, drain the queue, join the
        committer."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
        self._q.put(_SENTINEL)
        self._thread.join(timeout=timeout)
