"""Async row movement: background prefetch + write-back threads.

The paged round overlaps three timelines:

    device   : [ jitted round t (dispatched async)            ]
    prefetch :    [ load closure(t+1) \\ closure(t) from disk ]
    writeback:                       [ persist round t-1 dirty rows ]

``Prefetcher`` runs a daemon thread draining fetch requests; each request
resolves rows through the :class:`~repro_torch.store.paging.RowCache` first
(pending > LRU) and batch-reads the misses from the store, so a row dirtied
two rounds ago but not yet durable is served from its pending copy, never a
stale chunk.  ``Writeback`` serializes dirty-row persistence on its own
thread; rows are marked pending in the cache *before* enqueue and settled
into the LRU tier only after their chunk write is durable.  Both threads
surface exceptions on the caller's next interaction rather than dying
silently — wrapped in :class:`~repro_torch.store.faults.StoreIOError` naming the
round, the operation, and the file at fault (the original exception rides
as ``__cause__``); :class:`~repro_torch.store.faults.StoreCorruptionError` and
``BaseException`` kills propagate untouched.
"""
from __future__ import annotations

import queue
import threading
import time

import numpy as np

from repro_torch.store.faults import StoreCorruptionError, StoreIOError

__all__ = ["Fetch", "Prefetcher", "Writeback"]

_STOP = object()


def _wrap_background_error(e: BaseException, *, op: str, round_no,
                           detail: str) -> BaseException:
    """Annotate a background-thread failure with its IO context.  Already
    self-describing errors (corruption carries chunk/round/rows; a
    BaseException kill must never be converted to a catchable
    Exception) pass through unchanged."""
    if not isinstance(e, Exception) or isinstance(
            e, (StoreCorruptionError, StoreIOError)):
        return e
    path = getattr(e, "filename", None)
    where = f" of {path}" if path else ""
    err = StoreIOError(
        f"background {op} failed at round {round_no}{where} ({detail}): "
        f"{type(e).__name__}: {e}",
        round_no=round_no, path=path, op=op,
    )
    err.__cause__ = e
    return err


class Fetch:
    """Handle for one in-flight prefetch; ``wait()`` blocks until the rows
    are staged and returns ``{gid: {field: row}}``."""

    def __init__(self, gids, round_no=None):
        self.gids = np.asarray(gids, dtype=np.int64)
        self.round_no = round_no
        self.rows: dict = {}
        self.busy_s = 0.0       # background time spent resolving
        self.from_cache = 0     # rows served without a store read
        self.from_store = 0
        self._done = threading.Event()
        self._error: BaseException | None = None

    def _finish(self, error=None):
        self._error = error
        self._done.set()

    def wait(self) -> dict:
        self._done.wait()
        if self._error is not None:
            raise _wrap_background_error(
                self._error, op="prefetch", round_no=self.round_no,
                detail=f"{len(self.gids)} rows requested",
            )
        return self.rows


def resolve_rows(store, cache, gids, fetch: Fetch):
    """Fill ``fetch.rows`` for ``gids``: cache first, then one batched
    store read for the misses (which also warms the LRU tier)."""
    misses = []
    for gid in gids:
        row = cache.get(int(gid)) if cache is not None else None
        if row is not None:
            fetch.rows[int(gid)] = row
            fetch.from_cache += 1
        else:
            misses.append(int(gid))
    if misses:
        stacked = store.read_rows(np.asarray(misses, dtype=np.int64))
        for i, gid in enumerate(misses):
            row = {k: v[i] for k, v in stacked.items()}
            fetch.rows[gid] = row
            if cache is not None:
                cache.put_clean(gid, row)
        fetch.from_store += len(misses)
    return fetch


class Prefetcher:
    def __init__(self, store, cache):
        self.store = store
        self.cache = cache
        self._q: queue.Queue = queue.Queue()
        self._thread = threading.Thread(
            target=self._run, name="store-prefetch", daemon=True
        )
        self._thread.start()

    def _run(self):
        while True:
            item = self._q.get()
            if item is _STOP:
                return
            fetch = item
            t0 = time.perf_counter()
            try:
                resolve_rows(self.store, self.cache, fetch.gids, fetch)
            except BaseException as e:  # surfaced at wait()
                fetch.busy_s = time.perf_counter() - t0
                fetch._finish(e)
            else:
                fetch.busy_s = time.perf_counter() - t0
                fetch._finish()

    def submit(self, gids, round_no=None) -> Fetch:
        fetch = Fetch(gids, round_no=round_no)
        self._q.put(fetch)
        return fetch

    def close(self):
        self._q.put(_STOP)
        self._thread.join(timeout=30)


class Writeback:
    """Single persistence thread: dirty rows (already pending in the
    cache) are written back chunk-atomically in submission order, then
    settled into the LRU tier."""

    def __init__(self, store, cache):
        self.store = store
        self.cache = cache
        self._q: queue.Queue = queue.Queue()
        self._error: BaseException | None = None
        self._thread = threading.Thread(
            target=self._run, name="store-writeback", daemon=True
        )
        self._thread.start()

    def _run(self):
        while True:
            item = self._q.get()
            try:
                if item is _STOP:
                    return
                ids, values, round_no = item
                try:
                    self.store.write_rows(ids, values)
                except BaseException as e:
                    raise _wrap_background_error(
                        e, op="write-back", round_no=round_no,
                        detail=f"{len(ids)} dirty rows",
                    )
                for gid in ids:
                    self.cache.settle(int(gid))
            except BaseException as e:
                self._error = e
            finally:
                self._q.task_done()

    def _raise_pending(self):
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def enqueue(self, ids, values: dict, round_no=None):
        """``values`` are field-stacked arrays aligned with ``ids``; the
        caller must have ``put_pending`` every row first so reads stay
        consistent while the write is in flight."""
        self._raise_pending()
        self._q.put((np.asarray(ids, dtype=np.int64), values, round_no))

    def flush(self):
        self._q.join()
        self._raise_pending()

    def close(self):
        self._q.put(_STOP)
        self._thread.join(timeout=30)
        self._raise_pending()
