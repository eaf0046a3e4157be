"""Fault injection and fault taxonomy for the disk-backed client store.

The store's durability story is only as good as its behavior under the
failures real disks and real processes produce.  This module provides:

- :class:`FaultInjector` — a *seeded* chaos source wired behind the
  store's real file operations (``ClientStore`` routes every chunk /
  manifest / blob read and write through it when attached).  It models
  the four failure shapes the chaos harness exercises: transient ``EIO``
  on read, slow-read stragglers, torn chunk writes (a writer that dies
  mid-``.tmp``, leaving a partial temp file and never renaming), and
  post-write bit-flip corruption (the failure checksums exist to catch).
- :class:`StoreCorruptionError` — checksum mismatch on fault-in.  Raised
  with the chunk id, file path, committed round, and the dirty rows at
  stake, so a corrupted store fails loudly and diagnosably, never
  silently consuming flipped bits.
- :class:`StoreIOError` — the paged pipeline's context wrapper: a
  background prefetch / write-back failure re-raises at ``wait()``
  wrapped with the round number, chunk path, and operation.
- :class:`InjectedCrash` — the simulated process kill the crash-point
  tests throw mid-chunk-write / mid-manifest-commit.  It derives from
  ``BaseException`` so ordinary ``except Exception`` recovery paths do
  not swallow a "kill".
- :func:`retry_transient` — bounded exponential backoff + jitter around
  a transient-faulting IO callable (the policy the store's chunk reads
  and the write-back use).

Everything here is host-side stdlib + numpy; determinism comes from the
injector's own ``numpy.random.Generator`` seeded at construction.
"""
from __future__ import annotations

import dataclasses
import errno
import os
import time

import numpy as np

__all__ = [
    "FaultInjector",
    "InjectedCrash",
    "StoreCorruptionError",
    "StoreIOError",
    "retry_transient",
]


class StoreCorruptionError(RuntimeError):
    """A chunk's bytes no longer match its recorded checksum.

    Carries everything needed to act on the failure: which chunk
    (``chunk_start`` / ``path``), the store round it was committed at
    (``round_no``), and which rows actually held trained data
    (``dirty_rows`` — when empty the chunk was rebuilt from the template
    and this error is not raised at all).
    """

    def __init__(self, message: str, *, chunk_start: int | None = None,
                 path: str | None = None, round_no=None, dirty_rows=None):
        super().__init__(message)
        self.chunk_start = chunk_start
        self.path = path
        self.round_no = round_no
        self.dirty_rows = dirty_rows


class StoreIOError(RuntimeError):
    """A paged-pipeline IO failure, annotated with its context.

    Background prefetch / write-back threads capture exceptions and
    re-raise them on the caller's thread at ``wait()`` — wrapped in this
    type so the message names the round, the operation (read /
    write-back), and the chunk path instead of surfacing a bare
    ``OSError``.  The original failure rides as ``__cause__``.
    """

    def __init__(self, message: str, *, round_no=None, path: str | None = None,
                 op: str | None = None):
        super().__init__(message)
        self.round_no = round_no
        self.path = path
        self.op = op


class InjectedCrash(BaseException):
    """Simulated process kill at an injected crash point.

    A ``BaseException`` on purpose: recovery code that catches
    ``Exception`` (retry loops, error-context wrappers) must not be able
    to "survive" a kill — only the test harness, which expects it,
    catches this.
    """


@dataclasses.dataclass
class FaultInjector:
    """Seeded chaos source for the store's file operations.

    Probabilities are per-operation and drawn from the injector's own
    PRNG, so a given ``seed`` yields one reproducible fault schedule.

    ``eio_prob`` / ``eio_max_per_path``: reads fail with transient
    ``OSError(EIO)``, at most ``eio_max_per_path`` consecutive times per
    file — so bounded retries always eventually succeed (a model of
    transient controller hiccups, not dead media).

    ``slow_prob`` / ``slow_seconds``: reads sleep (straggler IO).

    ``torn_write_prob`` / ``torn_max_per_path``: a write dumps a partial
    ``*.crashed.tmp`` next to its target and fails with ``EIO`` before
    the atomic rename — the classic died-mid-write shape.  Also bounded
    per path so retried writes land.

    ``corrupt_prob``: after a successful write, flip one random bit of
    the file on disk.  The paths hit are recorded in ``corrupted`` (the
    chaos harness asserts every one was *detected* by checksum, never
    silently consumed).

    ``crash_on``: ``"chunk-write"`` or ``"manifest-commit"`` arms a
    one-shot :class:`InjectedCrash` raised mid-write of the next matching
    file (after the partial tmp is dumped, before the rename) — the
    crash-point recovery tests drive this.
    """

    seed: int = 0
    eio_prob: float = 0.0
    eio_max_per_path: int = 2
    slow_prob: float = 0.0
    slow_seconds: float = 0.002
    torn_write_prob: float = 0.0
    torn_max_per_path: int = 1
    corrupt_prob: float = 0.0
    crash_on: str | None = None

    def __post_init__(self):
        for f in ("eio_prob", "slow_prob", "torn_write_prob",
                  "corrupt_prob"):
            v = getattr(self, f)
            if not 0.0 <= v <= 1.0:
                raise ValueError(
                    f"FaultInjector.{f} must be a probability in [0, 1], "
                    f"got {v!r}"
                )
        if self.crash_on not in (None, "chunk-write", "manifest-commit"):
            raise ValueError(
                "FaultInjector.crash_on must be None, 'chunk-write' or "
                f"'manifest-commit', got {self.crash_on!r}"
            )
        self._rng = np.random.default_rng(self.seed)
        self._eio_counts: dict[str, int] = {}
        self._torn_counts: dict[str, int] = {}
        self.corrupted: list[str] = []
        self.faults_injected = 0

    # -- read-side faults ---------------------------------------------------

    def on_read(self, path: str):
        """Called before a file read; may sleep or raise transient EIO."""
        if self.slow_prob and self._rng.random() < self.slow_prob:
            self.faults_injected += 1
            time.sleep(self.slow_seconds)
        if self.eio_prob and self._rng.random() < self.eio_prob:
            c = self._eio_counts.get(path, 0)
            if c < self.eio_max_per_path:
                self._eio_counts[path] = c + 1
                self.faults_injected += 1
                raise OSError(
                    errno.EIO, "injected transient read fault", path
                )
        self._eio_counts.pop(path, None)

    # -- write-side faults --------------------------------------------------

    def _is_manifest(self, path: str) -> bool:
        return os.path.basename(path).startswith("manifest")

    def on_write(self, path: str, data: bytes):
        """Called before an atomic write; may tear the write (partial tmp
        dumped, no rename) or raise the armed one-shot crash."""
        crash = self.crash_on is not None and (
            (self.crash_on == "manifest-commit") == self._is_manifest(path)
        )
        torn = bool(
            self.torn_write_prob
            and self._rng.random() < self.torn_write_prob
            and self._torn_counts.get(path, 0) < self.torn_max_per_path
        )
        if not (crash or torn):
            return
        # The died-mid-write residue: a partial foreign tmp next to the
        # target; the real file (old version) is untouched.
        tmp = path + ".crashed.tmp"
        with open(tmp, "wb") as f:
            f.write(data[: max(1, len(data) // 3)])
        self.faults_injected += 1
        if crash:
            self.crash_on = None  # one-shot
            raise InjectedCrash(
                f"injected kill mid-write of {os.path.basename(path)}"
            )
        self._torn_counts[path] = self._torn_counts.get(path, 0) + 1
        raise OSError(errno.EIO, "injected torn write", path)

    def post_write(self, path: str):
        """Called after a durable write; may flip one bit on disk."""
        if not self.corrupt_prob or self._rng.random() >= self.corrupt_prob:
            return
        size = os.path.getsize(path)
        if size == 0:
            return
        off = int(self._rng.integers(size))
        with open(path, "r+b") as f:
            f.seek(off)
            byte = f.read(1)
            f.seek(off)
            f.write(bytes([byte[0] ^ (1 << int(self._rng.integers(8)))]))
        self.corrupted.append(path)
        self.faults_injected += 1


def retry_transient(fn, *, retries: int = 4, backoff_base: float = 0.01,
                    backoff_cap: float = 0.25, rng=None, on_retry=None):
    """Run ``fn()`` retrying transient ``OSError`` with bounded
    exponential backoff + jitter.

    Sleeps ``min(cap, base * 2**attempt) * (0.5 + u)`` with ``u`` uniform
    in [0, 1) from ``rng`` (seeded by the caller for determinism of the
    *schedule*; the sleep itself is wall-clock).  ``on_retry(seconds)``
    is invoked per retry so the caller can account
    retries / backoff_seconds into its stats.  Non-``OSError`` failures
    (checksum corruption, injected crashes) propagate immediately — only
    transient IO is retried.
    """
    rng = rng or np.random.default_rng(0)
    last = None
    for attempt in range(retries + 1):
        try:
            return fn()
        except FileNotFoundError:
            raise
        except OSError as e:
            last = e
            if attempt == retries:
                break
            delay = min(backoff_cap, backoff_base * (2.0 ** attempt))
            delay *= 0.5 + float(rng.random())
            if on_retry is not None:
                on_retry(delay)
            time.sleep(delay)
    raise last
