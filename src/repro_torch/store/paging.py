"""The paging layer: fault-in closure planning + the hot-row cache.

One paged round resides on a **compact bank** of ``c_max`` rows, where
``c_max = min(n, k_active * (k_in + 1))`` is the static upper bound of the
round's fault-in closure:

    closure(t) = active(t)  ∪  in_neighbors(active(t))

``build_plan`` samples the round's active set and its in-neighbor picks
(:func:`repro_torch.core.topology.sample_active_picks`), lays the closure out as
``[active | cold | pads]``, and remaps the picks into a compact
:class:`~repro_torch.core.topology.NeighborList` over resident *slots*:

  * slot 0 is the self-loop; each real row's weight is ``1 / outdeg`` where
    ``outdeg(j) = 1 + #active receivers that picked j`` — exactly the
    column-stochastic sender normalization of
    ``column_stochastic_from_adjacency`` on the active-receiver-masked
    adjacency, so push-sum mass over the closure is conserved and every
    non-closure row (whose column is the identity) is simply *not paged in*.
  * cold rows (faulted in only as senders) keep a pure self-loop at weight
    ``1/outdeg``: their mass share to active receivers leaves through the
    picks, the rest stays home — the de-biased ratio z = x/w of a cold row
    is unchanged because x and w scale identically.
  * pad rows are identity self-loops at weight 1 over zero params / unit
    weight, inert by construction.

The plan is pure host numpy off a fixed PRNG chain
(:func:`repro_torch.core.program.plan_keys`), so the fully-resident reference
driver can replay the identical stream — the equivalence the tests pin.
"""
from __future__ import annotations

import dataclasses
import threading
from collections import OrderedDict

import numpy as np

__all__ = [
    "RoundPlan",
    "closure_bound",
    "build_closure",
    "build_plan",
    "dense_partial_operator",
    "RowCache",
    "PagerStats",
]


def closure_bound(n: int, k_active: int, k_in: int) -> int:
    """Static resident-bank row bound: every active row plus its (at most)
    ``k_in`` distinct in-neighbors, never more than the population."""
    return int(min(n, k_active * (k_in + 1)))


@dataclasses.dataclass(frozen=True)
class RoundPlan:
    """Everything round t needs before any device work happens."""

    t: int
    key: object        # the round's generator at round start
    key_next: object   # the next round's generator (the chain the twin replays)
    ckey_base: object  # the generator of the active clients' minibatches
    active: np.ndarray   # (k_active,) sampled global ids
    picks: np.ndarray    # (k_active, k_in) global in-neighbor ids
    closure: np.ndarray  # (c,) global ids, [active | cold]
    c: int               # real closure size (<= c_max)
    ids: np.ndarray      # (c_max,) global ids, pads repeat closure[0]
    idx: np.ndarray      # (c_max, 1 + k_in) compact in-neighbor slots
    wgt: np.ndarray      # (c_max, 1 + k_in) mixing weights


def build_closure(active: np.ndarray, picks: np.ndarray):
    """``(closure, c)`` with the active rows first and the cold senders
    (picked but not sampled) after, each id exactly once."""
    active = np.asarray(active, dtype=np.int64)
    uniq = np.unique(picks)
    cold = np.setdiff1d(uniq, active)
    closure = np.concatenate([active, cold])
    return closure, int(closure.size)


def build_plan(
    t: int,
    key,
    key_next,
    ckey_base,
    active,
    picks,
    c_max: int,
) -> RoundPlan:
    """Lay the closure out over ``c_max`` resident slots and remap the
    picks into the compact column-stochastic NeighborList (see module
    docstring for the operator's exact semantics)."""
    active = np.asarray(active, dtype=np.int64)
    picks = np.asarray(picks, dtype=np.int64)
    k_active, k_in = picks.shape
    closure, c = build_closure(active, picks)
    if c > c_max:
        raise ValueError(f"closure size {c} exceeds the static bound "
                         f"{c_max}")
    # Global id -> resident slot, vectorized via searchsorted over the
    # sorted closure (every pick is in the closure by construction).
    order = np.argsort(closure, kind="stable")
    slot_of_sorted = order[
        np.searchsorted(closure[order], picks.reshape(-1))
    ]
    slot_picks = slot_of_sorted.reshape(k_active, k_in).astype(np.int32)
    # A pick equal to the receiver's own id (how churn voids a dead
    # sender's edge without changing the pick shape) is INERT: the dense
    # operator forces self-loops on idempotently, so the edge must add
    # nothing beyond the implicit slot-0 self-loop — excluded from the
    # out-degree count and carried at weight 0.
    self_pick = slot_picks == np.arange(k_active, dtype=np.int32)[:, None]
    # Sender out-degree over the masked adjacency: self-loop + the number
    # of active receivers that picked it.
    outdeg = np.ones((c_max,), np.float32)
    np.add.at(outdeg, slot_picks[~self_pick], 1.0)

    slots = np.arange(c_max, dtype=np.int32)
    idx = np.repeat(slots[:, None], 1 + k_in, axis=1)
    idx[:k_active, 1:] = slot_picks
    wgt = np.zeros((c_max, 1 + k_in), np.float32)
    wgt[:, 0] = 1.0 / outdeg          # real rows: the self share
    wgt[c:, 0] = 1.0                  # pads: inert identity
    wgt[:k_active, 1:] = np.where(
        self_pick, 0.0, 1.0 / outdeg[slot_picks]
    )

    ids = np.full((c_max,), closure[0] if c else 0, dtype=np.int64)
    ids[:c] = closure
    return RoundPlan(
        t=t, key=key, key_next=key_next, ckey_base=ckey_base,
        active=active, picks=picks, closure=closure, c=c,
        ids=ids, idx=idx, wgt=wgt,
    )


def dense_partial_operator(active, picks, n: int):
    """The full ``(n, n)`` matrix the compact operator embeds into: the
    active-receiver-masked adjacency, sender-normalized — identity columns
    for every row outside the closure.  The fully-resident reference
    driver mixes with this; ``build_plan``'s weights are the same
    ``1/outdeg`` values, so the two agree to accumulation order."""
    from repro_torch.core import topology

    import torch

    adj = np.zeros((n, n), np.float32)
    active = np.asarray(active, dtype=np.int64)
    picks = np.asarray(picks, dtype=np.int64)
    adj[np.repeat(active, picks.shape[1]), picks.reshape(-1)] = 1.0
    return topology.column_stochastic_from_adjacency(
        torch.from_numpy(adj)).numpy()


@dataclasses.dataclass
class PagerStats:
    """Per-run paging counters — the bench JSON reads these, so cache
    thrash is visible, not just wall-clock."""

    rounds: int = 0
    rows_needed: int = 0        # closure rows assembled across rounds
    rows_carried: int = 0       # served from the previous round's output
    rows_prefetched: int = 0    # served by the background prefetcher
    rows_cache_hit: int = 0     # served from the write-back/LRU cache
    rows_faulted: int = 0       # synchronous store reads on the round path
    chunks_written: int = 0
    prefetch_wait_s: float = 0.0   # time the round path blocked on fetches
    prefetch_busy_s: float = 0.0   # background time spent loading
    writeback_rows: int = 0
    # Self-healing IO counters, mirrored from the store (see
    # ClientStore.io_retries etc.) so the bench JSON shows what the run
    # absorbed: transient-fault retries + their total backoff sleep,
    # checksum failures quarantined, and template-rebuilt rows.
    io_retries: int = 0
    backoff_seconds: float = 0.0
    corrupt_chunks: int = 0
    rebuilt_rows: int = 0

    def as_dict(self) -> dict:
        d = dataclasses.asdict(self)
        rounds = max(self.rounds, 1)
        d["rows_faulted_per_round"] = self.rows_faulted / rounds
        d["rows_needed_per_round"] = self.rows_needed / rounds
        hit = (self.rows_carried + self.rows_prefetched
               + self.rows_cache_hit)
        d["prefetch_hit_rate"] = hit / max(self.rows_needed, 1)
        # Background load time that did NOT stall the round path — the
        # overlap the async prefetcher buys.
        d["prefetch_overlap_s"] = max(
            self.prefetch_busy_s - self.prefetch_wait_s, 0.0
        )
        return d


class RowCache:
    """Write-back row cache in front of the store.

    Rows live in one of two tiers: **pending** (dirtied by a round, queued
    for the write-back thread — never evicted until durable) and **LRU**
    (clean copies of recently used rows, bounded by ``capacity``).  Lookup
    order pending -> LRU mirrors the consistency rule: the freshest value
    of a dirty row is always in pending until the store write completes,
    at which point it atomically moves to the LRU tier — a concurrent
    prefetch therefore reads either the pending copy or the durable chunk,
    never a stale intermediate.
    """

    def __init__(self, capacity: int):
        self.capacity = int(capacity)
        self._pending: dict[int, dict] = {}
        self._lru: OrderedDict[int, dict] = OrderedDict()
        self._lock = threading.Lock()

    def __len__(self):
        with self._lock:
            return len(self._pending) + len(self._lru)

    def get(self, gid: int):
        with self._lock:
            row = self._pending.get(gid)
            if row is not None:
                return row
            row = self._lru.get(gid)
            if row is not None:
                self._lru.move_to_end(gid)
            return row

    def put_pending(self, gid: int, row: dict):
        with self._lock:
            self._pending[gid] = row
            self._lru.pop(gid, None)

    def settle(self, gid: int):
        """Move a row pending -> LRU after its chunk write became durable
        (keeps serving hot rows without touching disk)."""
        with self._lock:
            row = self._pending.pop(gid, None)
            if row is not None:
                self._lru[gid] = row
                self._lru.move_to_end(gid)
                while len(self._lru) > self.capacity:
                    self._lru.popitem(last=False)

    def put_clean(self, gid: int, row: dict):
        with self._lock:
            if gid in self._pending:
                return  # a dirtier copy is already queued
            self._lru[gid] = row
            self._lru.move_to_end(gid)
            while len(self._lru) > self.capacity:
                self._lru.popitem(last=False)

    @property
    def pending_count(self) -> int:
        with self._lock:
            return len(self._pending)
