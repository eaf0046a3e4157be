"""Paged training: the virtual client population driver — the port of
``repro.store.paged``.

``PagedRunner`` drives :meth:`repro_torch.core.program.RoundProgram.step_active`
over a disk-backed :class:`~repro_torch.store.store.ClientStore`: per round
it plans the fault-in closure (sampled active set ∪ their in-neighbors),
assembles the compact ``(c_max, D)`` resident bank on the host from carried
rows / prefetched rows / the write-back cache / synchronous store faults,
copies it to the program's device and runs the compact round there; while
the device computes it already plans round t+1 and prefetches its new rows
on a background thread, and dirty rows write back asynchronously after the
mix.  Device and host bank buffers are proportional to the closure bound,
never to n.

``ResidentDriver`` is the fully-resident reference: the identical random
chain (:func:`repro_torch.core.program.plan_keys`) and the identical
closure-masked mixing operator, executed on a full ``(n, D)`` bank with a
dense matrix.

A checkpoint *is* the store: ``save()`` flushes the write-back queue and
commits ``(round, key)`` into the manifest; re-opening the directory
resumes bit-identically.

Random streams.  The paged chain runs on CPU generators, so the card and
the CPU replay the same schedule.  The store's meta holds the port's round
generator under ``torch_key`` (its seed and ``get_state()`` bytes) and the
churn root under ``torch_churn_seed0``; it also holds ``key``, the JAX key
words the reference's runner reads, which the port writes from its
generator's seed.  A store written by the reference opens here with equal
rows and round index, and the schedule from then on is the opener's own
(drawn from its ``seed``); the same holds the other way.
"""
from __future__ import annotations

import functools
import os
import time

import numpy as np
import torch

from repro_torch.checkpoint.io import _dtype_name, _spec_meta
from repro_torch.core import pushsum, topology
from repro_torch.core.program import (
    CHURN_STREAM,
    ActiveSlots,
    FLState,
    plan_keys,
)
from repro_torch.core.stages import IdentityCompressor, _selfloop_correction
from repro_torch.store import paging
from repro_torch.store.layout import FieldSpec
from repro_torch.store.paging import PagerStats, RowCache, RoundPlan
from repro_torch.store.prefetch import Prefetcher, Writeback
from repro_torch.store.store import ClientStore

__all__ = ["PagedRunner", "ResidentDriver", "make_plan", "bank_fields"]

_PAGED_KINDS = ("ring", "exponential", "kout", "two_tier")


def _check_paged_program(program):
    if program.mixer.kind != "directed" or program.linked:
        raise ValueError(
            "paged training is directed push-sum only (no link scenarios: "
            "delayed/event mixers carry full-population state)"
        )
    if program.selection:
        raise ValueError(
            "loss-selective neighbor sampling reads every client's loss — "
            "it has no paged form"
        )
    if getattr(program, "churned", False):
        raise ValueError(
            "pass churn= to PagedRunner / ResidentDriver, not to "
            "make_program(...): the paged path drives liveness host-side "
            "(dead rows must leave the sampling pool, not ride the bank)"
        )
    if program.topo.kind not in _PAGED_KINDS:
        raise ValueError(
            f"topology kind {program.topo.kind!r} has no paged form "
            f"(supported: {_PAGED_KINDS})"
        )


def bank_fields(program) -> dict:
    """The store schema of one client row under ``program``'s composition:
    params (+ the broadcast init template), momentum, push-sum weight,
    last loss, and the EF residual iff the compressor is stateful."""
    D = program.spec.dim
    if program.spec.dtype != torch.float32:
        raise ValueError(
            "the paged store holds float32 rows in the port (numpy has no "
            f"bfloat16 without ml_dtypes); got bank dtype {program.spec.dtype}"
        )
    fields = {
        "params": FieldSpec("params", (D,), _dtype_name(program.spec.dtype)),
        "mom": FieldSpec("mom", (D,), "float32"),
        "w": FieldSpec("w", (), "float32", default=1.0),
        "losses": FieldSpec("losses", (), "float32"),
    }
    if program.compressor.stateful:
        fields["ef"] = FieldSpec("ef", (D,), "float32")
    return fields


# -- the generators' meta form ----------------------------------------------

def _gen_meta(gen: torch.Generator) -> dict:
    return {"seed": int(gen.initial_seed()),
            "state": gen.get_state().numpy().tobytes().hex()}


def _gen_from_meta(d: dict) -> torch.Generator:
    gen = torch.Generator().manual_seed(int(d["seed"]))
    gen.set_state(torch.from_numpy(
        np.frombuffer(bytes.fromhex(d["state"]), dtype=np.uint8).copy()))
    return gen


def _jax_key_words(gen: torch.Generator) -> list:
    """A well-formed JAX key (the seed's two 32-bit words) for the meta
    field the reference's runner reads; not the port's stream."""
    seed = int(gen.initial_seed()) % (1 << 64)
    return [seed >> 32, seed & 0xFFFFFFFF]


def _root_chain(program, seed: int):
    """``(init_row, round generator)``: the init row drawn from a CPU
    generator seeded with ``seed``, which then drives the round chain, as
    ``program.init`` does."""
    gen = torch.Generator().manual_seed(seed)
    return program.init_row(gen).detach().cpu(), gen


def _churn_root(seed: int) -> int:
    return (seed + (CHURN_STREAM << 32)) % (1 << 63)


def _churn_gen(root: int, t: int) -> torch.Generator:
    """Round ``t``'s churn generator, keyed by the round index so a resumed
    run replays the identical fail/recover schedule with no state."""
    return torch.Generator().manual_seed(
        (root * 0x9E3779B97F4A7C15 + t + 1) % (1 << 63))


def _transition(live: np.ndarray, churn, root: int, t: int) -> np.ndarray:
    u = topology.draw_churn(_churn_gen(root, t), live.shape[0])
    return topology.churn_transition(
        u, torch.from_numpy(live), churn).numpy().astype(np.int8)


def make_plan(topo, k_active: int, c_max: int, gen, t: int, live=None,
              draws: dict | None = None) -> RoundPlan:
    """One round's host-side plan off the shared random chain: sample the
    active set, its in-neighbor picks, and build the compact operator.

    ``topo`` is a :class:`~repro_torch.core.topology.TopologyConfig` or a
    prebuilt :class:`~repro_torch.comm.plan.CommPlan`.  ``draws`` may
    supply the round's ``"perm"`` (the active-set permutation of
    ``range(n)``) and ``"scores"`` (the ``kout`` and ``two_tier`` picks'
    ``(k_active, n)`` uniforms) instead of ``gen``'s; the chain advances
    all the same.

    With a churn liveness vector ``live``, dead clients leave the pool: the
    active set is the first ``k_active`` live ids of the same permutation,
    and a pick landing on a dead sender is remapped to the receiver's own
    id — an inert edge ``build_plan`` voids."""
    from repro_torch.comm.plan import CommPlan

    draws = draws or {}
    comm = topo if isinstance(topo, CommPlan) else CommPlan.build(topo)
    topo = comm.topo
    key_next, akey, tkey, ckey_base = plan_keys(gen)
    perm = draws.get("perm")
    perm = (torch.randperm(topo.n_clients, generator=akey).numpy()
            if perm is None else np.asarray(perm, dtype=np.int64))
    if live is not None:
        alive = perm[live[perm] == topology.LIVE]
        if alive.size < k_active:
            raise ValueError(
                f"round {t}: only {alive.size} live clients remain, "
                f"cannot sample k_active={k_active} — lower k_active or "
                "the churn fail_prob / permanent_frac"
            )
        active = alive[:k_active]
    else:
        active = perm[:k_active]
    picks = comm.in_neighbors(tkey, torch.from_numpy(active.astype(np.int64)),
                              t=t, scores=draws.get("scores")).numpy()
    if live is not None:
        picks = np.where(live[picks] == topology.LIVE,
                         picks, active[:, None])
    return paging.build_plan(
        t, gen, key_next, ckey_base, active, picks, c_max
    )


class PagedRunner:
    """Disk-backed partial-participation training (see module docstring).

    Args:
      program: a :class:`~repro_torch.core.program.RoundProgram` (directed
        push-sum, link-free).  The compact round runs on its device.
      store_dir: the store directory; created if absent, resumed from its
        manifest if it already holds a store.
      k_active: sampled clients per round.
      seed: seeds the init row and the round chain of a fresh store, and
        the chain of a store whose meta holds no port generator.
      rows_per_chunk: chunk-file row granularity for fresh stores.
      prefetch: overlap round t+1's closure loads with round t's compute.
      lru_rows: clean-row cache capacity (default ``4 * c_max``).
      churn: optional :class:`~repro_torch.core.topology.ChurnModel`,
        driven host-side: dead clients leave the active sampling pool
        (their rows stay frozen on disk, mass intact), a warm resurrection
        resumes the stored row, a cold one rewrites it to ``w * template``.
        Liveness persists as a checksummed store blob at every ``save()``.
      faults: optional :class:`~repro_torch.store.faults.FaultInjector`
        wired behind the store's file operations.
    """

    def __init__(
        self,
        program,
        store_dir: str,
        k_active: int,
        *,
        seed: int = 0,
        rows_per_chunk: int = 256,
        prefetch: bool = True,
        lru_rows: int | None = None,
        churn: topology.ChurnModel | None = None,
        faults=None,
    ):
        _check_paged_program(program)
        if not 1 <= k_active <= program.n:
            raise ValueError(
                f"k_active must be in [1, n={program.n}], got {k_active}"
            )
        self.program = program
        self.device = program.device
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "the paged runner stages onto the program's device, and no "
                "CUDA device is available; build the program with "
                "device='cpu' to run on the CPU"
            )
        self.topo = program.topo
        self.n = program.n
        self.k_active = int(k_active)
        from repro_torch.comm.plan import CommPlan

        self.comm = CommPlan.build(self.topo)
        self.k_in = self.comm.k_in
        self.c_max = self.comm.closure_bound(k_active)
        self.prefetch_enabled = bool(prefetch)
        self.stats = PagerStats()
        self._fields = bank_fields(program)
        self._spec_meta = _spec_fingerprint(program.spec)
        self._churn = churn if churn is not None and churn.active else None
        self._seed = int(seed)
        self._churn_seed0 = _churn_root(self._seed)

        if ClientStore.exists(store_dir):
            self.store = ClientStore.open(store_dir, faults=faults)
            self._validate_store()
            self._round = int(self.store.meta["round"])
            self._key = self._committed_key()
        else:
            row, gen = _root_chain(program, self._seed)
            self.store = ClientStore.create(
                store_dir, self.n, self._fields,
                rows_per_chunk=rows_per_chunk,
                templates={"params": row.numpy()},
                meta={
                    "round": 0,
                    "key": _jax_key_words(gen),
                    "torch_key": _gen_meta(gen),
                    "spec": self._spec_meta,
                },
                faults=faults,
            )
            self._key = gen
            self._round = 0
        if self._churn is not None:
            root = self.store.meta.get("torch_churn_seed0")
            if root is None:
                # First churned run of the port on this store: pin the
                # chain root so any resume replays the same schedule.
                self.store.update_meta(torch_churn_seed0=self._churn_seed0)
            else:
                self._churn_seed0 = int(root)
        self._load_liveness()

        self._data = program.data
        self.cache = RowCache(lru_rows if lru_rows is not None
                              else 4 * self.c_max)
        self.writeback = Writeback(self.store, self.cache)
        self.prefetcher = (
            Prefetcher(self.store, self.cache)
            if self.prefetch_enabled else None
        )
        # Double-buffered host staging: round t+1 assembles into the other
        # buffer while round t's copies to the device may be in flight.
        self._staging = [self._alloc_staging(), self._alloc_staging()]
        self._buf_i = 0
        self._carry: dict | None = None   # closure(t-1) output rows
        self._next_plan: RoundPlan | None = None
        self._next_fetch = None
        self._step = functools.partial(self.program.step_active,
                                       k_active=self.k_active)

    # -- accounting hooks ------------------------------------------------------

    @property
    def resident_rows(self) -> int:
        """Rows per device bank buffer — the closure bound, not n."""
        return self.c_max

    @property
    def staging_rows(self) -> int:
        """Host staging rows (double buffer)."""
        return 2 * self.c_max

    @property
    def round_index(self) -> int:
        return self._round

    def _alloc_staging(self) -> dict:
        pin = self.device.type == "cuda"
        out = {}
        for name, f in self._fields.items():
            t = torch.zeros((self.c_max,) + f.shape,
                            dtype=getattr(torch, f.dtype), pin_memory=pin)
            out[name] = t.numpy()
        return out

    def _committed_key(self) -> torch.Generator:
        """The round generator the store's meta commits; a store without a
        port generator (written by the reference) gets this runner's own
        chain from ``seed``."""
        meta = self.store.meta.get("torch_key")
        if meta is not None:
            return _gen_from_meta(meta)
        return _root_chain(self.program, self._seed)[1]

    def _validate_store(self):
        if self.store.n != self.n:
            raise ValueError(
                f"store holds n={self.store.n} clients, program has "
                f"{self.n}"
            )
        if set(self.store.fields) != set(self._fields):
            raise ValueError(
                f"store fields {sorted(self.store.fields)} do not match "
                f"the program composition {sorted(self._fields)} — it was "
                "created from a different stage composition"
            )
        if self.store.meta.get("spec") != self._spec_meta:
            raise ValueError("store model structure mismatch")

    # -- churn: host-side liveness ---------------------------------------------

    def _load_liveness(self):
        """Sync ``_live`` with the store's committed liveness blob;
        ``_live_round`` is the round whose transition was last applied."""
        blob = self.store.read_blob("churn_live")
        if blob is not None and self._churn is None:
            raise ValueError(
                f"store {self.store.path} records churn liveness; "
                "construct the PagedRunner with the same churn= model"
            )
        if blob is not None:
            self._live = np.asarray(blob, np.int8).copy()
            self._live_round = self._round
        else:
            self._live = np.full((self.n,), topology.LIVE, np.int8)
            self._live_round = self._round - 1

    def _ensure_live(self, t: int):
        """Apply churn transitions up to (and including) round ``t``."""
        if self._churn is None:
            return
        while self._live_round < t:
            self._live_round += 1
            live_new = _transition(self._live, self._churn,
                                   self._churn_seed0, self._live_round)
            if self._churn.resurrect == "cold":
                reborn = np.nonzero(
                    (self._live == topology.DOWN)
                    & (live_new == topology.LIVE)
                )[0]
                if reborn.size:
                    self._cold_reset(reborn)
            self._live = live_new

    def _cold_reset(self, ids: np.ndarray):
        """Rewrite resurrected rows to ``w * template`` params (de-biased
        model == template, frozen mass kept bit for bit), momentum / EF
        residual zeroed, loss kept — through the pending cache and the
        write-back so every tier stays consistent."""
        tpl = self.store.template("params")
        rows, misses = {}, []
        for gid in (int(g) for g in ids):
            row = self.cache.get(gid)
            if row is None:
                misses.append(gid)
            else:
                rows[gid] = row
        if misses:
            stacked = self.store.read_rows(
                np.asarray(misses, dtype=np.int64)
            )
            for i, gid in enumerate(misses):
                rows[gid] = {k: v[i] for k, v in stacked.items()}
        out = {
            name: np.zeros((len(ids),) + f.shape, dtype=f.dtype)
            for name, f in self._fields.items()
        }
        for i, gid in enumerate(int(g) for g in ids):
            w = np.float32(rows[gid]["w"])
            out["params"][i] = (w * tpl).astype(out["params"].dtype)
            out["w"][i] = w
            out["losses"][i] = rows[gid]["losses"]
        gids = np.asarray(ids, dtype=np.int64)
        for i, gid in enumerate(int(g) for g in gids):
            row = {k: v[i] for k, v in out.items()}
            self.cache.put_pending(gid, row)
            if self._carry is not None and gid in self._carry:
                self._carry[gid] = row
        self.writeback.enqueue(gids, out, round_no=self._live_round)

    # -- the paged round -------------------------------------------------------

    def _lookup(self, gid: int, carried: dict, fetched: dict):
        if carried is not None:
            row = carried.get(gid)
            if row is not None:
                self.stats.rows_carried += 1
                return row
        row = fetched.get(gid)
        if row is not None:
            self.stats.rows_prefetched += 1
            return row
        row = self.cache.get(gid)
        if row is not None:
            self.stats.rows_cache_hit += 1
        return row

    def _assemble(self, plan: RoundPlan) -> dict:
        """Fill one staging buffer with the closure rows; pad slots become
        inert identity rows (zero params/mom/ef/losses, unit weight)."""
        buf = self._staging[self._buf_i]
        self._buf_i ^= 1
        fetched: dict = {}
        if self._next_fetch is not None:
            t0 = time.perf_counter()
            fetched = self._next_fetch.wait()
            self.stats.prefetch_wait_s += time.perf_counter() - t0
            self.stats.prefetch_busy_s += self._next_fetch.busy_s
            self._next_fetch = None
        carried = self._carry
        misses = []
        self.stats.rows_needed += plan.c
        for s in range(plan.c):
            gid = int(plan.closure[s])
            row = self._lookup(gid, carried, fetched)
            if row is None:
                misses.append((s, gid))
                continue
            for name in self._fields:
                buf[name][s] = row[name]
        if misses:
            self.stats.rows_faulted += len(misses)
            stacked = self.store.read_rows(
                np.asarray([g for _, g in misses], dtype=np.int64)
            )
            for i, (s, gid) in enumerate(misses):
                row = {k: v[i] for k, v in stacked.items()}
                self.cache.put_clean(gid, row)
                for name in self._fields:
                    buf[name][s] = row[name]
        for name in self._fields:
            buf[name][plan.c:] = 1.0 if name == "w" else 0.0
        return buf

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        # A copy on every device: the round updates its state in place,
        # and the staging buffer is reused two rounds later.
        return torch.from_numpy(a).to(self.device, copy=True,
                                      non_blocking=True)

    def _device_state(self, plan: RoundPlan, buf: dict) -> FLState:
        comp = (self._to_device(buf["ef"])
                if self.program.compressor.stateful else ())
        return FLState(
            params=self._to_device(buf["params"]),
            mom=self._to_device(buf["mom"]),
            w=self._to_device(buf["w"]),
            key=plan.ckey_base,
            round=int(plan.t),
            losses=self._to_device(buf["losses"]),
            comp=comp,
            link=(),
        )

    def _plan(self, gen, t: int, draws: dict | None) -> RoundPlan:
        return make_plan(
            self.comm, self.k_active, self.c_max, gen, t,
            live=self._live if self._churn is not None else None,
            draws=draws,
        )

    def run_round(self, draws: dict | None = None) -> dict:
        """One paged round.  ``draws`` may supply the round's ``"perm"`` and
        ``"scores"`` (see :func:`make_plan`) and ``"batch_idx"`` (``(K,
        k_active, B)``, see :meth:`RoundProgram.step_active`)."""
        draws = draws or {}
        plan_draws = {k: draws[k] for k in ("perm", "scores") if k in draws}
        if self._next_plan is not None and not plan_draws:
            plan = self._next_plan
        else:
            self._ensure_live(self._round)
            plan = self._plan(self._key, self._round, plan_draws)
        self._next_plan = None
        live_frac = (
            float((self._live == topology.LIVE).mean())
            if self._churn is not None else 1.0
        )
        buf = self._assemble(plan)
        state = self._device_state(plan, buf)
        slots = ActiveSlots(
            ids=self._to_device(plan.ids.astype(np.int32)),
            idx=self._to_device(plan.idx),
            wgt=self._to_device(plan.wgt),
        )
        active = torch.from_numpy(plan.active).to(self.device)
        data_active = {k: v[active] for k, v in self._data.items()}
        w_in_sum = float(np.asarray(buf["w"][:plan.c], np.float64).sum())
        step_draws = ({"batch_idx": draws["batch_idx"]}
                      if "batch_idx" in draws else None)
        out_state, metrics = self._step(state, slots, data_active,
                                        draws=step_draws)

        # While the device computes: advance churn to round t+1, plan it,
        # and prefetch the rows its closure adds over this round's.
        self._ensure_live(plan.t + 1)
        next_plan = self._plan(plan.key_next, plan.t + 1, None)
        if self.prefetcher is not None:
            new_ids = np.setdiff1d(next_plan.closure, plan.closure)
            self._next_fetch = self.prefetcher.submit(
                new_ids, round_no=plan.t + 1
            )
        self._next_plan = next_plan

        # Block on the round's outputs; one transfer of the compact bank.
        c = plan.c
        out_rows = {
            "params": out_state.params[:c].cpu().numpy(),
            "mom": out_state.mom[:c].cpu().numpy(),
            "w": out_state.w[:c].cpu().numpy(),
            "losses": out_state.losses[:c].cpu().numpy(),
        }
        if self.program.compressor.stateful:
            out_rows["ef"] = out_state.comp[:c].cpu().numpy()
        host_metrics = {k: float(v) for k, v in metrics.items()}
        carried = {}
        for s in range(c):
            gid = int(plan.closure[s])
            row = {k: v[s] for k, v in out_rows.items()}
            carried[gid] = row
            self.cache.put_pending(gid, row)
        self.writeback.enqueue(plan.closure, out_rows, round_no=plan.t)
        self.stats.writeback_rows += c
        self.stats.chunks_written = self.store.chunks_written
        self.stats.io_retries = self.store.io_retries
        self.stats.backoff_seconds = self.store.backoff_seconds
        self.stats.corrupt_chunks = self.store.corrupt_chunks
        self.stats.rebuilt_rows = self.store.rebuilt_rows
        self._carry = carried
        self._key = plan.key_next
        self._round = plan.t + 1
        self.stats.rounds += 1

        w_out_sum = float(np.asarray(out_rows["w"], np.float64).sum())
        rec = dict(host_metrics)
        # The compact operator keeps all closure mass inside the closure,
        # so in == out up to the gather's float accumulation.
        rec["w_mass_closure_err"] = abs(w_out_sum - w_in_sum)
        rec["w_sum"] = w_out_sum
        rec["rows_resident"] = c
        if self._churn is not None:
            rec["live_frac"] = live_frac
        return rec

    def fit(self, rounds: int, log=None) -> list:
        history = []
        for _ in range(rounds):
            rec = {"round": self._round, **self.run_round()}
            history.append(rec)
            if log:
                log(rec)
        return history

    # -- whole-population reductions (streamed over chunks) --------------------

    def flush(self):
        """Drain the write-back queue (every dirty row durable)."""
        self.writeback.flush()

    def total_mass(self) -> float:
        """Exact streaming sum of push-sum weights over all n rows."""
        self.flush()
        return float(self.store.field_sum("w"))

    def mean_params(self) -> np.ndarray:
        """Consensus model row: the population mean of the params bank,
        streamed chunk by chunk."""
        self.flush()
        return (self.store.field_sum("params") / self.n).astype(
            self.store.fields["params"].dtype
        )

    def consensus_error(self) -> float:
        """Mean squared distance of de-biased rows from the bank mean, two
        streaming passes over the store."""
        self.flush()
        mean = self.store.field_sum("params") / self.n
        total = 0.0
        for _, chunk in self.store.iter_chunks(fields=["params", "w"]):
            z = chunk["params"].astype(np.float64) / chunk["w"].astype(
                np.float64)[:, None]
            total += float(((z - mean[None, :]) ** 2).sum())
        return total / self.n

    def eval_population(self, closure_loss: float | None = None) -> dict:
        """Full-population metrics in one streaming pass: mean / max of the
        stored last losses, total push-sum mass, de-biased consensus
        error, and with ``closure_loss`` the population-vs-closure loss
        delta."""
        self.flush()
        mean = self.store.field_sum("params") / self.n
        loss_sum = 0.0
        loss_max = -np.inf
        mass = 0.0
        cons = 0.0
        for _, chunk in self.store.iter_chunks(
            fields=["params", "w", "losses"]
        ):
            losses = chunk["losses"].astype(np.float64)
            loss_sum += float(losses.sum())
            loss_max = max(loss_max, float(losses.max()))
            mass += float(chunk["w"].astype(np.float64).sum())
            z = chunk["params"].astype(np.float64) / chunk["w"].astype(
                np.float64)[:, None]
            cons += float(((z - mean[None, :]) ** 2).sum())
        rec = {
            "pop_loss": loss_sum / self.n,
            "pop_loss_max": loss_max,
            "pop_mass": mass,
            "pop_consensus_error": cons / self.n,
        }
        if closure_loss is not None:
            rec["pop_loss_delta"] = rec["pop_loss"] - float(closure_loss)
        return rec

    def read_rows(self, ids) -> dict:
        """Durable values of ``ids`` (flushes the write-back queue first)."""
        self.flush()
        return self.store.read_rows(np.asarray(ids, dtype=np.int64))

    # -- checkpointing: the checkpoint IS the store ----------------------------

    def save(self) -> str:
        """Commit: flush dirty rows, persist the churn liveness blob, then
        atomically stamp ``(round, key)`` into the manifest.  Returns the
        store path."""
        if self._churn is not None:
            self._ensure_live(self._round)
        self.flush()
        if self._churn is not None:
            self.store.write_blob("churn_live", self._live)
        self.store.update_meta(
            round=self._round, key=_jax_key_words(self._key),
            torch_key=_gen_meta(self._key),
        )
        return self.store.path

    def restore(self, path: str | None = None):
        """Roll back to the last committed manifest: re-read ``(round,
        key)`` and the liveness blob, drop carried / cached rows, and
        delete every chunk generation written since the last ``save()``."""
        if path is not None and os.path.abspath(path) != self.store.path:
            raise ValueError(
                "a paged trainer restores from its own store directory; "
                f"got {path!r}, store is {self.store.path!r}"
            )
        self.flush()
        self.store = ClientStore.open(
            self.store.path, faults=self.store.faults
        )
        self._validate_store()
        self._round = int(self.store.meta["round"])
        self._key = self._committed_key()
        self.cache = RowCache(self.cache.capacity)
        self.writeback.close()
        self.writeback = Writeback(self.store, self.cache)
        if self.prefetcher is not None:
            self.prefetcher.close()
            self.prefetcher = Prefetcher(self.store, self.cache)
        self._carry = None
        self._next_plan = None
        self._next_fetch = None
        self._load_liveness()

    def close(self):
        self.writeback.flush()
        self.writeback.close()
        if self.prefetcher is not None:
            self.prefetcher.close()


def _spec_fingerprint(spec) -> dict:
    m = _spec_meta(spec)
    out = {k: m[k] for k in ("offsets", "shapes", "dtypes", "dim", "dtype")}
    if "delta" in m:
        # A store written at one rank must not open under another.
        out["delta"] = {k: m["delta"][k] for k in ("modes", "ranks")}
    return out


class ResidentDriver:
    """Fully-resident reference for the paged round: identical random
    chain and closure-masked operator, full ``(n, D)`` bank on the
    program's device, dense mixing.  Exists for the paged == resident
    equivalence tests; it materializes everything the pager avoids."""

    def __init__(self, program, k_active: int, *, seed: int = 0,
                 churn: topology.ChurnModel | None = None):
        _check_paged_program(program)
        self.program = program
        self.device = program.device
        self.topo = program.topo
        self.n = program.n
        self.k_active = int(k_active)
        from repro_torch.comm.plan import CommPlan

        self.comm = CommPlan.build(self.topo)
        self.k_in = self.comm.k_in
        self.c_max = self.comm.closure_bound(k_active)
        self._churn = churn if churn is not None and churn.active else None
        self._churn_seed0 = _churn_root(int(seed))
        self._live = np.full((self.n,), topology.LIVE, np.int8)
        row, gen = _root_chain(program, int(seed))
        self._tpl = row.to(self.device)
        D = program.spec.dim
        self.state = FLState(
            params=self._tpl.expand(self.n, D).contiguous(),
            mom=torch.zeros((self.n, D), dtype=torch.float32,
                            device=self.device),
            w=torch.ones((self.n,), dtype=torch.float32, device=self.device),
            key=gen,
            round=0,
            losses=torch.zeros((self.n,), dtype=torch.float32,
                               device=self.device),
            comp=program.compressor.init_state(self.n, D, self.device),
            link=(),
        )
        self._key = gen
        self._round = 0

    def _step(self, state, P, mask, active, ckey_base, draws):
        prog = self.program
        lr = prog.round_lr(state.round)
        data_a = {k: v[active] for k, v in prog.data.items()}
        idx = draws.get("batch_idx")
        if idx is None:
            m = data_a["x"].shape[1]
            idx = torch.randint(
                0, m, (prog.solver.local_steps, active.shape[0],
                       prog.solver.batch_size),
                generator=ckey_base, device=ckey_base.device)
        idx = torch.as_tensor(idx).to(self.device).long()
        Xa, Va, losses, accs = prog.solver.update(
            prog.loss_fn, prog.spec, state.params[active], state.w[active],
            idx, data_a, lr,
        )
        X = state.params.clone()
        X[active] = Xa
        mom = state.mom.clone()
        mom[active] = Va
        # Closure-restricted compression: only transmitting rows compress
        # (and, for EF, commit residuals).
        if isinstance(prog.compressor, IdentityCompressor):
            comp, Xc = state.comp, X
        else:
            comp_new, Xc_all = prog.compressor.apply(state.comp, X)
            Xc = torch.where(mask[:, None], Xc_all, X)
            comp = (torch.where(mask[:, None], comp_new, state.comp)
                    if prog.compressor.stateful else state.comp)
        mixed = pushsum.gossip_bank(P, Xc)
        mixed = _selfloop_correction(P, Xc, X, mixed)
        w_new = pushsum.gossip_weights(P, state.w)
        losses_n = state.losses.clone()
        losses_n[active] = losses
        new_state = FLState(mixed, mom, w_new, state.key, state.round + 1,
                            losses_n, comp, ())
        metrics = {"loss": losses.mean(), "acc": accs.mean(),
                   "w_sum": w_new.sum()}
        return new_state, metrics

    def _advance_churn(self, t: int):
        """The paged runner's churn twin: identical per-round generators,
        identical cold-reset contract, applied to the resident bank."""
        live_new = _transition(self._live, self._churn, self._churn_seed0, t)
        if self._churn.resurrect == "cold":
            reborn = np.nonzero(
                (self._live == topology.DOWN)
                & (live_new == topology.LIVE)
            )[0]
            if reborn.size:
                idx = torch.from_numpy(reborn).to(self.device)
                s = self.state
                params, mom = s.params.clone(), s.mom.clone()
                params[idx] = (s.w[idx][:, None] * self._tpl).to(
                    params.dtype)
                mom[idx] = 0.0
                comp = s.comp
                if self.program.compressor.stateful:
                    comp = comp.clone()
                    comp[idx] = 0.0
                self.state = s._replace(params=params, mom=mom, comp=comp)
        self._live = live_new

    def run_round(self, draws: dict | None = None) -> dict:
        draws = draws or {}
        if self._churn is not None:
            self._advance_churn(self._round)
        plan = make_plan(
            self.comm, self.k_active, self.c_max, self._key, self._round,
            live=self._live if self._churn is not None else None,
            draws={k: draws[k] for k in ("perm", "scores") if k in draws},
        )
        P = torch.from_numpy(paging.dense_partial_operator(
            plan.active, plan.picks, self.n)).to(self.device)
        mask = torch.zeros((self.n,), dtype=torch.bool, device=self.device)
        mask[torch.from_numpy(plan.closure).to(self.device)] = True
        active = torch.from_numpy(plan.active).to(self.device)
        self.state, metrics = self._step(self.state, P, mask, active,
                                         plan.ckey_base, draws)
        self._key = plan.key_next
        self._round = plan.t + 1
        rec = {k: float(v) for k, v in metrics.items()}
        if self._churn is not None:
            rec["live_frac"] = float((self._live == topology.LIVE).mean())
        return rec

    def total_mass(self) -> float:
        return float(self.state.w.double().sum())
