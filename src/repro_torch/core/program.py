"""The round program: ``init`` / ``step`` over a (solver, compressor, mixer)
stage composition on the flat bank — the port of ``repro.core.program``.

    state           = program.init(generator)   # FLState
    state, metrics  = program.step(state)        # one communication round
    state, history  = program.run(state, rounds)

PyTorch runs eagerly, so ``run`` and ``run_superstep`` are Python loops;
the eval cadence of ``run_superstep`` keys on the global round counter, as
the reference's in-scan eval does.  Randomness comes from the state's
``torch.Generator``; the link and churn scenarios draw from generators of
their own.  ``step(state, draws=...)`` takes a round's draws from the
caller instead — the mixing operator, the minibatch indices, the selected
clients of central algorithms, the drop uniforms, delays and churn coins —
which is how the tests replay the reference's own ``jax.random`` draws.

With ``mesh=`` the bank is row-sharded over the ``"clients"`` axis of a
``torch.distributed`` device mesh, one rank a shard: each rank holds its
``n / world`` contiguous rows of every bank-row leaf and the client data,
and runs the same program on them (SPMD).  Every rank makes each draw whole
from the same generator and keeps its rows, so a sharded run equals the
unsharded one round for round; the mix crosses ranks through the executor
``comm.plan.resolve_backend`` picks, and the reported metrics are computed
from every rank's rows.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple

import torch
from torch.func import vmap

from repro_torch.core import topology
from repro_torch.core.flat import (
    BoundDeltaSpec,
    DeltaConfig,
    bind_delta_spec,
    make_delta_spec,
    make_spec,
)
from repro_torch.core.stages import (
    ChurnState,
    DelayedPushSumMixer,
    EventTriggeredMixer,
    IdentityCompressor,
    LinkState,
    comm_phase,
    make_stages,
)
from repro_torch.kernels import ops as kops

__all__ = ["FLState", "ActiveSlots", "RoundProgram", "make_program",
           "plan_keys"]


def plan_keys(gen: torch.Generator):
    """The paged round's random chain: one split of the round's generator
    into ``(key_next, akey, tkey, ckey_base)`` — next round's generator,
    the active-set permutation's, the topology picks' and the one the
    active clients' minibatches are drawn from.  Four seeds are drawn from
    a copy of ``gen`` (which is left as it was, as a JAX key is) and each
    seeds a fresh generator on ``gen``'s device.  The host planner and the
    fully-resident driver both derive from exactly this chain, which makes
    paged == resident testable draw for draw."""
    copy = torch.Generator(device=gen.device)
    copy.set_state(gen.get_state())
    seeds = torch.randint(0, 1 << 62, (4,), generator=copy,
                          device=gen.device).tolist()
    return tuple(torch.Generator(device=gen.device).manual_seed(int(s))
                 for s in seeds)


class ActiveSlots(NamedTuple):
    """Device-side view of one paged round's fault-in closure.

    ``ids[s]`` is the global client id resident in compact slot ``s``
    (layout ``[active | cold | pads]``).  ``idx`` / ``wgt`` are the
    compact-slot NeighborList of the closure-restricted mixing operator
    built by :func:`repro_torch.store.paging.build_plan`."""

    ids: torch.Tensor  # (c_max,) int32 global ids per resident slot
    idx: torch.Tensor  # (c_max, 1 + k_in) int32 compact in-neighbor slots
    wgt: torch.Tensor  # (c_max, 1 + k_in) float32 mixing weights


class FLState(NamedTuple):
    """Round state: everything the next round reads."""

    params: Any  # (n, D) bank, or the (D,) central row; a dict on flat=False
    mom: Any  # (n, D) float32 end-of-round momentum bank (None on central)
    w: torch.Tensor  # (n,) push-sum weights (all-ones when unused)
    key: torch.Generator  # the program's random stream
    round: int
    losses: torch.Tensor  # (n,) last local losses (drives selection)
    comp: Any = ()  # compressor state (the top-k EF residual bank)
    link: Any = ()  # stages.LinkState on linked programs
    churn: Any = ()  # stages.ChurnState on churned programs


# Tags that derive the link and churn streams from the main stream's seed
# (the reference folds its seed key with the same constants).
LINK_STREAM = 0x11AB
CHURN_STREAM = 0x0C4B


def _fold_generator(gen: torch.Generator, tag: int) -> torch.Generator:
    """A generator of its own for one scenario stream, seeded from ``gen``'s
    seed and ``tag`` without drawing from ``gen``: programs without that
    scenario keep their main stream bit for bit."""
    seed = (gen.initial_seed() + (tag << 32)) % (1 << 64)
    return torch.Generator(device=gen.device).manual_seed(seed)


def _as_device(x, device):
    if isinstance(x, topology.TwoTierOp):
        return topology.TwoTierOp(
            torch.as_tensor(x.intra, device=device).float(),
            _as_device(x.inter, device))
    if isinstance(x, topology.NeighborList):
        return topology.NeighborList(
            torch.as_tensor(x.idx, device=device).to(torch.int32),
            torch.as_tensor(x.wgt, device=device).float(),
        )
    return torch.as_tensor(x, device=device)


def _is_empty(x) -> bool:
    return isinstance(x, tuple) and len(x) == 0


@dataclasses.dataclass(frozen=True)
class RoundProgram:
    """One federated-optimization algorithm as a stage composition."""

    solver: Any
    compressor: Any
    mixer: Any
    loss_fn: Callable
    init_fn: Callable
    data: dict  # client-stacked tensors, leading dims (n_clients, m, ...)
    topo: topology.TopologyConfig
    spec: Any  # BankSpec, or BoundDeltaSpec for the delta bank
    n: int
    participation: float
    lr: float
    lr_decay: float
    selection: bool
    # (hops, n, n) dense, or a stacked (hops, n, 2) NeighborList.
    exp_cycle: Any
    gossip: str
    sparse_mix: bool
    device: torch.device
    # Unreliable-link scenario (None: perfect links, the plain round bit
    # for bit); ``linked`` threads ``state.link`` through the round.
    link: Any = None
    linked: bool = False
    # Node-churn scenario (None: immortal clients, the plain round).
    churn_model: Any = None
    # Row-sharded bank: this rank's
    # :class:`~repro_torch.launch.sharding.RowShard` (None: one device).
    shard: Any = None

    @property
    def churned(self) -> bool:
        return self.churn_model is not None

    # -- state constructor ----------------------------------------------------

    def init_row(self, gen: torch.Generator) -> torch.Tensor:
        """The broadcast initial bank row: the ravelled ``init_fn(gen)``
        model, or the delta bank's init row (zero deltas, LoRA ``A``
        factors drawn from ``gen``) — every client starts at the base."""
        if isinstance(self.spec, BoundDeltaSpec):
            return self.spec.init_row(gen).to(self.device)
        return self.spec.ravel(self.init_fn(gen)).to(self.device)

    def init(self, gen: torch.Generator) -> FLState:
        """Initial state: one row from ``gen`` broadcast to every client;
        ``gen`` then drives every later round.  The link and churn streams
        are generators of their own (:func:`_fold_generator`).  On a sharded
        bank each rank makes its own rows of that state."""
        rows = self.n if self.shard is None else self.shard.m
        w0 = self.mixer.init_weights(rows, self.device)
        losses0 = torch.zeros((rows,), dtype=torch.float32,
                              device=self.device)
        if self.mixer.kind == "central":
            row = self.spec.ravel(self.init_fn(gen)).to(self.device)
            return FLState(row, None, w0, gen, 0, losses0, ())
        row = self.init_row(gen)
        bank = row.expand(rows, self.spec.dim).contiguous()
        mom = torch.zeros((rows, self.spec.dim), dtype=torch.float32,
                          device=self.device)
        comp = self.compressor.init_state(rows, self.spec.dim, self.device)
        link = ()
        if self.linked:
            link = LinkState(key=_fold_generator(gen, LINK_STREAM),
                             **self.mixer.link_buffers(bank))
        churn = ()
        if self.churned:
            churn = ChurnState(
                key=_fold_generator(gen, CHURN_STREAM),
                live=torch.full((rows,), topology.LIVE, dtype=torch.int8,
                                device=self.device),
                tpl=row if self.churn_model.resurrect == "cold" else (),
            )
        return FLState(bank, mom, w0, gen, 0, losses0, comp, link, churn)

    # -- the row-sharded bank --------------------------------------------------

    def shard_state(self, state: FLState) -> FLState:
        """This rank's rows of every bank-row leaf of a whole ``state`` (the
        random streams, the round and the cold template stay whole).
        Identity on one device and for central algorithms, so callers
        compose through it unconditionally; ``FLTrainer.restore`` routes a
        loaded checkpoint through it, so a resumed run is sharded from its
        first round."""
        if self.shard is None or self.mixer.kind == "central":
            return state
        return self.shard.state_rows(state)

    def whole_state(self, state: FLState) -> FLState:
        """The whole ``state`` from every rank's rows (the inverse of
        :meth:`shard_state`; every rank gets it)."""
        if self.shard is None or self.mixer.kind == "central":
            return state
        return self.shard.state_whole(state)

    def _whole(self, x, lead: int = 0):
        return x if self.shard is None else self.shard.all_gather(x, lead)

    def _rows(self, x, lead: int = 0):
        return x if self.shard is None else self.shard.rows(x, lead)

    # -- random draws ---------------------------------------------------------

    def mixing_matrix(self, gen: torch.Generator, state: FLState):
        """The round's operator: a dense (n, n) matrix, or a NeighborList
        when the density rule picked the sparse representation."""
        k = self.topo.k_out
        if self.sparse_mix:
            if self.mixer.kind == "symmetric":
                return topology.sample_symmetric_neighbors(gen, self.n, k)
            if self.selection:
                return topology.sample_kout_selective_neighbors(
                    gen, state.losses, self.n, k
                )
            if self.exp_cycle is not None:
                t = state.round % self.exp_cycle.idx.shape[0]
                return topology.NeighborList(
                    self.exp_cycle.idx[t], self.exp_cycle.wgt[t]
                )
            return topology.sample_neighbors(gen, self.topo, t=0)
        if self.mixer.kind == "symmetric":
            return topology.sample_symmetric_k_regular(gen, self.n, k)
        if self.selection:
            return topology.sample_kout_selective(gen, state.losses, self.n, k)
        if self.exp_cycle is not None:
            return self.exp_cycle[state.round % self.exp_cycle.shape[0]]
        return topology.sample_mixing(gen, self.topo, t=0)

    def _batch_idx(self, gen, rows: int):
        m = self.data["x"].shape[1]
        return torch.randint(
            0, m, (self.solver.local_steps, rows, self.solver.batch_size),
            generator=gen, device=self.device,
        )

    def round_lr(self, r: int) -> float:
        """``lr * lr_decay ** r`` in float32, as the reference computes it."""
        f32 = torch.float32
        lr = torch.tensor(self.lr, dtype=f32) * (
            torch.tensor(self.lr_decay, dtype=f32) ** torch.tensor(r, dtype=f32)
        )
        return float(lr)

    # -- one communication round ----------------------------------------------

    def step(self, state: FLState, draws: dict | None = None):
        """One round.  ``draws`` may supply the round's random numbers:
        ``"P"`` (matrix or NeighborList), ``"batch_idx"`` ((K, rows, B)
        minibatch indices), for central algorithms ``"sel"`` (the sampled
        clients), and for the scenarios ``"churn"`` ((3, n) uniforms of
        :func:`topology.draw_churn`), ``"drop"`` (the drop uniforms of
        :func:`topology.draw_drops`) and ``"delay"`` (the delays of
        :func:`stages.draw_delays`).  Whatever is missing is drawn: P and
        the minibatches from ``state.key``, drops and delays from
        ``state.link.key``, the churn coins from ``state.churn.key``."""
        draws = draws or {}
        lr = self.round_lr(state.round)
        if self.mixer.kind == "central":
            return self._central_step(state, lr, draws)
        P = draws.get("P")
        if P is None:
            # Loss-selective sampling reads every client's last loss.
            seen = (state._replace(losses=self._whole(state.losses))
                    if self.selection else state)
            P = self.mixing_matrix(state.key, seen)
        else:
            P = _as_device(P, self.device)
        idx = draws.get("batch_idx")
        idx = (self._batch_idx(state.key, self.n) if idx is None
               else _as_device(idx, self.device).long())
        idx = self._rows(idx, 1)

        # Node churn resolves first: this round's liveness decides who
        # trains and whose edges survive.  A node down this round neither
        # trains nor communicates; its row and mass freeze on the self-loop.
        alive = None
        params0, mom0, comp0 = state.params, state.mom, state.comp
        if self.churned:
            u = draws.get("churn")
            u = (topology.draw_churn(state.churn.key, self.n) if u is None
                 else _as_device(u, self.device))
            live_new = topology.churn_transition(self._rows(u, 1),
                                                 state.churn.live,
                                                 self.churn_model)
            alive = live_new == topology.LIVE
            if self.churn_model.resurrect == "cold":
                # A node rejoining this round restarts at the init template
                # in de-biased coordinates: x := w * template keeps its
                # frozen mass w; momentum and residual rows are zeroed.
                reborn = ((state.churn.live == topology.DOWN)
                          & (live_new == topology.LIVE))[:, None]
                params0 = torch.where(
                    reborn,
                    (state.w[:, None] * state.churn.tpl).to(params0.dtype),
                    params0)
                mom0 = torch.where(reborn, 0.0, mom0)
                if not _is_empty(comp0):
                    comp0 = torch.where(reborn, 0.0, comp0)
        X, V, losses, accs = self.solver.update(
            self.loss_fn, self.spec, params0, state.w, idx, self.data, lr
        )
        if self.churned:
            # Dead nodes did not train: rows, momentum and last losses
            # carry through untouched.
            al = alive[:, None]
            X = torch.where(al, X, params0)
            V = torch.where(al, V, mom0)
            losses = torch.where(alive, losses, state.losses)
            # Dead nodes leave the operator wholesale (masked before
            # sender normalization); link drops then fail surviving edges.
            P = self.churn_model.mask_operator(
                P, self._whole(live_new) == topology.LIVE,
                symmetric=self.mixer.kind == "symmetric")
        X, w_new, comp, link, extras = comm_phase(
            self.compressor, self.mixer, P, X, state.w, comp0, state.link,
            linked=self.linked, link_model=self.link,
            symmetric=self.mixer.kind == "symmetric", t=state.round,
            draws=draws,
        )
        churn = state.churn
        if self.churned:
            churn = ChurnState(state.churn.key, live_new, state.churn.tpl)
        new_state = FLState(X, V, w_new, state.key, state.round + 1, losses,
                            comp, link, churn)
        if self.shard is not None:
            # The metrics of every rank's rows, computed as on one device.
            losses, accs, w_new = (self._whole(x) for x in (losses, accs,
                                                            w_new))
            if self.churned:
                alive = self._whole(live_new) == topology.LIVE
        if self.churned:
            n_live = alive.sum().clamp(min=1).float()
            zero = torch.zeros((), dtype=torch.float32, device=self.device)
            metrics = {
                "loss": torch.where(alive, losses, zero).sum() / n_live,
                "acc": torch.where(alive, accs, zero).sum() / n_live,
                **extras,
                "live_frac": alive.float().mean(),
                # Mass frozen on dead nodes' self-loops: the third term of
                # live + in-flight + frozen == n.
                "dead_mass": torch.where(alive, zero, w_new).sum(),
            }
        else:
            metrics = {"loss": losses.mean(), "acc": accs.mean(), **extras}
        if self.linked or self.churned:
            # Total push-sum mass, in-flight shares included.
            inflight = (self._whole(link.bufw, 1).sum() if self.linked
                        and not _is_empty(link.bufw)
                        else torch.zeros((), device=self.device))
            metrics["w_mass"] = w_new.sum() + inflight
        return new_state, metrics

    def _central_step(self, state: FLState, lr: float, draws: dict):
        m = max(int(self.participation * self.n), 1)
        sel = draws.get("sel")
        sel = (torch.randperm(self.n, generator=state.key,
                              device=self.device)[:m]
               if sel is None else _as_device(sel, self.device).long())
        idx = draws.get("batch_idx")
        idx = (self._batch_idx(state.key, m) if idx is None
               else _as_device(idx, self.device).long())
        data_sel = {k: v[sel] for k, v in self.data.items()}
        Xrep = state.params.expand(m, self.spec.dim).contiguous()
        ones = torch.ones((m,), dtype=torch.float32, device=self.device)
        X, _, losses, accs = self.solver.update(
            self.loss_fn, self.spec, Xrep, ones, idx, data_sel, lr
        )
        new_losses = state.losses.clone()
        new_losses[sel] = losses
        new_state = FLState(self.mixer.reduce(X), state.mom, state.w,
                            state.key, state.round + 1, new_losses, state.comp,
                            state.link)
        return new_state, {"loss": losses.mean(), "acc": accs.mean()}

    # -- one paged round on the compact resident bank ---------------------------

    def step_active(self, state: FLState, slots: ActiveSlots, data_active,
                    *, k_active: int, draws: dict | None = None):
        """One communication round over a **compact** ``(c_max, D)`` bank —
        the paged twin of :meth:`step`.

        ``state`` is the resident state: every bank leaf holds only the
        round's fault-in closure (layout ``[active | cold | pads]``, see
        :mod:`repro_torch.store.paging`), ``state.key`` is the round's
        ``ckey_base`` from :func:`plan_keys`, and ``state.link`` is ``()``.
        Only the first ``k_active`` rows train (their minibatch indices
        ``draws["batch_idx"]``, ``(K, k_active, B)``, else drawn from
        ``state.key``); the mix runs :func:`comm_phase` over the
        slot-remapped NeighborList in ``slots``.  The active rows of
        ``state.params``, ``state.mom`` and ``state.losses`` are updated in
        place."""
        draws = draws or {}
        lr = self.round_lr(state.round)
        idx = draws.get("batch_idx")
        if idx is None:
            m = data_active["x"].shape[1]
            gen = state.key
            idx = torch.randint(
                0, m, (self.solver.local_steps, k_active,
                       self.solver.batch_size),
                generator=gen, device=gen.device)
        idx = _as_device(idx, self.device).long()
        Xa, Va, losses, accs = self.solver.update(
            self.loss_fn, self.spec, state.params[:k_active],
            state.w[:k_active], idx, data_active, lr,
        )
        X = state.params
        X[:k_active] = Xa
        mom = state.mom
        if mom is not None:
            mom[:k_active] = Va
        P = topology.NeighborList(slots.idx, slots.wgt)
        Xm, w_new, comp, _, extras = comm_phase(
            self.compressor, self.mixer, P, X, state.w, state.comp, (),
            t=state.round,
        )
        losses_res = state.losses
        losses_res[:k_active] = losses
        new_state = FLState(Xm, mom, w_new, state.key, state.round + 1,
                            losses_res, comp, ())
        # w_sum counts every resident slot; the runner reports the closure's
        # own mass.
        metrics = {"loss": losses.mean(), "acc": accs.mean(),
                   "w_sum": w_new.sum(), **extras}
        return new_state, metrics

    # -- whole runs ------------------------------------------------------------

    def run(self, state: FLState, rounds: int):
        """``rounds`` steps; returns (state, metrics stacked per round)."""
        return self.run_superstep(state, rounds)

    def make_eval_fn(self, test_data: dict, batch: int = 1024):
        """``eval_fn(state) -> (test_loss, test_acc)`` of the consensus model:
        the mean of per-example metrics over the whole test set, each example
        evaluated on its own (vmapped), as the reference does."""
        test = {k: torch.as_tensor(v, device=self.device)
                for k, v in test_data.items()}
        n = test["x"].shape[0]

        def eval_fn(state: FLState):
            row = (state.params if self.mixer.kind == "central"
                   else self._whole(state.params).mean(dim=0))
            params = self.spec.unravel(row)

            def one(x, y):
                return self.loss_fn(params, {"x": x[None], "y": y[None]})

            tl = torch.zeros((), dtype=torch.float32, device=self.device)
            ta = torch.zeros((), dtype=torch.float32, device=self.device)
            with torch.no_grad():
                for i in range(0, n, batch):
                    per_l, per_a = vmap(one)(test["x"][i:i + batch],
                                             test["y"][i:i + batch])
                    tl = tl + per_l.sum()
                    ta = ta + per_a.sum()
            return tl / n, ta / n

        return eval_fn

    def run_superstep(self, state: FLState, rounds: int, eval_every: int = 0,
                      test_data=None, eval_batch: int = 1024):
        """``rounds`` rounds, evaluating on ``test_data`` whenever the global
        round counter (after the step) is a multiple of ``eval_every``.

        Returns ``(state, history)``: every history entry is stacked
        ``(rounds,)``; with eval on, ``test_loss`` / ``test_acc`` hold zeros
        where the boolean ``eval_mask`` is false."""
        eval_fn = (self.make_eval_fn(test_data, eval_batch)
                   if test_data is not None and eval_every else None)
        hist: dict[str, list] = {}
        zero = torch.zeros((), dtype=torch.float32, device=self.device)
        for _ in range(rounds):
            state, metrics = self.step(state)
            if eval_fn is not None:
                do = state.round % eval_every == 0
                tl, ta = eval_fn(state) if do else (zero, zero)
                metrics = dict(metrics, test_loss=tl, test_acc=ta,
                               eval_mask=torch.tensor(do, device=self.device))
            for k, v in metrics.items():
                hist.setdefault(k, []).append(v)
        return state, {k: torch.stack(v) for k, v in hist.items()}


def make_program(
    loss_fn: Callable,
    init_fn: Callable,
    client_data,
    algo,
    topo: topology.TopologyConfig,
    participation: float = 0.1,
    gossip: str = "auto",
    link: topology.LinkModel | None = None,
    churn: topology.ChurnModel | None = None,
    mesh=None,
    shard_axis: str = "clients",
    delta: DeltaConfig | int | str | None = None,
    bank_dtype: torch.dtype | None = None,
    device="cuda",
) -> RoundProgram:
    """Compose an ``AlgoConfig`` into a :class:`RoundProgram` on ``device``.

    ``gossip`` picks the mixing-operator representation and, with a mesh,
    the executor, through :func:`repro_torch.comm.plan.resolve_backend`:
    ``"auto"`` applies the density rule
    :func:`repro_torch.kernels.ops.use_sparse_gossip` to the family's
    static ``k_max``; ``"sparse"`` / ``"dense"`` force the neighbor-list or
    the dense sampler; ``"xla"`` forces the sparse form on the all-gather
    executor; ``"halo"`` (mesh required) the sparse form on the halo
    exchange, which ships only each shard's ``CommPlan`` rows.  Under a
    mesh, ``"auto"`` / ``"sparse"`` take the halo exchange for the static
    shift families (ring, exponential) and the all-gather otherwise.

    ``mesh`` (a 1-D ``torch.distributed`` ``DeviceMesh`` with axis
    ``shard_axis``, :func:`repro_torch.launch.mesh.make_clients_mesh`)
    row-shards the round over its ranks: the bank rows and the client data
    are split along the axis, each rank running the program on its rows.
    ``None`` is the one-device program.

    ``link`` (:class:`topology.LinkModel`) degrades the links: edge drops,
    bounded delays (the delayed mixer) or event-triggered sends (the
    event-triggered mixer).  ``churn`` (:class:`topology.ChurnModel`)
    crashes and revives whole clients.  ``None`` or an all-zero model
    builds the plain round, bit for bit.  ``delta`` (a
    :class:`~repro_torch.core.flat.DeltaConfig`, or a rank / ``"full"``)
    banks per-client adapter rows over a frozen base drawn once here from
    ``init_fn`` with ``delta.base_seed``; ``bank_dtype`` overrides the bank
    rows' dtype (momentum and the EF residual stay float32).

    On CUDA this turns TF32 off for matmuls and convolutions, as the
    reference computes in full float32.
    """
    # comm.plan imports repro_torch.core: a module-level import would cycle.
    from repro_torch.comm.plan import check_gossip, resolve_backend

    device = torch.device(device)
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    solver, compressor, mixer = make_stages(algo)
    if topo.kind == "two_tier":
        if mixer.kind != "directed":
            raise ValueError(
                "the two-tier family is directed push-sum gossip only; "
                f"comm={algo.comm!r} has no two-tier form"
            )
        if algo.selection:
            raise ValueError(
                "loss-selective neighbor sampling has no two-tier form; "
                "disable selection for kind='two_tier'"
            )
    link = link if link is not None and link.active else None
    if link is not None:
        if mixer.kind == "central":
            raise ValueError(
                "the central (server) round has no peer links to degrade; "
                "drop the link model for comm='central'"
            )
        if mixer.kind != "directed" and (link.delay or link.event_threshold):
            raise ValueError(
                "delayed / event-triggered mixing is push-sum (directed) "
                f"only, not comm={algo.comm!r}; symmetric gossip supports "
                "link drops alone"
            )
        if link.delay:
            mixer = DelayedPushSumMixer(delay=link.delay)
        elif link.event_threshold:
            mixer = EventTriggeredMixer(
                threshold=link.event_threshold,
                decay=link.event_decay,
                schedule=link.event_schedule,
            )
    churn = churn if churn is not None and churn.active else None
    if churn is not None:
        if mixer.kind == "central":
            raise ValueError(
                "the central (server) round has no peer population to "
                "churn; drop churn= for comm='central'"
            )
        if link is not None and link.event_threshold:
            raise ValueError(
                "event-triggered mixing assumes immortal senders (the "
                "shared last-broadcast cache cannot model a crashed "
                "transmitter); churn and event_threshold do not compose"
            )
    if mixer.kind == "central" and not isinstance(compressor,
                                                   IdentityCompressor):
        raise ValueError(
            "central (server) rounds do not model compressed communication; "
            f"drop compressor={algo.compressor!r}/quantize_gossip"
        )
    check_gossip(gossip)
    if mixer.kind == "central":
        sparse_mix = False
    elif gossip in ("sparse", "xla", "halo"):
        if topo.kind == "full":
            raise ValueError("the full graph has no sparse neighbor-list form")
        sparse_mix = True
    elif gossip == "dense":
        sparse_mix = False
    else:
        sparse_mix = kops.use_sparse_gossip(
            topo.n_clients, topology.neighbor_k_max(topo, mixer.kind), device
        )
    if (link is not None and link.drop > 0 and sparse_mix
            and mixer.kind == "symmetric"):
        raise ValueError(
            "link drops on the symmetric neighbor-list form are "
            "unsupported; pass gossip='dense' for symmetric + drops"
        )
    if (link is not None and link.drop > 0 and sparse_mix
            and topo.kind == "two_tier"):
        raise ValueError(
            "link drops on the two-tier operator form are unsupported; "
            "pass gossip='dense' for two_tier + drops"
        )
    if churn is not None and sparse_mix and mixer.kind == "symmetric":
        raise ValueError(
            "churn on the symmetric neighbor-list form is unsupported; "
            "pass gossip='dense' for symmetric + churn"
        )
    if churn is not None and sparse_mix and topo.kind == "two_tier":
        raise ValueError(
            "churn on the two-tier operator form is unsupported; "
            "pass gossip='dense' for two_tier + churn"
        )
    data = {k: torch.as_tensor(v, device=device) for k, v in client_data.items()}
    shard = None
    if mesh is not None:
        from repro_torch.launch.sharding import RowShard, check_row_mesh

        check_row_mesh(mesh, shard_axis, topo.n_clients)
        if mixer.kind == "central":
            raise ValueError(
                "the central (server) round keeps one global row — there "
                "is no client bank to shard; drop the mesh"
            )
        shard = RowShard(mesh, shard_axis, topo.n_clients)
        # Client-stacked data rows live with their bank rows.
        data = {k: shard.rows(v) for k, v in data.items()}
    if mixer.kind != "central":
        backend = resolve_backend(gossip, sparse_mix, topo, mixer.kind, mesh,
                                  shard_axis)
        if backend is not None or shard is not None:
            mixer = dataclasses.replace(mixer, backend=backend, shard=shard)
    # Leaf shapes and dtypes only: one model on the CPU.
    shape_tree = init_fn(torch.Generator().manual_seed(0))
    if delta is not None:
        if not isinstance(delta, DeltaConfig):
            delta = DeltaConfig(rank=delta)
        if mixer.kind == "central":
            raise ValueError(
                "the central (server) round keeps one global row — there "
                "are no per-client deltas to bank; drop delta= for "
                "comm='central'"
            )
        dspec = make_delta_spec(shape_tree, rank=delta.rank,
                                adapt=delta.adapt, dtype=bank_dtype)
        if dspec.dim == 0:
            raise ValueError(
                f"delta adapt={delta.adapt!r} selected no leaves: every "
                "client would be frozen at the base model"
            )
        # The frozen shared base is materialized exactly once, here.
        base = init_fn(torch.Generator(device=device).manual_seed(
            delta.base_seed))
        spec = bind_delta_spec(dspec, base)
    else:
        spec = make_spec(shape_tree, dtype=bank_dtype)
    exp_cycle = None
    if topo.kind == "exponential" and topo.time_varying:
        exp_cycle = (
            topology.neighbors_exponential_cycle(topo.n_clients, device)
            if sparse_mix
            else topology.exponential_cycle(topo.n_clients, device)
        )
    return RoundProgram(
        solver=solver,
        compressor=compressor,
        mixer=mixer,
        loss_fn=loss_fn,
        init_fn=init_fn,
        data=data,
        topo=topo,
        spec=spec,
        n=topo.n_clients,
        participation=participation,
        lr=algo.lr,
        lr_decay=algo.lr_decay,
        selection=algo.selection,
        exp_cycle=exp_cycle,
        gossip=gossip,
        sparse_mix=sparse_mix,
        device=device,
        link=link,
        linked=link is not None or mixer.link_stateful,
        churn_model=churn,
        shard=shard,
    )
