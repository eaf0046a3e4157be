"""`CommPlan`: which remote rows does each consumer shard read? — the port
of ``repro.comm.plan``, its single-host part.

DFedSGPSM's gossip is row-sparse by construction: receiver i reads only its
``k_in`` in-neighbors.  The same in-neighbor sets size the sharded mix's
halo, the backend dispatch rule and the store's fault-in planner;
:class:`CommPlan` is the one host-side object they derive from, built per
``(TopologyConfig, n_shards, mixer_kind)`` from the shared in-degree table
:func:`repro_torch.core.topology.family_k_in`.

Ported here: :meth:`CommPlan.build` with its static shift legs (ring /
exponential) and its traffic accounting, which are numpy, the store-facing
side (:attr:`CommPlan.pageable`, :meth:`CommPlan.closure_bound`,
:meth:`CommPlan.in_neighbors`) that the paged round plans from, and the
mesh-aware executor rule :func:`resolve_backend` with the halo executor's
:class:`HaloBackend` (its transport is
``repro_torch.kernels.gossip_gather.gossip_gather_halo``).
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np

from repro_torch.core import topology
from repro_torch.core.topology import NeighborList, TopologyConfig, TwoTierOp

__all__ = ["CommPlan", "HaloBackend", "ShiftLeg", "resolve_backend"]


class ShiftLeg(NamedTuple):
    """One static halo transfer: every shard p sends its local rows at
    ``offsets`` to shard ``p + delta (mod n_shards)`` — the uniform
    shard-pair pattern of a shift-structured (ring / exponential)
    neighbor graph."""

    delta: int
    offsets: tuple  # sender-local row offsets, sorted


def _shift_legs(idx: np.ndarray, wgt: np.ndarray,
                n_shards: int) -> Optional[tuple]:
    """Extract the per-shard-distance legs of a concrete NeighborList, or
    ``None`` when the cross-shard pattern is not uniform over pairs at the
    same distance (then only the dynamic transport is exact)."""
    n, k = idx.shape
    m = n // n_shards
    per = [[set() for _ in range(n_shards)] for _ in range(n_shards)]
    for i in range(n):
        d = i // m
        for l in range(k):
            if wgt[i, l] == 0.0:
                continue
            j = int(idx[i, l])
            p = j // m
            if p != d:
                per[d][p].add(j % m)
    legs = []
    for delta in range(1, n_shards):
        sets = [per[d][(d - delta) % n_shards] for d in range(n_shards)]
        if all(not s for s in sets):
            continue
        if any(s != sets[0] for s in sets):
            return None
        legs.append(ShiftLeg(delta, tuple(sorted(sets[0]))))
    return tuple(legs)


def _merge_legs(leg_sets) -> tuple:
    """Union per-delta offset sets over several static plans (the
    exponential-cycle hops) into one covering plan."""
    union: dict[int, set] = {}
    for legs in leg_sets:
        for leg in legs:
            union.setdefault(leg.delta, set()).update(leg.offsets)
    return tuple(
        ShiftLeg(d, tuple(sorted(offs))) for d, offs in sorted(union.items())
    )


@dataclasses.dataclass(frozen=True)
class CommPlan:
    """The communication plan (see module docstring).  All fields are
    static host data; ``legs`` is non-empty exactly when the family has a
    uniform shift structure and there is more than one shard."""

    topo: TopologyConfig
    mixer_kind: str
    n_shards: int
    m: int            # rows per shard
    k_in: int         # family_k_in — THE shared per-family in-degree
    k_max: int        # neighbor-list slot count, always k_in + 1
    static: bool      # True: exact ShiftLeg transport covers every round
    legs: tuple       # (ShiftLeg, ...) when static, else ()
    capacity: int     # per-pair row capacity of the dynamic transport

    @classmethod
    def build(cls, topo: TopologyConfig, n_shards: int = 1,
              mixer_kind: str = "directed") -> "CommPlan":
        n = topo.n_clients
        if n_shards < 1 or n % n_shards:
            raise ValueError(
                f"n_clients={n} must be divisible by n_shards={n_shards}"
            )
        m = n // n_shards
        k_in = topology.family_k_in(topo, mixer_kind)
        k_max = k_in + 1
        static_family = (
            mixer_kind != "symmetric"
            and topo.kind in ("ring", "exponential")
        )
        legs: tuple = ()
        if n_shards == 1:
            # Everything is shard-local: the empty static plan.
            return cls(topo, mixer_kind, 1, m, k_in, k_max, True, (), 0)
        if static_family:
            if topo.kind == "ring":
                nls = [topology.neighbors_ring(n)]
            elif topo.time_varying:
                hops = max(int(np.ceil(np.log2(max(n, 2)))), 1)
                nls = [topology.neighbors_exponential(n, t)
                       for t in range(hops)]
            else:
                nls = [topology.neighbors_exponential(n, 0)]
            per_hop = [
                _shift_legs(np.asarray(nl.idx), np.asarray(nl.wgt), n_shards)
                for nl in nls
            ]
            if all(lg is not None for lg in per_hop):
                legs = _merge_legs(per_hop)
                return cls(topo, mixer_kind, n_shards, m, k_in, k_max,
                           True, legs, 0)
        # Dynamic transport: per shard pair at most the sender's whole m
        # rows can be distinct requests, whatever the sampled realization.
        return cls(topo, mixer_kind, n_shards, m, k_in, k_max, False, (), m)

    # -- traffic accounting (per shard, per mixing application) -------------

    def halo_rows(self) -> int:
        """Remote bank rows received per shard per mix: the exact leg sizes
        on the static path, the fixed (n_shards-1) * capacity payload on
        the dynamic one (zero-padded slots included — physical traffic)."""
        if self.n_shards == 1:
            return 0
        if self.static:
            return sum(len(leg.offsets) for leg in self.legs)
        return (self.n_shards - 1) * self.capacity

    def request_ints(self) -> int:
        """int32 row-request words received per shard per mix (the dynamic
        transport's index traffic; the static plan ships none)."""
        if self.static or self.n_shards == 1:
            return 0
        return (self.n_shards - 1) * self.capacity

    def halo_bytes(self, d: int, itemsize: int = 4) -> int:
        """Bytes received per shard per mix on the halo path."""
        return self.halo_rows() * d * itemsize + self.request_ints() * 4

    def allgather_rows(self) -> int:
        """Remote rows received per shard by the full-bank all-gather the
        ``"xla"`` executor lowers to — the baseline the halo replaces."""
        return (self.n_shards - 1) * self.m

    def allgather_bytes(self, d: int, itemsize: int = 4) -> int:
        return self.allgather_rows() * d * itemsize

    # -- measured (realization-level) row sets -------------------------------

    def shard_remote_rows(self, nl: NeighborList, shard: int) -> np.ndarray:
        """Distinct remote global rows ``shard``'s receivers read under the
        concrete operator ``nl`` — the exact halo a zero-waste transport
        would ship (sorted; host numpy)."""
        idx = np.asarray(nl.idx)
        wgt = np.asarray(nl.wgt)
        lo, hi = shard * self.m, (shard + 1) * self.m
        rows = idx[lo:hi][wgt[lo:hi] != 0.0]
        return np.unique(rows[(rows < lo) | (rows >= hi)])

    def measured_rows(self, P) -> dict:
        """Mean/max distinct remote rows per shard under a concrete sampled
        operator (``NeighborList`` or ``TwoTierOp`` — only the inter list
        of the latter crosses shards when pods align with shards)."""
        nl = P.inter if isinstance(P, TwoTierOp) else P
        counts = [
            self.shard_remote_rows(nl, s).size for s in range(self.n_shards)
        ]
        return {
            "rows_mean": float(np.mean(counts)),
            "rows_max": int(np.max(counts)),
        }

    # -- the store-facing side: the fault-in closure -------------------------

    @property
    def pageable(self) -> bool:
        """Whether the family has an active-set (paged) form — the same
        restriction ``topology.active_k_in`` enforces."""
        return (
            self.mixer_kind == "directed"
            and self.topo.kind in ("ring", "exponential", "kout", "two_tier")
        )

    def closure_bound(self, k_active: int) -> int:
        """Static resident-row bound of a paged round's fault-in closure
        ``active ∪ in_neighbors(active)`` — ``k_in`` is this plan's shared
        table entry, the arithmetic lives in ``repro_torch.store.paging``."""
        if not self.pageable:
            raise ValueError(
                f"topology kind {self.topo.kind!r} has no active-set "
                "(paged) form: the symmetric family needs consistent masks "
                "on both endpoints and the full graph faults in everything"
            )
        from repro_torch.store import paging

        return paging.closure_bound(self.topo.n_clients, k_active, self.k_in)

    def in_neighbors(self, gen, active, t: int = 0, scores=None):
        """Global in-neighbor ids of the given active receivers for round
        ``t`` — the rows the pager faults in beyond the active set, drawn
        from the same per-family samplers the full-bank round uses
        (:func:`repro_torch.core.topology.sample_active_picks`).
        ``scores`` supplies the ``kout`` family's uniform draw instead of
        ``gen``."""
        return topology.sample_active_picks(gen, active, self.topo, t=t,
                                            scores=scores)


class HaloBackend(NamedTuple):
    """The halo executor's selection, carried as the mixers' ``backend``
    down to :func:`repro_torch.kernels.gossip_gather.gossip_gather_halo`."""

    mesh: object  # torch.distributed.device_mesh.DeviceMesh
    axis: str  # the bank-row mesh axis ("clients")
    plan: CommPlan


GOSSIP_MODES = ("auto", "sparse", "dense", "xla", "halo")


def check_gossip(gossip: str) -> None:
    """Refuse a ``gossip`` value that is none of :data:`GOSSIP_MODES`."""
    if gossip not in GOSSIP_MODES:
        raise ValueError(
            f"gossip must be {'|'.join(GOSSIP_MODES)}, got {gossip!r}"
        )


def resolve_backend(gossip: str, sparse_mix: bool, topo: TopologyConfig,
                    mixer_kind: str, mesh=None, shard_axis: str = "clients"):
    """The executor dispatch rule — dense / sparse kernel / all-gather /
    halo — with the reference's decisions case for case.  Returns the
    mixers' ``backend``:

      * ``None``: the kernels on the bank at hand (only without a mesh);
      * ``"xla"``: the all-gather executor (the reference's name: its
        whole-bank form, which GSPMD lowers to one all-gather of the bank);
        without a mesh the same kernels, no collective;
      * :class:`HaloBackend`: the halo exchange, shipping the plan's rows.

    Without a mesh nothing is sharded: ``"xla"`` stays forceable and
    ``"halo"`` is refused.  Under a mesh the dense form and ``"xla"`` take
    the all-gather; ``"halo"`` forces the halo exchange for any family;
    ``"auto"`` / ``"sparse"`` take it exactly when the plan is static (ring,
    exponential) with more than one shard, else the all-gather.
    """
    from repro_torch.launch.mesh import mesh_axis_names, mesh_axis_size

    check_gossip(gossip)
    if mesh is None or shard_axis not in mesh_axis_names(mesh):
        if gossip == "halo":
            raise ValueError(
                "gossip='halo' is the sharded halo-exchange executor; it "
                "needs a mesh with the bank-row axis"
            )
        return "xla" if gossip == "xla" else None
    if not sparse_mix:
        return "xla"
    n_shards = mesh_axis_size(mesh, shard_axis)
    plan = CommPlan.build(topo, n_shards, mixer_kind)
    if gossip == "halo":
        return HaloBackend(mesh, shard_axis, plan)
    if gossip == "xla":
        return "xla"
    if plan.static and n_shards > 1:
        return HaloBackend(mesh, shard_axis, plan)
    return "xla"
