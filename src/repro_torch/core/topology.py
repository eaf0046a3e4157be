"""Communication topologies for decentralized FL — the main-path families of
``repro.core.topology``.

Convention (matches the paper): ``P[i, j]`` is the weight of the directed
link *from client j to client i*; every column of ``P`` sums to 1
(column-stochastic), so ``X' = P @ X`` conserves mass.  Symmetric
baselines use doubly-stochastic Metropolis-Hastings weights.

Every sampler is split in two:

* a **draw** (``draw_uniform``, ``draw_gumbel``, ``draw_permutations``)
  taking the random numbers from the caller's ``torch.Generator``, and
* a **build** (``build_*``): the deterministic top-k and normalisation,
  ported exactly.

``torch`` cannot reproduce ``jax.random`` streams, so the tests hand the
reference's own draws to the builds and compare the operators.  The
neighbor-list form (:class:`NeighborList`) is the fixed-shape ``(n, k_max)``
receiver-side operator the gather kernel consumes, padded with zero-weight
self slots.

The scenario operators follow the same split: :class:`LinkModel` drops
(``draw_drops`` then ``drop_links_dense`` / ``drop_links_neighbors``) and
:class:`ChurnModel` transitions (``draw_churn`` then ``churn_transition``),
with ``churn_links_*`` masking dead nodes out of a sampled operator.

The hierarchical two-tier family (``kind="two_tier"``) has its own
structured operator, :class:`TwoTierOp`: dense push-sum gossip inside each
of ``n_pods`` equal pods of contiguous rows, plus ``k_out`` sparse directed
in-edges from other pods (``draw_uniform`` then ``build_two_tier``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import numpy as np
import torch

__all__ = [
    "TopologyConfig",
    "LinkModel",
    "ChurnModel",
    "LIVE",
    "DOWN",
    "DOWN_PERMANENT",
    "draw_drops",
    "drop_links_dense",
    "drop_links_neighbors",
    "draw_churn",
    "churn_transition",
    "churn_links_dense",
    "churn_links_neighbors",
    "NeighborList",
    "TwoTierOp",
    "build_two_tier",
    "sample_two_tier",
    "dense_from_two_tier",
    "column_stochastic_from_adjacency",
    "metropolis_weights",
    "directed_ring",
    "directed_exponential",
    "exponential_cycle",
    "draw_uniform",
    "draw_gumbel",
    "draw_permutations",
    "build_kout",
    "build_kout_selective",
    "build_symmetric_k_regular",
    "build_kout_neighbors",
    "build_kout_selective_neighbors",
    "build_symmetric_neighbors",
    "sample_kout",
    "sample_kout_selective",
    "sample_symmetric_k_regular",
    "sample_mixing",
    "neighbors_ring",
    "neighbors_exponential",
    "neighbors_exponential_cycle",
    "sample_kout_neighbors",
    "sample_kout_selective_neighbors",
    "sample_symmetric_neighbors",
    "sample_neighbors",
    "family_k_in",
    "neighbor_k_max",
    "dense_from_neighbors",
    "is_column_stochastic",
    "active_k_in",
    "draw_active_scores",
    "build_active_picks",
    "sample_active_picks",
]


@dataclasses.dataclass(frozen=True)
class TopologyConfig:
    """Static description of the communication graph family: kout | ring |
    exponential | symmetric | full | two_tier."""

    kind: str = "kout"
    n_clients: int = 100
    # Number of out-neighbors each client picks (excluding the self-loop).
    # For the two-tier family: the cross-pod in-edges each client draws;
    # gossip inside a pod is dense by construction.
    k_out: int = 10
    time_varying: bool = True
    # Two-tier family only: the clients form n_pods equal pods of
    # contiguous rows, so pods can align with the shards of a row-sharded
    # bank (intra-pod mixing stays on a shard; only the k_out cross-pod
    # edges leave it).
    n_pods: int = 0

    def __post_init__(self):
        if self.k_out >= self.n_clients:
            raise ValueError("k_out must be < n_clients")
        if self.kind == "two_tier":
            if self.n_pods < 2:
                raise ValueError("two_tier topology needs n_pods >= 2")
            if self.n_clients % self.n_pods:
                raise ValueError(
                    "two_tier topology needs n_clients divisible by n_pods"
                )
            ps = self.n_clients // self.n_pods
            if not 1 <= self.k_out <= self.n_clients - ps:
                raise ValueError(
                    "two_tier k_out must be in [1, n_clients - pod_size] "
                    "(every cross-pod edge leaves the receiver's own pod)"
                )
        elif self.n_pods:
            raise ValueError("n_pods is a two_tier-only field")


# ---------------------------------------------------------------------------
# Unreliable links: per-edge drops, bounded delays, event-triggered sends.
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class LinkModel:
    """Per-round unreliable-link effects.

    ``drop``: i.i.d. failure probability per directed non-self edge each
    round, applied to the adjacency before sender normalization, so the
    operator stays exactly column-stochastic (``drop == 1.0`` is the legal
    fully isolated boundary: every node keeps its mass on its self-loop).
    ``delay``: staleness bound B; ``delay >= 1`` swaps in the delayed
    push-sum mixer with its in-flight buffers.  ``event_threshold`` > 0
    swaps in the event-triggered mixer; its round-t threshold is
    ``event_schedule(t)`` when given, else ``event_threshold *
    event_decay ** t``.  All-zero fields mean perfect links.
    """

    drop: float = 0.0
    delay: int = 0
    event_threshold: float = 0.0
    event_decay: float = 1.0
    event_schedule: Any = None

    def __post_init__(self):
        if not 0.0 <= self.drop <= 1.0:
            raise ValueError(
                f"LinkModel.drop must be a probability in [0, 1], got "
                f"{self.drop!r} (drop=1.0 is the fully-isolated boundary: "
                "every node keeps all mass on its self-loop)"
            )
        if self.delay < 0:
            raise ValueError("delay bound must be >= 0")
        if self.event_threshold < 0.0:
            raise ValueError("event_threshold must be >= 0")
        if not 0.0 < self.event_decay <= 1.0:
            raise ValueError("event_decay must be in (0, 1]")
        if self.event_schedule is not None and not callable(
            self.event_schedule
        ):
            raise ValueError("event_schedule must be callable: t -> "
                             "threshold")
        if (self.event_decay != 1.0 or self.event_schedule is not None
                ) and not self.event_threshold:
            raise ValueError(
                "event_decay / event_schedule modulate event-triggered "
                "mixing; set event_threshold > 0 (the schedule's base / "
                "round-0 value) to enable it"
            )
        if self.delay and self.event_threshold:
            raise ValueError(
                "delayed and event-triggered mixing do not compose; "
                "pick one of delay / event_threshold"
            )
        if self.drop and self.event_threshold:
            # One last-broadcast row per sender cannot model a receiver
            # whose link was down when the sender transmitted.
            raise ValueError(
                "event-triggered mixing assumes reliable links (the shared "
                "last-broadcast cache cannot model per-receiver misses); "
                "drop and event_threshold do not compose"
            )

    @property
    def active(self) -> bool:
        return bool(self.drop or self.delay or self.event_threshold)

    def drop_links(self, u: torch.Tensor, P, symmetric: bool = False):
        """This round's link failures applied to ``P`` (dense or
        :class:`NeighborList`), given the round's drop uniforms ``u`` from
        :func:`draw_drops`."""
        if isinstance(P, TwoTierOp):
            raise ValueError(
                "link drops on the two-tier operator form are unsupported "
                "(a dropped cross-pod edge changes every intra-pod weight "
                "of its sender's pod); force gossip='dense' for two_tier + "
                "link scenarios"
            )
        if isinstance(P, NeighborList):
            if symmetric:
                raise ValueError(
                    "link drops on the symmetric neighbor-list form are "
                    "unsupported (per-edge masks cannot be kept consistent "
                    "across both endpoints' fixed-shape lists); force "
                    "gossip='dense'"
                )
            return drop_links_neighbors(u, P, drop=self.drop)
        return drop_links_dense(u, P, drop=self.drop, symmetric=symmetric)


def draw_drops(gen: torch.Generator, P) -> torch.Tensor:
    """The drop draw: one uniform in [0, 1) per entry of the dense operator,
    or per slot of a :class:`NeighborList`."""
    shape = P.idx.shape if isinstance(P, NeighborList) else P.shape
    return torch.rand(tuple(shape), generator=gen, device=gen.device,
                      dtype=torch.float32)


def drop_links_dense(u: torch.Tensor, P: torch.Tensor, drop: float,
                     symmetric: bool = False) -> torch.Tensor:
    """Fail each non-self edge of ``P``'s support where its uniform is below
    ``drop``, then re-normalize from the surviving adjacency (a sender
    divides by its surviving out-degree, self-loop included).  With
    ``symmetric`` one coin per undirected edge (``triu(u, 1)`` mirrored)
    and Metropolis weights on the surviving graph."""
    n = P.shape[0]
    if symmetric:
        u = torch.triu(u, 1)
        u = u + u.T
    adj = ((P > 0) & (u >= drop)).float()
    if symmetric:
        return metropolis_weights(adj * (1.0 - _eye(n, adj.device)))
    return column_stochastic_from_adjacency(adj)


def _renormalize_slots(nl: "NeighborList", live: torch.Tensor):
    """Every live slot of sender j gets ``1 / out_degree(j)``, the degree
    counted over live slots by one scatter-add into ``n + 1`` bins whose
    last bin (dead slots) is dropped."""
    n = nl.idx.shape[0]
    idx = nl.idx.long()
    target = torch.where(live, idx, torch.full_like(idx, n))
    outdeg = torch.zeros(n + 1, dtype=torch.float32, device=idx.device)
    outdeg = outdeg.index_add_(0, target.reshape(-1),
                               torch.ones(target.numel(), device=idx.device))[:n]
    wgt = torch.where(live, 1.0 / outdeg[idx], torch.zeros((), device=idx.device))
    return NeighborList(nl.idx, wgt.float())


def drop_links_neighbors(u: torch.Tensor, nl: "NeighborList",
                         drop: float) -> "NeighborList":
    """Sparse twin of :func:`drop_links_dense` (directed families): each
    real non-self slot fails where its uniform is below ``drop``; slot 0,
    the self-loop, never drops; zero-weight pads stay inert."""
    keep = u >= drop
    keep[:, 0] = True
    return _renormalize_slots(nl, keep & (nl.wgt > 0))


# ---------------------------------------------------------------------------
# Client churn: whole-node failures and recoveries.
# ---------------------------------------------------------------------------

# Liveness codes carried as an (n,) int8 vector in the round state.
LIVE = 1  # participating normally
DOWN = 0  # crashed, may recover with prob recover_prob per round
DOWN_PERMANENT = -1  # crashed for good; never recovers


@dataclasses.dataclass(frozen=True)
class ChurnModel:
    """Per-round whole-client failures and recoveries (node churn).

    Each round every live client fails with ``fail_prob``, permanently with
    probability ``permanent_frac`` given failure; a recoverable down node
    returns with ``recover_prob``.  A dead node leaves the sampled operator
    (all in- and out-edges masked before sender normalization), so its
    column is the identity and its push-sum mass is frozen on its
    self-loop: live + in-flight + frozen dead mass == n.  ``resurrect``:
    ``"warm"`` resumes from the stored row, ``"cold"`` rejoins at the init
    template (``x := w * template``, keeping the mass).  All-zero fields
    mean no churn.
    """

    fail_prob: float = 0.0
    recover_prob: float = 0.0
    permanent_frac: float = 0.0
    resurrect: str = "warm"  # warm | cold

    def __post_init__(self):
        if not 0.0 <= self.fail_prob <= 1.0:
            raise ValueError(
                f"ChurnModel.fail_prob must be a probability in [0, 1], "
                f"got {self.fail_prob!r}"
            )
        if not 0.0 <= self.recover_prob <= 1.0:
            raise ValueError(
                f"ChurnModel.recover_prob must be a probability in [0, 1], "
                f"got {self.recover_prob!r}"
            )
        if not 0.0 <= self.permanent_frac <= 1.0:
            raise ValueError(
                f"ChurnModel.permanent_frac must be a fraction in [0, 1], "
                f"got {self.permanent_frac!r}"
            )
        if self.resurrect not in ("warm", "cold"):
            raise ValueError(
                f"ChurnModel.resurrect must be 'warm' (resume from the "
                f"stored row) or 'cold' (rejoin at the init template), got "
                f"{self.resurrect!r}"
            )
        if self.fail_prob == 0.0 and (
            self.recover_prob or self.permanent_frac
        ):
            raise ValueError(
                "ChurnModel.recover_prob / permanent_frac modulate node "
                "failures; set fail_prob > 0 to enable churn"
            )

    @property
    def active(self) -> bool:
        return bool(self.fail_prob)

    def mask_operator(self, P, alive: torch.Tensor, symmetric: bool = False):
        """Remove every in/out edge of dead nodes from the sampled operator,
        re-normalizing senders over the surviving support."""
        if isinstance(P, TwoTierOp):
            raise ValueError(
                "churn on the two-tier operator form is unsupported (a "
                "dead client changes every intra-pod weight of its pod); "
                "force gossip='dense' for two_tier + churn scenarios"
            )
        if isinstance(P, NeighborList):
            if symmetric:
                raise ValueError(
                    "churn on the symmetric neighbor-list form is "
                    "unsupported (Metropolis degrees cannot be kept "
                    "consistent across both endpoints' fixed-shape "
                    "lists); force gossip='dense'"
                )
            return churn_links_neighbors(P, alive)
        return churn_links_dense(P, alive, symmetric=symmetric)


def draw_churn(gen: torch.Generator, n: int) -> torch.Tensor:
    """The churn draw: (3, n) uniforms in [0, 1) — failure, permanence and
    recovery coins, in that order."""
    return torch.rand((3, n), generator=gen, device=gen.device,
                      dtype=torch.float32)


def churn_transition(u: torch.Tensor, live: torch.Tensor,
                     model: ChurnModel) -> torch.Tensor:
    """One round of the churn Markov chain over liveness codes, from the
    (3, n) draw of :func:`draw_churn`: live nodes fail where ``u[0] <
    fail_prob`` (permanently where also ``u[1] < permanent_frac``),
    recoverable down nodes return where ``u[2] < recover_prob``, permanent
    deaths are absorbing."""
    fails = (live == LIVE) & (u[0] < model.fail_prob)
    perm = fails & (u[1] < model.permanent_frac)
    recovers = (live == DOWN) & (u[2] < model.recover_prob)
    down = torch.where(perm, torch.full_like(live, DOWN_PERMANENT),
                       torch.full_like(live, DOWN))
    nxt = torch.where(fails, down, live)
    nxt = torch.where(recovers, torch.full_like(live, LIVE), nxt)
    return nxt.to(torch.int8)


def churn_links_dense(P: torch.Tensor, alive: torch.Tensor,
                      symmetric: bool = False) -> torch.Tensor:
    """Mask dead nodes out of a dense operator before sender
    normalization: every edge with a dead endpoint goes, self-loops stay,
    so a dead node's column is the identity column."""
    n = P.shape[0]
    a = alive.bool()
    keep = (a[:, None] & a[None, :]) | torch.eye(n, dtype=torch.bool,
                                                 device=P.device)
    adj = ((P > 0) & keep).float()
    if symmetric:
        return metropolis_weights(adj * (1.0 - _eye(n, adj.device)))
    return column_stochastic_from_adjacency(adj)


def churn_links_neighbors(nl: "NeighborList",
                          alive: torch.Tensor) -> "NeighborList":
    """Sparse twin of :func:`churn_links_dense` (directed families): a
    non-self slot survives only when both its sender and its receiver are
    alive; slot 0 always survives; senders re-normalize as in
    :func:`drop_links_neighbors`."""
    a = alive.bool()
    keep = a[:, None] & a[nl.idx.long()]
    keep[:, 0] = True
    return _renormalize_slots(nl, keep & (nl.wgt > 0))


# ---------------------------------------------------------------------------
# Mixing-matrix constructors.
# ---------------------------------------------------------------------------

def _eye(n, device):
    return torch.eye(n, dtype=torch.float32, device=device)


def column_stochastic_from_adjacency(adj: torch.Tensor) -> torch.Tensor:
    """adj[i, j] = 1 iff j sends to i.  Self-loops are forced on.

    Returns the column-stochastic P with P[i, j] = adj[i, j] / out_degree(j).
    """
    n = adj.shape[0]
    adj = torch.maximum(adj.float(), _eye(n, adj.device)).contiguous()
    out_degree = adj.sum(dim=0)
    return adj / out_degree[None, :]


def metropolis_weights(adj: torch.Tensor) -> torch.Tensor:
    """Doubly-stochastic weights for a symmetric adjacency (undirected)."""
    n = adj.shape[0]
    adj = adj.float()
    adj = torch.maximum(adj, adj.T)
    adj = adj * (1.0 - _eye(n, adj.device))
    deg = adj.sum(dim=1)
    denom = 1.0 + torch.maximum(deg[:, None], deg[None, :])
    w = adj / denom
    diag = 1.0 - w.sum(dim=1)
    return w + torch.diag(diag)


def _hops(n: int) -> int:
    return max(int(np.ceil(np.log2(max(n, 2)))), 1)


def directed_ring(n: int, device=None) -> torch.Tensor:
    """Static directed ring: i -> (i+1) mod n."""
    adj = np.eye(n, dtype=np.float32)
    for j in range(n):
        adj[(j + 1) % n, j] = 1.0
    return column_stochastic_from_adjacency(torch.from_numpy(adj).to(device))


def directed_exponential(n: int, t: int = 0, device=None) -> torch.Tensor:
    """One-peer exponential graph (time-varying): i -> i + 2^(t mod log n)."""
    step = 2 ** (t % _hops(n))
    adj = np.eye(n, dtype=np.float32)
    for j in range(n):
        adj[(j + step) % n, j] = 1.0
    return column_stochastic_from_adjacency(torch.from_numpy(adj).to(device))


def exponential_cycle(n: int, device=None) -> torch.Tensor:
    """All ``log2(n)`` one-peer exponential graphs, stacked ``(hops, n, n)``;
    round t uses ``cycle[t % hops]``."""
    return torch.stack(
        [directed_exponential(n, t, device) for t in range(_hops(n))]
    )


# ---------------------------------------------------------------------------
# Draws: the only random part of each sampler.
# ---------------------------------------------------------------------------

def draw_uniform(gen: torch.Generator, n: int) -> torch.Tensor:
    """(n, n) float32 scores, uniform in [0, 1)."""
    return torch.rand((n, n), generator=gen, device=gen.device,
                      dtype=torch.float32)


def draw_gumbel(gen: torch.Generator, n: int) -> torch.Tensor:
    """(n, n) standard Gumbel noise, ``-log(-log(u))`` with u uniform on
    ``[tiny, 1)`` as ``jax.random.gumbel`` draws it."""
    tiny = torch.finfo(torch.float32).tiny
    u = torch.rand((n, n), generator=gen, device=gen.device,
                   dtype=torch.float32).clamp_(min=tiny)
    return -torch.log(-torch.log(u))


def draw_permutations(gen: torch.Generator, n: int, k: int) -> torch.Tensor:
    """(k, n) int64: k independent uniform permutations of range(n)."""
    return torch.stack(
        [torch.randperm(n, generator=gen, device=gen.device) for _ in range(k)]
    )


# ---------------------------------------------------------------------------
# Builds: deterministic functions of a draw, ported exactly.
# ---------------------------------------------------------------------------

def _scatter_adjacency(idx: torch.Tensor, n: int) -> torch.Tensor:
    """adj[r, idx[r, :]] = 1 for every row r."""
    adj = torch.zeros((n, n), dtype=torch.float32, device=idx.device)
    return adj.scatter_(1, idx, 1.0)


def build_kout(scores: torch.Tensor, k: int) -> torch.Tensor:
    """k-out graph from (n, n) uniform scores: sender j sends to the top-k
    scores of row j (self excluded), then column-normalise."""
    n = scores.shape[0]
    scores = scores - 2.0 * _eye(n, scores.device)
    idx = torch.topk(scores, k, dim=1).indices  # receivers per sender
    adj_out = _scatter_adjacency(idx, n)  # adj_out[j, i] = j sends to i
    return column_stochastic_from_adjacency(adj_out.T)


def _selective_logits(losses: torch.Tensor, gumbel: torch.Tensor,
                      temp: float) -> torch.Tensor:
    n = losses.shape[0]
    losses = losses.float()
    diff = torch.abs(losses[:, None] - losses[None, :]) / temp
    return diff - 1e9 * _eye(n, losses.device) + gumbel


def build_kout_selective(gumbel: torch.Tensor, losses: torch.Tensor, k: int,
                         temp: float = 1.0) -> torch.Tensor:
    """DFedSGPSM-S neighbor selection (paper Eq. 2): sender i picks k
    out-neighbors by Gumbel-top-k over ``|f_i - f_j| / temp``."""
    n = losses.shape[0]
    idx = torch.topk(_selective_logits(losses, gumbel, temp), k, dim=1).indices
    return column_stochastic_from_adjacency(_scatter_adjacency(idx, n).T)


def build_symmetric_k_regular(scores: torch.Tensor, k: int) -> torch.Tensor:
    """Random undirected graph with ~k neighbors each; Metropolis weights."""
    n = scores.shape[0]
    scores = torch.triu(scores, 1)
    scores = scores + scores.T - 2.0 * _eye(n, scores.device)
    idx = torch.topk(scores, k, dim=1).indices
    adj = _scatter_adjacency(idx, n)
    return metropolis_weights(torch.maximum(adj, adj.T))


def sample_kout(gen: torch.Generator, n: int, k: int) -> torch.Tensor:
    """Each client picks k distinct out-neighbors uniformly (plus self)."""
    return build_kout(draw_uniform(gen, n), k)


def sample_kout_selective(gen: torch.Generator, losses: torch.Tensor, n: int,
                          k: int, temp: float = 1.0) -> torch.Tensor:
    return build_kout_selective(draw_gumbel(gen, n), losses, k, temp)


def sample_symmetric_k_regular(gen: torch.Generator, n: int,
                               k: int) -> torch.Tensor:
    return build_symmetric_k_regular(draw_uniform(gen, n), k)


def sample_mixing(gen: torch.Generator, cfg: TopologyConfig, t: int = 0,
                  losses: torch.Tensor | None = None) -> torch.Tensor:
    """Sample the round-t mixing matrix for the configured family."""
    n, k, dev = cfg.n_clients, cfg.k_out, gen.device
    if cfg.kind == "ring":
        return directed_ring(n, dev)
    if cfg.kind == "exponential":
        return directed_exponential(n, t if cfg.time_varying else 0, dev)
    if cfg.kind == "full":
        return torch.full((n, n), 1.0 / n, dtype=torch.float32, device=dev)
    if cfg.kind == "symmetric":
        return sample_symmetric_k_regular(gen, n, k)
    if cfg.kind == "two_tier":
        return dense_from_two_tier(sample_two_tier(gen, n, cfg.n_pods, k))
    if cfg.kind == "kout":
        if losses is not None:
            return sample_kout_selective(gen, losses, n, k)
        return sample_kout(gen, n, k)
    raise ValueError(f"unknown topology kind: {cfg.kind}")


# ---------------------------------------------------------------------------
# Neighbor-list (sparse) representation.
# ---------------------------------------------------------------------------

class NeighborList(NamedTuple):
    """Receiver-side sparse mixing operator, fixed shape ``(n, k_max)``:
    ``X'[i] = sum_l wgt[i, l] * X[idx[i, l]]``.  Slot 0 is the self-loop;
    padding slots point back at ``i`` with weight 0."""

    idx: torch.Tensor  # (n, k_max) int32 sender indices
    wgt: torch.Tensor  # (n, k_max) float32 mixing weights


def dense_from_neighbors(nl: NeighborList, n: int) -> torch.Tensor:
    """Densify: P[i, idx[i, l]] += wgt[i, l] (duplicates accumulate)."""
    P = torch.zeros((n, n), dtype=torch.float32, device=nl.wgt.device)
    return P.scatter_add_(1, nl.idx.long(), nl.wgt.float())


def _shift_neighbors(n: int, step: int, device) -> NeighborList:
    i = torch.arange(n, dtype=torch.int32, device=device)
    idx = torch.stack([i, (i - step) % n], dim=1).to(torch.int32)
    return NeighborList(idx, torch.full((n, 2), 0.5, dtype=torch.float32,
                                        device=device))


def neighbors_ring(n: int, device=None) -> NeighborList:
    """Static directed ring in neighbor form — exactly :func:`directed_ring`."""
    return _shift_neighbors(n, 1, device)


def neighbors_exponential(n: int, t: int = 0, device=None) -> NeighborList:
    """One-peer exponential graph in neighbor form — exactly
    :func:`directed_exponential`."""
    return _shift_neighbors(n, 2 ** (t % _hops(n)), device)


def neighbors_exponential_cycle(n: int, device=None) -> NeighborList:
    """All ``log2(n)`` exponential graphs stacked ``(hops, n, 2)``."""
    nls = [neighbors_exponential(n, t, device) for t in range(_hops(n))]
    return NeighborList(torch.stack([nl.idx for nl in nls]),
                        torch.stack([nl.wgt for nl in nls]))


def _kin_weights(picks: torch.Tensor, n: int) -> NeighborList:
    """Column-stochastic weights for receiver-side picks: sender j's
    out-degree is its pick count plus its self-loop, and every edge from j
    carries ``1 / out_degree(j)``."""
    i = torch.arange(n, dtype=torch.int32, device=picks.device)
    outdeg = torch.bincount(picks.reshape(-1).long(), minlength=n).float() + 1.0
    idx = torch.cat([i[:, None], picks.to(torch.int32)], dim=1)
    return NeighborList(idx, 1.0 / outdeg[idx.long()])


def build_kout_neighbors(scores: torch.Tensor, k: int) -> NeighborList:
    """Sparse twin of :func:`build_kout`, k-in orientation: receiver i picks
    the top-k scores of row i (self excluded) as its in-neighbors."""
    n = scores.shape[0]
    scores = scores - 2.0 * _eye(n, scores.device)
    picks = torch.topk(scores, k, dim=1).indices
    return _kin_weights(picks, n)


def build_kout_selective_neighbors(gumbel: torch.Tensor, losses: torch.Tensor,
                                   k: int, temp: float = 1.0) -> NeighborList:
    """Sparse twin of :func:`build_kout_selective`: the receiver picks its k
    most loss-divergent in-neighbors by Gumbel-top-k."""
    n = losses.shape[0]
    picks = torch.topk(_selective_logits(losses, gumbel, temp), k,
                       dim=1).indices
    return _kin_weights(picks, n)


def build_symmetric_neighbors(perms: torch.Tensor) -> NeighborList:
    """Undirected graph from ``k`` permutation matchings (node i links to
    ``pi_t(i)`` and ``pi_t^{-1}(i)``), Metropolis weights with
    multiplicity; ``pi_t(i) = i`` self-hits are zero-weight pads.  Shape
    ``(n, 2k + 1)``."""
    perms = perms.long()
    n = perms.shape[1]
    invs = torch.argsort(perms, dim=1)
    nbrs = torch.cat([perms.T, invs.T], dim=1)
    i = torch.arange(n, device=perms.device)
    nonself = (nbrs != i[:, None]).float()
    deg = nonself.sum(dim=1)
    w = nonself / (1.0 + torch.maximum(deg[:, None], deg[nbrs]))
    idx = torch.cat([i[:, None], nbrs], dim=1).to(torch.int32)
    wgt = torch.cat([1.0 - w.sum(dim=1, keepdim=True), w], dim=1)
    return NeighborList(idx, wgt.float())


def sample_kout_neighbors(gen: torch.Generator, n: int, k: int) -> NeighborList:
    return build_kout_neighbors(draw_uniform(gen, n), k)


def sample_kout_selective_neighbors(gen: torch.Generator, losses: torch.Tensor,
                                    n: int, k: int,
                                    temp: float = 1.0) -> NeighborList:
    return build_kout_selective_neighbors(draw_gumbel(gen, n), losses, k, temp)


def sample_symmetric_neighbors(gen: torch.Generator, n: int,
                               k: int) -> NeighborList:
    return build_symmetric_neighbors(draw_permutations(gen, n, k))


def family_k_in(cfg: TopologyConfig, mixer_kind: str = "directed") -> int:
    """The maximum number of distinct non-self senders any receiver reads
    under a topology family (a symmetric mixer samples the matching family,
    degree bound ``2 * k_out``)."""
    if mixer_kind == "symmetric" or cfg.kind == "symmetric":
        return 2 * cfg.k_out
    if cfg.kind == "two_tier":
        return cfg.n_clients // cfg.n_pods - 1 + cfg.k_out
    if cfg.kind in ("ring", "exponential"):
        return 1
    if cfg.kind == "full":
        return cfg.n_clients - 1
    if cfg.kind == "kout":
        return cfg.k_out
    raise ValueError(f"unknown topology kind: {cfg.kind}")


def neighbor_k_max(cfg: TopologyConfig, mixer_kind: str = "directed") -> int:
    """Static ``k_max`` of the neighbor-list form: slot-0 self + in-edges."""
    return family_k_in(cfg, mixer_kind) + 1


def sample_neighbors(gen: torch.Generator, cfg: TopologyConfig, t: int = 0,
                     losses: torch.Tensor | None = None) -> NeighborList:
    """Sample the round-t operator in neighbor-list form — the sparse twin of
    :func:`sample_mixing` (a :class:`TwoTierOp` for the two-tier family)."""
    n, k, dev = cfg.n_clients, cfg.k_out, gen.device
    if cfg.kind == "ring":
        return neighbors_ring(n, dev)
    if cfg.kind == "exponential":
        return neighbors_exponential(n, t if cfg.time_varying else 0, dev)
    if cfg.kind == "full":
        raise ValueError("the full graph has no sparse neighbor-list form")
    if cfg.kind == "symmetric":
        return sample_symmetric_neighbors(gen, n, k)
    if cfg.kind == "two_tier":
        return sample_two_tier(gen, n, cfg.n_pods, k)
    if cfg.kind == "kout":
        if losses is not None:
            return sample_kout_selective_neighbors(gen, losses, n, k)
        return sample_kout_neighbors(gen, n, k)
    raise ValueError(f"unknown topology kind: {cfg.kind}")


# ---------------------------------------------------------------------------
# Active-set (partial participation) in-neighbor sampling: the paged round.
# ---------------------------------------------------------------------------

_ACTIVE_KINDS = ("ring", "exponential", "kout", "two_tier")


def active_k_in(cfg: TopologyConfig) -> int:
    """Static per-receiver in-degree of :func:`sample_active_picks`: a paged
    round's fault-in closure is at most ``k_active * (active_k_in + 1)``
    rows.  The value is :func:`family_k_in`; only the family restriction is
    paging's own."""
    if cfg.kind in _ACTIVE_KINDS:
        return family_k_in(cfg)
    raise ValueError(
        f"topology kind {cfg.kind!r} has no active-set (paged) form: the "
        "symmetric family needs consistent masks on both endpoints and "
        "the full graph faults in everything"
    )


def draw_active_scores(gen: torch.Generator, m: int, n: int) -> torch.Tensor:
    """The ``kout`` and ``two_tier`` families' draw for ``m`` active
    receivers: ``(m, n)`` float32 scores, uniform in [0, 1)."""
    return torch.rand((m, n), generator=gen, device=gen.device,
                      dtype=torch.float32)


def build_active_picks(active, cfg: TopologyConfig, t: int = 0,
                       scores: torch.Tensor | None = None) -> torch.Tensor:
    """In-neighbors of the round's active receivers, as **global** row ids,
    ``(k_active, active_k_in(cfg))`` int32 — the exact build of
    :func:`sample_active_picks` from its draw.  Ring and exponential are
    deterministic hops (``t`` drives the time-varying hop ``2^(t mod
    log2 n)``); ``kout`` takes the top ``k_out`` of each receiver's
    ``scores`` row after subtracting 2 at its own column; ``two_tier``
    lists the receiver's pod-mates (its in-pod offsets rotated so that
    itself drops out), then the top ``k_out`` of its ``scores`` row after
    subtracting 2 over its own pod."""
    n, k = cfg.n_clients, cfg.k_out
    a = torch.as_tensor(active).long()
    if cfg.kind == "ring":
        return ((a - 1) % n)[:, None].to(torch.int32)
    if cfg.kind == "exponential":
        step = 2 ** (t % _hops(n)) if cfg.time_varying else 1
        return ((a - step) % n)[:, None].to(torch.int32)
    if cfg.kind == "kout":
        if scores is None:
            raise ValueError("the kout family's picks need its scores")
        scores = torch.as_tensor(scores).float().clone()
        a = a.to(scores.device)
        rows = torch.arange(a.shape[0], device=scores.device)
        scores[rows, a] = scores[rows, a] + (-2.0)
        return torch.topk(scores, k, dim=1).indices.to(torch.int32)
    if cfg.kind == "two_tier":
        if scores is None:
            raise ValueError("the two_tier family's picks need its scores")
        scores = torch.as_tensor(scores).float()
        a = a.to(scores.device)
        ps = n // cfg.n_pods
        pod = a // ps
        off = (a % ps)[:, None] + 1 + torch.arange(ps - 1,
                                                   device=a.device)[None, :]
        mates = pod[:, None] * ps + off % ps
        same = pod[:, None] == (torch.arange(n, device=a.device) // ps)[None, :]
        cross = torch.topk(scores - 2.0 * same.float(), k, dim=1).indices
        return torch.cat([mates, cross], dim=1).to(torch.int32)
    raise ValueError(
        f"topology kind {cfg.kind!r} has no active-set (paged) form"
    )


def sample_active_picks(gen: torch.Generator, active, cfg: TopologyConfig,
                        t: int = 0, scores=None) -> torch.Tensor:
    """:func:`build_active_picks` on a fresh draw from ``gen`` (``kout`` and
    ``two_tier``; ``scores`` supplies the draw instead)."""
    active_k_in(cfg)
    if cfg.kind in ("kout", "two_tier") and scores is None:
        scores = draw_active_scores(gen, len(active), cfg.n_clients)
    return build_active_picks(active, cfg, t=t, scores=scores)


# ---------------------------------------------------------------------------
# Hierarchical two-tier family: dense push-sum gossip inside each pod,
# sparse directed k_out edges between pods.
# ---------------------------------------------------------------------------

class TwoTierOp(NamedTuple):
    """Structured operator of the two-tier family.

    ``intra`` holds the ``(n_pods, ps, ps)`` dense pod blocks: block p mixes
    the contiguous rows ``[p*ps, (p+1)*ps)``, so where a row-sharded bank's
    shards hold whole pods the intra mix never leaves its shard.  ``inter``
    is a :class:`NeighborList` of each receiver's ``k_out`` cross-pod
    in-edges (slot 0 the self slot at weight 0: the self-loop lives on the
    intra diagonal); it is the only term that crosses shards.  A sender j
    with ``c_j`` external receivers has out-degree ``ps + c_j`` and every
    one of its edges carries ``1 / (ps + c_j)``, so the densified sum
    (:func:`dense_from_two_tier`) is exactly column-stochastic.
    """

    intra: torch.Tensor  # (n_pods, ps, ps) float32 pod-block weights
    inter: NeighborList  # (n, k_out + 1) cross-pod edges


def build_two_tier(scores: torch.Tensor, n_pods: int, k: int) -> TwoTierOp:
    """The two-tier operator from (n, n) uniform scores: receiver i takes
    the top-k scores of row i outside its own pod (same-pod scores pushed
    down by 2) as its cross-pod senders; every sender's out-degree is its
    pod plus its count of external picks (one global scatter-count)."""
    n = scores.shape[0]
    ps = n // n_pods
    dev = scores.device
    i = torch.arange(n, dtype=torch.int32, device=dev)
    pod = i // ps
    same = (pod[:, None] == pod[None, :]).float()
    picks = torch.topk(scores - 2.0 * same, k, dim=1).indices
    outdeg = ps + torch.bincount(picks.reshape(-1), minlength=n).float()
    idx = torch.cat([i[:, None], picks.to(torch.int32)], dim=1)
    wgt = torch.cat([torch.zeros((n, 1), dtype=torch.float32, device=dev),
                     1.0 / outdeg[picks]], dim=1)
    intra = (1.0 / outdeg).reshape(n_pods, 1, ps).expand(n_pods, ps, ps)
    return TwoTierOp(intra.contiguous(), NeighborList(idx, wgt.contiguous()))


def sample_two_tier(gen: torch.Generator, n: int, n_pods: int,
                    k: int) -> TwoTierOp:
    """Each client receives from its whole pod plus k distinct senders of
    other pods, drawn uniformly."""
    return build_two_tier(draw_uniform(gen, n), n_pods, k)


def dense_from_two_tier(op: TwoTierOp) -> torch.Tensor:
    """Densify: the block-diagonal intra weights plus the scattered inter
    edges — the (n, n) matrix the structured operator equals."""
    return (torch.block_diag(*op.intra)
            + dense_from_neighbors(op.inter, op.inter.idx.shape[0]))


def is_column_stochastic(P, atol: float = 1e-5) -> bool:
    P = np.asarray(P.detach().cpu() if isinstance(P, torch.Tensor) else P)
    return bool(
        np.all(P >= -atol) and np.allclose(P.sum(axis=0), 1.0, atol=atol)
    )

