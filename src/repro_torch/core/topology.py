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
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

__all__ = [
    "TopologyConfig",
    "NeighborList",
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
]


@dataclasses.dataclass(frozen=True)
class TopologyConfig:
    """Static description of the communication graph family (main-path
    families: kout | ring | exponential | symmetric | full)."""

    kind: str = "kout"
    n_clients: int = 100
    # Number of out-neighbors each client picks (excluding the self-loop).
    k_out: int = 10
    time_varying: bool = True

    def __post_init__(self):
        if self.k_out >= self.n_clients:
            raise ValueError("k_out must be < n_clients")
        if self.kind not in ("kout", "ring", "exponential", "symmetric",
                             "full"):
            raise ValueError(
                f"topology kind {self.kind!r} is not ported yet "
                "(two_tier comes with the sharding slice)"
            )


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
    :func:`sample_mixing`."""
    n, k, dev = cfg.n_clients, cfg.k_out, gen.device
    if cfg.kind == "ring":
        return neighbors_ring(n, dev)
    if cfg.kind == "exponential":
        return neighbors_exponential(n, t if cfg.time_varying else 0, dev)
    if cfg.kind == "full":
        raise ValueError("the full graph has no sparse neighbor-list form")
    if cfg.kind == "symmetric":
        return sample_symmetric_neighbors(gen, n, k)
    if cfg.kind == "kout":
        if losses is not None:
            return sample_kout_selective_neighbors(gen, losses, n, k)
        return sample_kout_neighbors(gen, n, k)
    raise ValueError(f"unknown topology kind: {cfg.kind}")


def is_column_stochastic(P, atol: float = 1e-5) -> bool:
    P = np.asarray(P.detach().cpu() if isinstance(P, torch.Tensor) else P)
    return bool(
        np.all(P >= -atol) and np.allclose(P.sum(axis=0), 1.0, atol=atol)
    )

