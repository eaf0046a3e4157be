"""Composable round stages on the flat ``(n, D)`` bank — the port of
``repro.core.stages``:

  LocalSolver   Algorithm 1 lines 4-11: K local steps, each a two-pass SAM
                gradient vmapped over the bank rows (``torch.func``) and one
                fused momentum/descent/de-bias kernel call on the whole bank;
                the proximal solver adds a FedProx pull ``mu (X - X0)``.
  Compressor    what leaves a client before communication: identity,
                per-row int8 quantize/dequantize, or top-k with error
                feedback (a float32 residual bank carried in the state).
  Mixer         lines 12-14: push-sum over a directed column-stochastic
                operator, doubly-stochastic symmetric gossip, push-sum over
                links with bounded delays or event-triggered sends, or a
                central server reduce.

Every mixer keeps client i's own contribution at full precision —
``X'[i] = P[ii]·X_full[i] + sum_{j != i} P[ij]·X[j]`` — because the
self-loop is local memory, not a network link.

Randomness arrives as explicit draws: minibatch indices drawn by the round
program, drop uniforms and delay draws from the link stream
(``LinkState.key``, a ``torch.Generator``), or replayed from the reference.

Every mixer carries the reference's ``backend`` (the executor of
``comm.plan.resolve_backend``) and, on a row-sharded bank, ``shard`` (a
``launch.sharding.RowShard``): the operator is the whole round's, the bank,
the weights and the link buffers are this rank's rows, and the extras a
mixer reports are reduced over every rank's rows.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import torch
from torch.func import vmap

from repro_torch.core import pushsum, topology
from repro_torch.core.sam import sam_gradient
from repro_torch.kernels import ops as kops

__all__ = [
    "SamMomentumSolver",
    "ProximalSolver",
    "IdentityCompressor",
    "Int8RowCompressor",
    "TopKEFCompressor",
    "LinkState",
    "ChurnState",
    "PushSumMixer",
    "SymmetricMixer",
    "DelayedPushSumMixer",
    "EventTriggeredMixer",
    "CentralMixer",
    "SOLVERS",
    "COMPRESSORS",
    "MIXERS",
    "draw_delays",
    "make_stages",
    "comm_phase",
]


def _sample_batch(data: dict, idx: torch.Tensor) -> dict:
    """Each client's minibatch: rows ``idx[i]`` (B,) of client i's data,
    for ``idx`` of shape (n, B) and client-stacked data (n, m, ...)."""
    rows = torch.arange(idx.shape[0], device=idx.device)[:, None]
    return {k: v[rows, idx] for k, v in data.items()}


# ---------------------------------------------------------------------------
# LocalSolver: (X, w, batch_idx, data, lr) -> (X, V, losses, accs).
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SamMomentumSolver:
    """Algorithm 1 lines 4-11 for all clients at once.  ``rho = 0`` degrades
    to a single gradient pass, ``alpha = 0`` to plain SGD (the momentum bank
    stays the zero operand of the kernel)."""

    local_steps: int = 5
    batch_size: int = 32
    rho: float = 0.0
    alpha: float = 0.0

    def _grad_one(self, loss_fn, spec):
        def grad_one(x_i, w_i, bx, by):
            # Line 5 de-bias fused into the unravel; lines 6-8 SAM.
            z_tree = spec.debias(x_i, w_i)
            g_tree, (loss, acc) = sam_gradient(
                loss_fn, z_tree, {"x": bx, "y": by}, self.rho
            )
            return g_tree, loss, acc

        return vmap(grad_one)

    def _pull(self, G, X, X0):
        """The local objective's extra gradient term on the bank (none)."""
        return G

    def update(self, loss_fn, spec, X, w, batch_idx, data, lr):
        """``batch_idx`` is (local_steps, n, batch_size): the minibatch rows
        of each client at each local step."""
        grads = self._grad_one(loss_fn, spec)
        X0 = X  # round-start bank, constant through the local steps
        V0 = torch.zeros_like(X, dtype=torch.float32)
        V = V0
        losses, accs = [], []
        for k in range(self.local_steps):
            batch = _sample_batch(data, batch_idx[k])
            G_tree, loss_k, acc_k = grads(X, w, batch["x"], batch["y"])
            G = self._pull(spec.ravel_grad_stacked(G_tree, X), X, X0)
            if self.alpha == 0.0:
                # Momentum off: v' = g exactly, V0 stays the zero operand.
                X, _, _ = kops.fused_update_bank(X, V0, G, 0.0, lr, w)
            else:
                X, V, _ = kops.fused_update_bank(X, V, G, self.alpha, lr, w)
            losses.append(loss_k)
            accs.append(acc_k)
        return (X, V, torch.stack(losses).mean(dim=0),
                torch.stack(accs).mean(dim=0))


@dataclasses.dataclass(frozen=True)
class ProximalSolver(SamMomentumSolver):
    """FedProx-style local objective f_i(x) + (mu/2) ||x - x_round||^2 (Li
    et al. 2020), applied on the bank: ``G += mu (X - X0)`` with X0 the
    round-start bank, so it composes with any mixer.  At ``alpha == 0`` it
    takes the same zero-momentum fast path as :class:`SamMomentumSolver`."""

    mu: float = 0.01

    def _pull(self, G, X, X0):
        return G + self.mu * (X - X0).to(G.dtype)


# ---------------------------------------------------------------------------
# Compressor: init_state(n, d) -> state; apply(state, X) -> (state, X').
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class IdentityCompressor:
    """No-op communication stage (full-precision gossip)."""

    stateful = False

    def init_state(self, n: int, d: int, device=None):
        return ()

    def apply(self, state, X):
        return state, X


@dataclasses.dataclass(frozen=True)
class Int8RowCompressor:
    """Int8 symmetric quantization with one scale per client row:
    ``scale = max|row| / 127 + 1e-12``, codes ``round(x / scale)`` (half to
    even) clipped to [-127, 127]."""

    stateful = False

    def init_state(self, n: int, d: int, device=None):
        return ()

    def apply(self, state, X):
        Xf = X.float()
        scale = Xf.abs().amax(dim=1, keepdim=True) / 127.0 + 1e-12
        q = torch.clamp(torch.round(Xf / scale), -127, 127)
        return state, (q * scale).to(X.dtype)


@dataclasses.dataclass(frozen=True)
class TopKEFCompressor:
    """Per-row top-k sparsification with error feedback (Stich et al. 2018).

    The residual of what was dropped rides a float32 ``(n, D)`` state bank
    and is added back before the next top-k: ``compressed + residual' == X
    + residual`` exactly, the residual taken against the bank-dtype payload
    so bf16 rounding is fed back too.  ``k = max(int(ratio * D), 1)``; every
    coordinate whose magnitude reaches the k-th largest is kept (ties
    included)."""

    ratio: float = 0.05
    stateful = True

    def init_state(self, n: int, d: int, device=None):
        return torch.zeros((n, d), dtype=torch.float32, device=device)

    def apply(self, state, X):
        y = X.float() + state
        k = max(int(self.ratio * y.shape[1]), 1)
        mag = y.abs()
        kth = torch.topk(mag, k, dim=1, sorted=True).values[:, -1:]
        Xc = (y * (mag >= kth)).to(X.dtype)
        return y - Xc.float(), Xc


# ---------------------------------------------------------------------------
# Mixer: init_weights(n) -> w; mix_round(P, X, w, link, draw, X_full, t)
#        -> (X', w', link', extras).
# ---------------------------------------------------------------------------

class LinkState(NamedTuple):
    """Unreliable-link carry.  ``key`` is the link stream's own
    ``torch.Generator`` (drop and delay draws), so link-free programs keep
    their main stream bit for bit.  ``bufx`` / ``bufw`` are the delayed
    mixer's in-flight buffers (``bufx[r]`` arrives ``r + 1`` rounds from
    now; ``w.sum() + bufw.sum() == n``), ``last`` the event-triggered
    mixer's last-broadcast rows.  Unused fields stay ``()``."""

    key: torch.Generator
    bufx: Any = ()  # (B, n, D) in-flight payload mass, bank dtype
    bufw: Any = ()  # (B, n) in-flight push-sum mass
    last: Any = ()  # (n, D) last transmitted rows


class ChurnState(NamedTuple):
    """Node-churn carry: the churn stream's own ``torch.Generator``, the
    (n,) int8 liveness vector (``topology.LIVE`` / ``DOWN`` /
    ``DOWN_PERMANENT``) and, under cold resurrection, the (D,) init
    template row (``()`` when warm)."""

    key: torch.Generator
    live: torch.Tensor
    tpl: Any = ()


def _self_weights(P):
    """The self-loop weight per receiver: ``diag(P)`` for a dense matrix,
    slot 0 of a NeighborList (the self-loop by convention), the pod blocks'
    diagonals for a TwoTierOp (its inter list's slot 0 is a zero-weight
    pad)."""
    if isinstance(P, topology.TwoTierOp):
        return torch.diagonal(P.intra, dim1=1, dim2=2).reshape(-1)
    if isinstance(P, topology.NeighborList):
        return P.wgt[:, 0]
    return torch.diagonal(P)


def _selfloop_correction(P, X, X_full, mixed, shard=None):
    """Replace the self-loop contribution ``P[ii]·X[i]`` inside ``mixed``
    with the full-precision ``P[ii]·X_full[i]``; a no-op when ``X_full is
    X`` (identity compressor), keeping those compositions bit for bit.
    Under ``shard`` the rows are the rank's."""
    if X_full is X:
        return mixed
    s = _self_weights(P)
    if shard is not None:
        s = shard.rows(s)
    return mixed + (s[:, None] * (X_full.float() - X.float())).to(mixed.dtype)


def _whole(x, shard, lead: int = 0):
    """Every rank's rows of ``x`` (dim ``lead``), or ``x`` unsharded."""
    return x if shard is None else shard.all_gather(x, lead)


def _ones(n, device):
    return torch.ones((n,), dtype=torch.float32, device=device)


@dataclasses.dataclass(frozen=True)
class PushSumMixer:
    """Directed column-stochastic gossip + push-sum weight mixing
    (Algorithm 1 lines 12-14): X' = P X, w' = P w."""

    backend: Any = None
    shard: Any = None
    kind = "directed"
    link_stateful = False

    def init_weights(self, n: int, device=None):
        return _ones(n, device)

    def link_buffers(self, bank) -> dict:
        return {}

    def mix_weights(self, P, w):
        return pushsum.gossip_weights(P, w, self.shard)

    def mix(self, P, X, w):
        return (pushsum.gossip_bank(P, X, self.backend, self.shard),
                self.mix_weights(P, w))

    def mix_round(self, P, X, w, link, draw, X_full, t=None):
        Xm, wm = self.mix(P, X, w)
        return _selfloop_correction(P, X, X_full, Xm, self.shard), wm, link, {}


@dataclasses.dataclass(frozen=True)
class SymmetricMixer(PushSumMixer):
    """Doubly-stochastic gossip over an undirected graph (DFedAvg / DFedSAM
    family): X' = W X, push-sum weights stay all-ones."""

    kind = "symmetric"

    def mix_weights(self, P, w):
        return w


def draw_delays(gen: torch.Generator, P, bound: int) -> torch.Tensor:
    """The delay draw: one delivery delay in {0..bound} per entry of the
    dense operator, or per slot of a NeighborList."""
    shape = (P.idx.shape if isinstance(P, topology.NeighborList)
             else P.shape)
    return torch.randint(0, bound + 1, tuple(shape), generator=gen,
                         device=gen.device)


def _delay_slices(d: torch.Tensor, P, bound: int) -> list:
    """The ``bound + 1`` disjoint operators of one round's delays ``d`` (from
    :func:`draw_delays`): slice t carries exactly the edges arriving t
    rounds late; self-loops always land in slice 0.  The slices sum to
    ``P`` exactly."""
    if isinstance(P, topology.NeighborList):
        d = d.clone()
        d[:, 0] = 0  # the self-loop is local: never delayed
        zero = torch.zeros((), dtype=P.wgt.dtype, device=P.wgt.device)
        return [topology.NeighborList(P.idx, torch.where(d == t, P.wgt, zero))
                for t in range(bound + 1)]
    n = P.shape[0]
    d = d.masked_fill(torch.eye(n, dtype=torch.bool, device=d.device), 0)
    return [P * (d == t) for t in range(bound + 1)]


@dataclasses.dataclass(frozen=True)
class DelayedPushSumMixer:
    """Push-sum over links with bounded random delays (staleness <= B).

    Every surviving edge (j -> i) takes a delivery delay in {0..B} each
    round; its share ``P[ij]·(x_j, w_j)`` rides the ``(B, n, D)`` / ``(B,
    n)`` buffers of :class:`LinkState` until it matures.  The self-loop
    always delivers at once.  A sender's whole column leaves every round,
    spread over delivery times, so ``w.sum() + bufw.sum() == n`` exactly.
    One mix launch per slice: ``B + 1`` a round.
    """

    delay: int = 1
    backend: Any = None
    shard: Any = None
    kind = "directed"
    link_stateful = True

    def __post_init__(self):
        if self.delay < 1:
            raise ValueError("DelayedPushSumMixer needs delay >= 1; "
                             "use PushSumMixer for instantaneous links")

    def init_weights(self, n: int, device=None):
        return _ones(n, device)

    def link_buffers(self, bank) -> dict:
        n = bank.shape[0]
        return {
            "bufx": torch.zeros((self.delay,) + tuple(bank.shape),
                                dtype=bank.dtype, device=bank.device),
            "bufw": torch.zeros((self.delay, n), dtype=torch.float32,
                                device=bank.device),
        }

    def mix_weights(self, P, w):
        return pushsum.gossip_weights(P, w, self.shard)

    def mix_round(self, P, X, w, link: LinkState, draw, X_full, t=None):
        if draw is None:
            draw = draw_delays(link.key, P, self.delay)
        slices = _delay_slices(draw, P, self.delay)
        sent_x = [pushsum.gossip_bank(Ps, X, self.backend, self.shard)
                  for Ps in slices]
        sent_w = [self.mix_weights(Ps, w) for Ps in slices]
        # Slice 0 holds the self-loop: keep it full precision.
        sent_x[0] = _selfloop_correction(P, X, X_full, sent_x[0], self.shard)
        X_new = sent_x[0] + link.bufx[0].to(sent_x[0].dtype)
        w_new = sent_w[0] + link.bufw[0]
        # Shift the buffers one round closer to delivery and enqueue the
        # newly sent delayed shares.
        bufx = torch.cat([link.bufx[1:], torch.zeros_like(link.bufx[:1])]) \
            + torch.stack(sent_x[1:]).to(link.bufx.dtype)
        bufw = torch.cat([link.bufw[1:], torch.zeros_like(link.bufw[:1])]) \
            + torch.stack(sent_w[1:])
        link = link._replace(bufx=bufx, bufw=bufw)
        return X_new, w_new, link, {
            "w_inflight": _whole(bufw, self.shard, 1).sum()}


@dataclasses.dataclass(frozen=True)
class EventTriggeredMixer:
    """Directed push-sum where a client transmits a fresh row only when it
    drifted more than the threshold (L2) from its last transmission;
    neighbors otherwise mix the cached last broadcast (``LinkState.last``).
    The self-loop always uses the live full-precision row; push-sum weights
    always mix fresh, so mass stays n.  The round-t threshold is
    ``schedule(t)`` when given, else ``threshold * decay ** t`` in float32;
    ``decay == 1`` with no schedule is the fixed threshold.  The
    ``comm_fraction`` extra is the share of clients that transmitted."""

    threshold: float = 0.01
    decay: float = 1.0
    schedule: Any = None
    backend: Any = None
    shard: Any = None
    kind = "directed"
    link_stateful = True

    def _threshold_at(self, t):
        f32 = torch.float32
        if self.schedule is None and self.decay == 1.0:
            return torch.tensor(self.threshold, dtype=f32)
        if t is None:
            raise ValueError(
                "a scheduled/decaying event threshold needs the round "
                "index: thread t=state.round into comm_phase"
            )
        tf = torch.tensor(float(t), dtype=f32)
        if self.schedule is not None:
            return torch.as_tensor(self.schedule(tf), dtype=f32)
        return torch.tensor(self.threshold, dtype=f32) * (
            torch.tensor(self.decay, dtype=f32) ** tf)

    def init_weights(self, n: int, device=None):
        return _ones(n, device)

    def link_buffers(self, bank) -> dict:
        # Every client's initial row is common knowledge (broadcast init),
        # so the cache starts warm.
        return {"last": bank.clone()}

    def mix_weights(self, P, w):
        return pushsum.gossip_weights(P, w, self.shard)

    def mix_round(self, P, X, w, link: LinkState, draw, X_full, t=None):
        drift = X.float() - link.last.float()
        thr = self._threshold_at(t).to(X.device)
        send = torch.sqrt(torch.sum(drift * drift, dim=1)) > thr
        B = torch.where(send[:, None], X, link.last.to(X.dtype))
        # B is a fresh tensor, so the self-loop correction always applies:
        # the self-loop never reads the cache.
        Xm = _selfloop_correction(
            P, B, X_full, pushsum.gossip_bank(P, B, self.backend, self.shard),
            self.shard)
        wm = self.mix_weights(P, w)
        return Xm, wm, link._replace(last=B), {
            "comm_fraction": _whole(send.float(), self.shard).mean()
        }


@dataclasses.dataclass(frozen=True)
class CentralMixer:
    """Central-server round (FedAvg): the sampled clients' rows are averaged
    into the single global row; no mixing matrix, no push-sum weights."""

    kind = "central"
    link_stateful = False

    def init_weights(self, n: int, device=None):
        return _ones(n, device)

    def link_buffers(self, bank) -> dict:
        return {}

    def reduce(self, X):
        return X.mean(dim=0)


# ---------------------------------------------------------------------------
# The communication phase: compress -> link drops -> mix.
# ---------------------------------------------------------------------------

def comm_phase(compressor, mixer, P, X, w, comp, link, *, linked=False,
               link_model=None, symmetric=False, t=None, draws=None):
    """One communication phase on the flat bank: compress, apply this
    round's link drops (uniforms ``draws["drop"]``, else drawn from
    ``link.key``), then ``mixer.mix_round`` (delays ``draws["delay"]``,
    else drawn from ``link.key`` after the drops).  ``t`` is the round
    index, read only by a scheduled event threshold.

    Returns ``(X_mixed, w_new, comp, link, extras)``.
    """
    draws = draws or {}
    comp, Xc = compressor.apply(comp, X)
    if linked and link_model is not None and link_model.drop > 0:
        u = draws.get("drop")
        u = (topology.draw_drops(link.key, P) if u is None
             else torch.as_tensor(u, device=X.device))
        P = link_model.drop_links(u, P, symmetric=symmetric)
    delay = draws.get("delay")
    if delay is not None:
        delay = torch.as_tensor(delay, device=X.device)
    Xm, w_new, link, extras = mixer.mix_round(P, Xc, w, link, delay, X, t=t)
    return Xm, w_new, comp, link, extras


# ---------------------------------------------------------------------------
# Registries: AlgoConfig -> stage instances.
# ---------------------------------------------------------------------------

SOLVERS = {
    # Algorithm 1 inner loop; rho/alpha = 0 recover SGD+momentum / SAM-only.
    "sam_momentum": lambda a: SamMomentumSolver(
        a.local_steps, a.batch_size, a.rho, a.alpha),
    # Plain SGD regardless of the config's rho/alpha knobs.
    "sgd": lambda a: SamMomentumSolver(a.local_steps, a.batch_size, 0.0, 0.0),
    # FedProx-style proximal local objective (uses a.prox_mu).
    "proximal": lambda a: ProximalSolver(
        a.local_steps, a.batch_size, a.rho, a.alpha, a.prox_mu),
}

COMPRESSORS = {
    "identity": lambda a: IdentityCompressor(),
    "int8_rows": lambda a: Int8RowCompressor(),
    "topk_ef": lambda a: TopKEFCompressor(getattr(a, "topk_ratio", 0.05)),
}

MIXERS = {
    "directed": lambda a: PushSumMixer(),
    "symmetric": lambda a: SymmetricMixer(),
    "central": lambda a: CentralMixer(),
}


def make_stages(algo):
    """Resolve an ``AlgoConfig`` into its (solver, compressor, mixer).
    ``quantize_gossip`` is the legacy spelling of
    ``compressor="int8_rows"``."""
    comp_name = algo.compressor
    if comp_name == "identity" and getattr(algo, "quantize_gossip", False):
        comp_name = "int8_rows"
    try:
        solver = SOLVERS[algo.solver](algo)
        compressor = COMPRESSORS[comp_name](algo)
        mixer = MIXERS[algo.comm](algo)
    except KeyError as e:
        raise ValueError(f"unknown stage {e.args[0]!r} in {algo}") from None
    return solver, compressor, mixer
