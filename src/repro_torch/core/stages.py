"""Composable round stages on the flat ``(n, D)`` bank — the main-path part
of ``repro.core.stages``:

  LocalSolver   Algorithm 1 lines 4-11: K local steps, each a two-pass SAM
                gradient vmapped over the bank rows (``torch.func``) and one
                fused momentum/descent/de-bias kernel call on the whole bank.
  Compressor    identity (the other compressors come with a later slice).
  Mixer         lines 12-14: push-sum over a directed column-stochastic
                operator, doubly-stochastic symmetric gossip, or a central
                server reduce.

Randomness arrives as explicit minibatch indices, drawn by the round
program from its ``torch.Generator`` (or replayed from the reference).
"""
from __future__ import annotations

import dataclasses

import torch
from torch.func import vmap

from repro_torch.core import pushsum
from repro_torch.core.sam import sam_gradient
from repro_torch.kernels import ops as kops

__all__ = [
    "SamMomentumSolver",
    "IdentityCompressor",
    "PushSumMixer",
    "SymmetricMixer",
    "CentralMixer",
    "SOLVERS",
    "COMPRESSORS",
    "MIXERS",
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

    def update(self, loss_fn, spec, X, w, batch_idx, data, lr):
        """``batch_idx`` is (local_steps, n, batch_size): the minibatch rows
        of each client at each local step."""
        grads = self._grad_one(loss_fn, spec)
        V0 = torch.zeros_like(X, dtype=torch.float32)
        V = V0
        losses, accs = [], []
        for k in range(self.local_steps):
            batch = _sample_batch(data, batch_idx[k])
            G_tree, loss_k, acc_k = grads(X, w, batch["x"], batch["y"])
            G = spec.ravel_grad_stacked(G_tree, X)
            if self.alpha == 0.0:
                # Momentum off: v' = g exactly, V0 stays the zero operand.
                X, _, _ = kops.fused_update_bank(X, V0, G, 0.0, lr, w)
            else:
                X, V, _ = kops.fused_update_bank(X, V, G, self.alpha, lr, w)
            losses.append(loss_k)
            accs.append(acc_k)
        return (X, V, torch.stack(losses).mean(dim=0),
                torch.stack(accs).mean(dim=0))


# ---------------------------------------------------------------------------
# Compressor: init_state(n, d) -> state; apply(state, X) -> (state, X').
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class IdentityCompressor:
    """No-op communication stage (full-precision gossip)."""

    stateful = False

    def init_state(self, n: int, d: int):
        return ()

    def apply(self, state, X):
        return state, X


# ---------------------------------------------------------------------------
# Mixer: init_weights(n) -> w; mix(P, X, w) -> (X', w').
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class PushSumMixer:
    """Directed column-stochastic gossip + push-sum weight mixing
    (Algorithm 1 lines 12-14): X' = P X, w' = P w."""

    kind = "directed"

    def init_weights(self, n: int, device=None):
        return torch.ones((n,), dtype=torch.float32, device=device)

    def mix(self, P, X, w):
        return pushsum.gossip_bank(P, X), pushsum.gossip_weights(P, w)


@dataclasses.dataclass(frozen=True)
class SymmetricMixer:
    """Doubly-stochastic gossip over an undirected graph (DFedAvg / DFedSAM
    family): X' = W X, push-sum weights stay all-ones."""

    kind = "symmetric"

    def init_weights(self, n: int, device=None):
        return torch.ones((n,), dtype=torch.float32, device=device)

    def mix(self, P, X, w):
        return pushsum.gossip_bank(P, X), w


@dataclasses.dataclass(frozen=True)
class CentralMixer:
    """Central-server round (FedAvg): the sampled clients' rows are averaged
    into the single global row; no mixing matrix, no push-sum weights."""

    kind = "central"

    def init_weights(self, n: int, device=None):
        return torch.ones((n,), dtype=torch.float32, device=device)

    def reduce(self, X):
        return X.mean(dim=0)


def comm_phase(compressor, mixer, P, X, w, comp):
    """One communication phase on the flat bank: compress, then mix.
    Returns ``(X_mixed, w_new, comp)``.  (Link and churn scenarios, and the
    full-precision self-loop of lossy compressors, come with later slices.)"""
    comp, Xc = compressor.apply(comp, X)
    Xm, w_new = mixer.mix(P, Xc, w)
    return Xm, w_new, comp


# ---------------------------------------------------------------------------
# Registries: AlgoConfig -> stage instances.
# ---------------------------------------------------------------------------

SOLVERS = {
    "sam_momentum": lambda a: SamMomentumSolver(
        a.local_steps, a.batch_size, a.rho, a.alpha),
    "sgd": lambda a: SamMomentumSolver(a.local_steps, a.batch_size, 0.0, 0.0),
}

COMPRESSORS = {
    "identity": lambda a: IdentityCompressor(),
}

MIXERS = {
    "directed": lambda a: PushSumMixer(),
    "symmetric": lambda a: SymmetricMixer(),
    "central": lambda a: CentralMixer(),
}


def make_stages(algo):
    """Resolve an ``AlgoConfig`` into its (solver, compressor, mixer)."""
    try:
        solver = SOLVERS[algo.solver](algo)
        compressor = COMPRESSORS[algo.compressor](algo)
        mixer = MIXERS[algo.comm](algo)
    except KeyError as e:
        raise ValueError(
            f"stage {e.args[0]!r} of {algo} is not ported to repro_torch yet"
        ) from None
    return solver, compressor, mixer
