"""The round program: ``init`` / ``step`` over a (solver, compressor, mixer)
stage composition on the flat bank — the port of ``repro.core.program``.

    state           = program.init(generator)   # FLState
    state, metrics  = program.step(state)        # one communication round
    state, history  = program.run(state, rounds)

PyTorch runs eagerly, so ``run`` and ``run_superstep`` are Python loops;
the eval cadence of ``run_superstep`` keys on the global round counter, as
the reference's in-scan eval does.  Randomness comes from the state's
``torch.Generator``.  ``step(state, draws=...)`` takes a round's draws from
the caller instead — the mixing operator, the minibatch indices and, for
central algorithms, the selected clients — which is how the tests replay
the reference's own ``jax.random`` draws.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple

import torch
from torch.func import vmap

from repro_torch.core import topology
from repro_torch.core.flat import BankSpec, make_spec
from repro_torch.core.stages import comm_phase, make_stages
from repro_torch.kernels import ops as kops

__all__ = ["FLState", "RoundProgram", "make_program"]


class FLState(NamedTuple):
    """Round state: everything the next round reads."""

    params: Any  # (n, D) bank, or the (D,) central row
    mom: Any  # (n, D) float32 end-of-round momentum bank (None on central)
    w: torch.Tensor  # (n,) push-sum weights (all-ones when unused)
    key: torch.Generator  # the program's random stream
    round: int
    losses: torch.Tensor  # (n,) last local losses (drives selection)
    comp: Any = ()  # compressor state


def _as_device(x, device):
    if isinstance(x, topology.NeighborList):
        return topology.NeighborList(
            torch.as_tensor(x.idx, device=device).to(torch.int32),
            torch.as_tensor(x.wgt, device=device).float(),
        )
    return torch.as_tensor(x, device=device)


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
    spec: BankSpec
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

    # -- state constructor ----------------------------------------------------

    def init(self, gen: torch.Generator) -> FLState:
        """Initial state: one model from ``init_fn(gen)`` broadcast to every
        client; ``gen`` then drives every later round."""
        row = self.spec.ravel(self.init_fn(gen)).to(self.device)
        w0 = self.mixer.init_weights(self.n, self.device)
        losses0 = torch.zeros((self.n,), dtype=torch.float32,
                              device=self.device)
        if self.mixer.kind == "central":
            return FLState(row, None, w0, gen, 0, losses0, ())
        bank = row.expand(self.n, self.spec.dim).contiguous()
        mom = torch.zeros((self.n, self.spec.dim), dtype=torch.float32,
                          device=self.device)
        comp = self.compressor.init_state(self.n, self.spec.dim)
        return FLState(bank, mom, w0, gen, 0, losses0, comp)

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
        """One round.  ``draws`` may supply ``"P"`` (matrix or NeighborList),
        ``"batch_idx"`` ((K, rows, B) minibatch indices) and, for central
        algorithms, ``"sel"`` (the sampled clients); whatever is missing is
        drawn from ``state.key``."""
        draws = draws or {}
        lr = self.round_lr(state.round)
        if self.mixer.kind == "central":
            return self._central_step(state, lr, draws)
        P = draws.get("P")
        P = (self.mixing_matrix(state.key, state) if P is None
             else _as_device(P, self.device))
        idx = draws.get("batch_idx")
        idx = (self._batch_idx(state.key, self.n) if idx is None
               else _as_device(idx, self.device).long())
        X, V, losses, accs = self.solver.update(
            self.loss_fn, self.spec, state.params, state.w, idx, self.data, lr
        )
        X, w_new, comp = comm_phase(
            self.compressor, self.mixer, P, X, state.w, state.comp
        )
        new_state = FLState(X, V, w_new, state.key, state.round + 1, losses,
                            comp)
        return new_state, {"loss": losses.mean(), "acc": accs.mean()}

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
                            state.key, state.round + 1, new_losses, state.comp)
        return new_state, {"loss": losses.mean(), "acc": accs.mean()}

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
                   else state.params.mean(dim=0))
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
    device="cuda",
) -> RoundProgram:
    """Compose an ``AlgoConfig`` into a :class:`RoundProgram` on ``device``.

    ``gossip`` picks the mixing-operator representation: ``"auto"`` applies
    the density rule :func:`repro_torch.kernels.ops.use_sparse_gossip` to
    the family's static ``k_max``; ``"sparse"`` / ``"dense"`` force the
    neighbor-list or the dense sampler.  On CUDA this turns TF32 off for
    matmuls and convolutions, as the reference computes in full float32.
    """
    device = torch.device(device)
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    solver, compressor, mixer = make_stages(algo)
    if gossip not in ("auto", "sparse", "dense"):
        raise ValueError(f"gossip must be auto|sparse|dense, got {gossip!r}")
    if mixer.kind == "central":
        sparse_mix = False
    elif gossip == "sparse":
        if topo.kind == "full":
            raise ValueError("the full graph has no sparse neighbor-list form")
        sparse_mix = True
    elif gossip == "dense":
        sparse_mix = False
    else:
        sparse_mix = kops.use_sparse_gossip(
            topo.n_clients, topology.neighbor_k_max(topo, mixer.kind), device
        )
    # Leaf shapes and dtypes only: one model on the CPU.
    spec = make_spec(init_fn(torch.Generator().manual_seed(0)))
    exp_cycle = None
    if topo.kind == "exponential" and topo.time_varying:
        exp_cycle = (
            topology.neighbors_exponential_cycle(topo.n_clients, device)
            if sparse_mix
            else topology.exponential_cycle(topo.n_clients, device)
        )
    data = {k: torch.as_tensor(v, device=device) for k, v in client_data.items()}
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
    )
