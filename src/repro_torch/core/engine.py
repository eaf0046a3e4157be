"""Algorithm registry and the stateful trainer — the port of
``repro.core.engine`` on the flat bank.

``AlgoConfig`` is one point in the stage-composition space; ``ALGORITHMS``
holds Algorithm 1 (DFedSGPSM), the seven paper baselines and the DFedSGPM
ablation.  :class:`FLTrainer` is a thin stateful wrapper over the round
program.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.core import topology
from repro_torch.core.program import FLState, RoundProgram, make_program

__all__ = [
    "AlgoConfig",
    "ALGORITHMS",
    "FLState",
    "FLTrainer",
    "RoundProgram",
    "make_algo",
    "make_program",
]


@dataclasses.dataclass(frozen=True)
class AlgoConfig:
    """One federated-optimization algorithm = one stage composition."""

    name: str = "dfedsgpsm"
    comm: str = "directed"  # mixer: directed | symmetric | central
    local_steps: int = 5
    rho: float = 0.0  # SAM perturbation radius (0 = off)
    alpha: float = 0.0  # local momentum coefficient (0 = off)
    selection: bool = False  # DFedSGPSM-S neighbor selection
    lr: float = 0.1
    lr_decay: float = 0.998
    batch_size: int = 32
    solver: str = "sam_momentum"  # sam_momentum | sgd
    compressor: str = "identity"  # the other compressors: queue 1 item 7


ALGORITHMS: dict[str, AlgoConfig] = {
    "fedavg": AlgoConfig("fedavg", "central"),
    "dpsgd": AlgoConfig("dpsgd", "symmetric", local_steps=1),
    "dfedavg": AlgoConfig("dfedavg", "symmetric"),
    "dfedavgm": AlgoConfig("dfedavgm", "symmetric", alpha=0.9),
    "dfedsam": AlgoConfig("dfedsam", "symmetric", rho=0.25),
    "sgp": AlgoConfig("sgp", "directed", local_steps=1),
    "osgp": AlgoConfig("osgp", "directed"),
    "dfedsgpm": AlgoConfig("dfedsgpm", "directed", alpha=0.9),
    "dfedsgpsm": AlgoConfig("dfedsgpsm", "directed", alpha=0.9, rho=0.1),
    "dfedsgpsm_s": AlgoConfig(
        "dfedsgpsm_s", "directed", alpha=0.9, rho=0.1, selection=True
    ),
}


def make_algo(name: str, **overrides) -> AlgoConfig:
    return dataclasses.replace(ALGORITHMS[name], **overrides)


class FLTrainer:
    """Thin stateful wrapper over the round program (flat bank).

    Args:
      loss_fn: ``loss_fn(params, batch) -> (loss, accuracy)``.
      init_fn: ``init_fn(generator) -> params`` for a single client.
      client_data: dict of arrays or tensors with leading dims
        (n_clients, m, ...); moved to ``device``.
      algo: AlgoConfig.
      topo: TopologyConfig (ignored for centralized algorithms).
      seed: seed of the trainer's ``torch.Generator`` (model init, then
        every round's topology and minibatch draws).
      gossip: ``"auto"`` (density rule) or force ``"sparse"`` / ``"dense"``.
      device: where the bank lives and the kernels run; ``"cuda"`` by
        default, ``"cpu"`` only when asked (the kernels' plain versions).
    """

    def __init__(
        self,
        loss_fn: Callable,
        init_fn: Callable,
        client_data,
        algo: AlgoConfig,
        topo: topology.TopologyConfig,
        seed: int = 0,
        participation: float = 0.1,
        gossip: str = "auto",
        device="cuda",
    ):
        self.loss_fn = loss_fn
        self.algo = algo
        self.topo = topo
        self.n = topo.n_clients
        self.device = torch.device(device)
        self.program = make_program(
            loss_fn, init_fn, client_data, algo, topo, participation,
            gossip=gossip, device=self.device,
        )
        self.spec = self.program.spec
        gen = torch.Generator(device=self.device).manual_seed(seed)
        self.state = self.program.init(gen)

    def run_round(self, draws: dict | None = None):
        """One round; ``draws`` as in :meth:`RoundProgram.step`."""
        self.state, metrics = self.program.step(self.state, draws)
        return metrics

    def average_model(self):
        """Consensus model x̄ (Algorithm 1 output)."""
        if self.algo.comm == "central":
            return self.spec.unravel(self.state.params)
        return self.spec.unravel(self.state.params.mean(dim=0))

    def evaluate(self, test_data, batch: int = 1024):
        """``(test_loss, test_acc)`` of the consensus model: the eval of
        :meth:`fit`, run once on the current state."""
        tl, ta = self.program.make_eval_fn(test_data, batch)(self.state)
        return float(tl), float(ta)

    def fit(self, rounds: int, test_data=None, eval_every: int = 0, log=None):
        """Train ``rounds`` rounds; returns per-round history records (eval
        at the global-round cadence ``eval_every``)."""
        cadence = eval_every if test_data is not None else 0
        self.state, hist = self.program.run_superstep(
            self.state, rounds, cadence, test_data
        )
        hist = {k: v.cpu() for k, v in hist.items()}
        history = []
        for i in range(rounds):
            rec = {"round": i, "loss": float(hist["loss"][i]),
                   "acc": float(hist["acc"][i])}
            if "eval_mask" in hist and bool(hist["eval_mask"][i]):
                rec["test_loss"] = float(hist["test_loss"][i])
                rec["test_acc"] = float(hist["test_acc"][i])
            history.append(rec)
            if log:
                log(rec)
        return history
