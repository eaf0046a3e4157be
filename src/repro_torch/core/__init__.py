"""Core of the port: asymmetric decentralized FL (DFedSGPSM) on the flat bank.

  topology: directed / symmetric mixing operators, draw + build samplers.
  pushsum:  push-sum mixing and de-biasing on the bank.
  sam:      SAM perturbation and local momentum (Algorithm 1 inner loop).
  stages:   LocalSolver / Compressor / Mixer round stages.
  program:  the ``init`` / ``step`` round program.
  engine:   AlgoConfig registry + the stateful FLTrainer.
  flat:     the dense bank and the low-rank delta bank.
"""
from repro_torch.core.engine import (
    ALGORITHMS,
    AlgoConfig,
    FLState,
    FLTrainer,
    RoundProgram,
    make_algo,
    make_program,
)
from repro_torch.core.flat import (
    BankSpec,
    BoundDeltaSpec,
    DeltaBankSpec,
    DeltaConfig,
    bind_delta_spec,
    make_delta_spec,
    make_spec,
)
from repro_torch.core.stages import (
    COMPRESSORS,
    MIXERS,
    SOLVERS,
    ChurnState,
    LinkState,
    make_stages,
)
from repro_torch.core.topology import ChurnModel, LinkModel, TopologyConfig

__all__ = [
    "ALGORITHMS",
    "AlgoConfig",
    "BankSpec",
    "BoundDeltaSpec",
    "COMPRESSORS",
    "ChurnModel",
    "ChurnState",
    "DeltaBankSpec",
    "DeltaConfig",
    "FLState",
    "FLTrainer",
    "LinkModel",
    "LinkState",
    "MIXERS",
    "RoundProgram",
    "SOLVERS",
    "TopologyConfig",
    "bind_delta_spec",
    "make_algo",
    "make_delta_spec",
    "make_program",
    "make_spec",
    "make_stages",
]
