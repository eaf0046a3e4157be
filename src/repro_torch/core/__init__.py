"""Core of the port: asymmetric decentralized FL (DFedSGPSM) on the flat bank.

  topology: directed / symmetric mixing operators, draw + build samplers.
  pushsum:  push-sum mixing and de-biasing on the bank.
  sam:      SAM perturbation (Algorithm 1 inner loop).
  stages:   LocalSolver / Compressor / Mixer round stages.
  program:  the ``init`` / ``step`` round program.
  engine:   AlgoConfig registry + the stateful FLTrainer.
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
from repro_torch.core.flat import BankSpec, make_spec
from repro_torch.core.stages import COMPRESSORS, MIXERS, SOLVERS, make_stages
from repro_torch.core.topology import TopologyConfig

__all__ = [
    "ALGORITHMS",
    "AlgoConfig",
    "BankSpec",
    "COMPRESSORS",
    "FLState",
    "FLTrainer",
    "MIXERS",
    "RoundProgram",
    "SOLVERS",
    "TopologyConfig",
    "make_algo",
    "make_program",
    "make_spec",
    "make_stages",
]
