"""Optimizer utilities of the port (``repro.optim``)."""
from repro_torch.optim.sgd import (
    exponential_decay,
    sgd_momentum_step,
    warmup_cosine,
)

__all__ = ["exponential_decay", "sgd_momentum_step", "warmup_cosine"]
