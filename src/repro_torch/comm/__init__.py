"""The communication-plan layer — the port of ``repro.comm``: one
description of "which remote rows does each consumer read"."""
from repro_torch.comm.plan import CommPlan, HaloBackend, ShiftLeg, resolve_backend

__all__ = ["CommPlan", "HaloBackend", "ShiftLeg", "resolve_backend"]
