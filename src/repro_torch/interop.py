"""Carry weights and state across from the JAX reference, as numpy arrays.

The reference's pytrees hold the same leaves in the same layouts as the
port's parameter dicts (dense ``(n_in, n_out)``, conv HWIO; the LLM zoo's
nested trees with every layer's leaves stacked on a leading axis, and its
``{"k", "v"}`` KV caches), and a bank row orders leaves the same way, so the
conversion is a copy.  The caller turns
JAX arrays into numpy first (``jax.device_get``); this module imports
neither ``jax`` nor ``repro``.  bfloat16 numpy arrays (``ml_dtypes``) cross
bit for bit.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.flat import tree_map
from repro_torch.core.program import FLState

__all__ = ["tensor_from_numpy", "params_from_numpy", "bank_row_from_numpy",
           "state_from_numpy"]


def tensor_from_numpy(a, device="cpu") -> torch.Tensor:
    """One numpy array (or scalar) -> tensor, bfloat16 bit for bit."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        bits = torch.from_numpy(np.ascontiguousarray(a).view(np.int16).copy())
        return bits.view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def params_from_numpy(tree, device="cpu") -> dict:
    """A JAX params pytree of numpy arrays (nested dicts) -> port params."""
    return tree_map(lambda a: tensor_from_numpy(a, device), tree)


def bank_row_from_numpy(row, device="cpu") -> torch.Tensor:
    """A reference bank row (D,) or bank (n, D) -> the port's, unchanged."""
    return tensor_from_numpy(row, device)


def state_from_numpy(dump: dict, gen: torch.Generator, device="cpu") -> FLState:
    """A port :class:`FLState` from a numpy dump of a reference ``FLState``:
    ``params``, ``w``, ``round``, ``losses`` and optionally ``mom`` (None or
    absent on central algorithms).  The reference's PRNG key has no torch
    counterpart: ``gen`` becomes the port state's random stream."""
    mom = dump.get("mom")
    return FLState(
        params=bank_row_from_numpy(dump["params"], device),
        mom=None if mom is None else tensor_from_numpy(mom, device),
        w=tensor_from_numpy(dump["w"], device),
        key=gen,
        round=int(np.asarray(dump["round"])),
        losses=tensor_from_numpy(dump["losses"], device),
        comp=(),
    )
