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

import dataclasses

import numpy as np
import torch

from repro_torch.core.flat import BoundDeltaSpec, bind_delta_spec, tree_map
from repro_torch.core.program import FLState, RoundProgram
from repro_torch.core.stages import ChurnState, LinkState

__all__ = ["tensor_from_numpy", "params_from_numpy", "bank_row_from_numpy",
           "state_from_numpy", "pod_state_from_numpy",
           "program_with_delta_base"]


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


def _maybe(a, device):
    return () if a is None else tensor_from_numpy(a, device)


def state_from_numpy(dump: dict, gen: torch.Generator, device="cpu", *,
                     link_key: torch.Generator | None = None,
                     churn_key: torch.Generator | None = None) -> FLState:
    """A port :class:`FLState` from a numpy dump of a reference ``FLState``:
    ``params``, ``w``, ``round``, ``losses``, and optionally ``mom`` (None
    or absent on central algorithms), ``comp`` (the EF residual bank),
    ``link`` (a dict of ``bufx`` / ``bufw`` / ``last``, each None where the
    mixer carries none) and ``churn`` (a dict of ``live`` and ``tpl``, None
    when warm).  The reference's PRNG keys have no torch counterpart:
    ``gen`` becomes the port state's main stream, ``link_key`` /
    ``churn_key`` its scenario streams (required where the dump carries
    that scenario)."""
    mom = dump.get("mom")
    comp = dump.get("comp")
    link, churn = (), ()
    if dump.get("link") is not None:
        if link_key is None:
            raise ValueError("the dump carries link state: pass link_key")
        lk = dump["link"]
        link = LinkState(link_key, _maybe(lk.get("bufx"), device),
                         _maybe(lk.get("bufw"), device),
                         _maybe(lk.get("last"), device))
    if dump.get("churn") is not None:
        if churn_key is None:
            raise ValueError("the dump carries churn state: pass churn_key")
        ch = dump["churn"]
        churn = ChurnState(churn_key,
                           tensor_from_numpy(ch["live"], device).to(torch.int8),
                           _maybe(ch.get("tpl"), device))
    return FLState(
        params=bank_row_from_numpy(dump["params"], device),
        mom=None if mom is None else tensor_from_numpy(mom, device),
        w=tensor_from_numpy(dump["w"], device),
        key=gen,
        round=int(np.asarray(dump["round"])),
        losses=tensor_from_numpy(dump["losses"], device),
        comp=_maybe(comp, device),
        link=link,
        churn=churn,
    )


def pod_state_from_numpy(dump: dict, device="cpu", *,
                         link_key: torch.Generator | None = None) -> tuple:
    """The pod round's carries ``(params, v, w, comp, link)`` from a numpy
    dump of the reference's: ``params`` and ``v`` (pytrees whose leaves
    are stacked on a leading pod axis), ``w`` (n_pods,), and optionally
    ``comp`` (the EF residual bank) and ``link`` (a dict of ``bufx`` /
    ``bufw`` / ``last``, each None where the mixer carries none).  The
    reference's link key has no torch counterpart: ``link_key`` becomes
    the link stream (required where the dump carries link state).  Carries
    the dump lacks come back as ``()``."""
    link = ()
    if dump.get("link") is not None:
        if link_key is None:
            raise ValueError("the dump carries link state: pass link_key")
        lk = dump["link"]
        link = LinkState(link_key, _maybe(lk.get("bufx"), device),
                         _maybe(lk.get("bufw"), device),
                         _maybe(lk.get("last"), device))
    return (params_from_numpy(dump["params"], device),
            params_from_numpy(dump["v"], device),
            tensor_from_numpy(dump["w"], device),
            _maybe(dump.get("comp"), device), link)


def program_with_delta_base(program: RoundProgram, base_tree,
                            device="cpu") -> RoundProgram:
    """``program`` with its delta bank's frozen base replaced by the
    reference's base (a numpy params pytree), so that both packages train
    over the same base."""
    if not isinstance(program.spec, BoundDeltaSpec):
        raise ValueError("the program has no delta bank")
    base = params_from_numpy(base_tree, device)
    return dataclasses.replace(
        program, spec=bind_delta_spec(program.spec.delta, base))
