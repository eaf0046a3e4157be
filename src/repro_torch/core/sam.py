"""Sharpness-Aware Minimization primitives (Algorithm 1 lines 6-8) — the port
of ``global_norm``, ``sam_perturb`` and ``sam_gradient`` from
``repro.core.sam``, over nested parameter dicts with ``torch.func``.
"""
from __future__ import annotations

from typing import Callable

import torch
from torch.func import grad, grad_and_value

from repro_torch.core.flat import tree_flatten, tree_map

__all__ = ["global_norm", "sam_perturb", "sam_gradient"]

_EPS = 1e-12


def global_norm(tree) -> torch.Tensor:
    """Euclidean norm over a whole parameter dict (float32 accumulation,
    leaves summed in bank order)."""
    _, leaves = tree_flatten(tree)
    total = None
    for x in leaves:
        sq = torch.sum(torch.square(x.float()))
        total = sq if total is None else total + sq
    return torch.sqrt(total)


def sam_perturb(params, grads, rho: float):
    """z̆ = z + rho * g / ||g||  (Algorithm 1 line 7)."""
    scale = (rho / (global_norm(grads) + _EPS)).float()
    return tree_map(
        lambda p, g: (p.float() + scale * g.float()).to(p.dtype), params, grads
    )


def sam_gradient(loss_fn: Callable, params, batch, rho: float):
    """Two-pass SAM gradient at ``params`` with the *same* minibatch.

    ``loss_fn(params, batch) -> (loss, aux)``.  Returns ``(grads, (loss,
    aux))`` of the first (unperturbed) pass; ``rho == 0`` degrades to one
    plain gradient.
    """
    g1, (loss, aux) = grad_and_value(loss_fn, has_aux=True)(params, batch)
    if rho == 0.0:
        return g1, (loss, aux)
    perturbed = sam_perturb(params, g1, rho)
    g2, _ = grad(loss_fn, has_aux=True)(perturbed, batch)
    return g2, (loss, aux)
