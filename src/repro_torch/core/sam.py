"""Sharpness-Aware Minimization and local-momentum primitives (Algorithm 1
lines 6-10) — the port of ``repro.core.sam``, over nested parameter dicts
with ``torch.func``.  ``momentum_update`` and ``apply_update`` drive the
``flat=False`` oracle; the flat bank runs them fused in one kernel.
"""
from __future__ import annotations

from typing import Callable

import torch
from torch.func import grad, grad_and_value

from repro_torch.core.flat import tree_flatten, tree_map

__all__ = ["global_norm", "sam_perturb", "sam_gradient", "momentum_update",
           "apply_update"]

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


def momentum_update(v, grads, alpha: float):
    """v' = alpha * v + g  (Algorithm 1 line 9; alpha=0 -> plain SGD)."""
    if alpha == 0.0:
        return grads
    return tree_map(
        lambda vi, gi: (alpha * vi.float() + gi.float()).to(vi.dtype), v, grads
    )


def apply_update(params, v, lr):
    """x' = x - lr * v  (Algorithm 1 line 10)."""
    return tree_map(
        lambda p, vi: (p.float() - lr * vi.float()).to(p.dtype), params, v
    )
