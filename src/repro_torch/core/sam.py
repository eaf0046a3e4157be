"""Sharpness-Aware Minimization and local-momentum primitives (Algorithm 1
lines 6-10) — the port of ``repro.core.sam``, over nested parameter dicts
with ``torch.func``.  ``momentum_update`` and ``apply_update`` drive the
``flat=False`` oracle and the pod runtime; the flat bank runs them fused in
one kernel.

:func:`sam_gradient_autograd` is the same two-pass gradient taken with
``torch.autograd.grad`` on leaf tensors, for losses that run a kernel with a
hand-written backward (the decoders' flash attention): its CUDA call needs
real storage, which ``torch.func``'s wrapper tensors do not have, and
``cfg.remat``'s ``torch.utils.checkpoint`` needs the saved-tensor hooks
that ``torch.func`` refuses.

Under the pod runtime the parameters are DTensors over the pod's ("data",
"model") submesh (``launch.sharding.place_params``): the gradients come
back in their parameters' placements, and :func:`global_norm` sums every
shard of the replica, so ``rho g / ||g||`` is the unsharded step's.
"""
from __future__ import annotations

from typing import Callable

import torch
from torch.func import grad, grad_and_value

from repro_torch.core.flat import tree_flatten, tree_map, tree_unflatten
from repro_torch.launch.sharding import is_dtensor

__all__ = ["global_norm", "sam_perturb", "sam_gradient",
           "sam_gradient_autograd", "momentum_update", "apply_update"]

_EPS = 1e-12


def global_norm(tree) -> torch.Tensor:
    """Euclidean norm over a whole parameter dict (float32 accumulation,
    leaves summed in bank order).  DTensor leaves (a replica placed over
    its pod's submesh) are summed over every shard: a local norm would
    scale the SAM step by the square root of the shard count."""
    _, leaves = tree_flatten(tree)
    if any(is_dtensor(x) for x in leaves):
        return _placed_norm(leaves)
    total = None
    for x in leaves:
        sq = torch.sum(torch.square(x.float()))
        total = sq if total is None else total + sq
    return torch.sqrt(total)


def _placed_norm(leaves) -> torch.Tensor:
    """:func:`global_norm` of DTensor leaves on one mesh: each rank sums the
    squares of its shard of every leaf (a leaf replicated along a mesh dim
    counts on that dim's rank 0 only, so every element counts once), in
    bank order, and one reduction over the mesh (a ``Partial`` sum made
    ``Replicate``) gives the whole sum on every rank; a plain 0-d tensor."""
    from torch.distributed.tensor import DTensor, Partial, Replicate

    mesh = leaves[0].device_mesh
    total = None
    for x in leaves:
        sq = torch.sum(torch.square(x.to_local().float()))
        for i, pl in enumerate(x.placements):
            if pl.is_replicate() and mesh.get_local_rank(i) != 0:
                sq = torch.zeros_like(sq)
        total = sq if total is None else total + sq
    total = DTensor.from_local(total, mesh, [Partial()] * mesh.ndim,
                               run_check=False)
    total = total.redistribute(mesh, [Replicate()] * mesh.ndim).to_local()
    return torch.sqrt(total)


def _placed_like(g, leaf):
    """A DTensor gradient in its parameter's placements (the backward
    leaves sums ``Partial`` and activations' layouts behind)."""
    if is_dtensor(g) and tuple(g.placements) != tuple(leaf.placements):
        return g.redistribute(leaf.device_mesh, leaf.placements)
    return g


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


def _detach(x):
    if isinstance(x, torch.Tensor):
        return x.detach()
    if isinstance(x, (tuple, list)):
        return type(x)(_detach(y) for y in x)
    if isinstance(x, dict):
        return {k: _detach(y) for k, y in x.items()}
    return x


def _grad_and_value(loss_fn: Callable, params, batch):
    """``(grads, (loss, aux))`` of ``loss_fn`` at ``params`` by
    ``torch.autograd.grad`` on fresh leaves (the caller's tensors are not
    touched)."""
    paths, leaves = tree_flatten(params)
    leaves = [x.detach().requires_grad_(True) for x in leaves]
    with torch.enable_grad():
        loss, aux = loss_fn(tree_unflatten(paths, leaves), batch)
        grads = torch.autograd.grad(loss, leaves)
    grads = [_placed_like(g, x) for g, x in zip(grads, leaves)]
    return tree_unflatten(paths, grads), (loss.detach(), _detach(aux))


def sam_gradient_autograd(loss_fn: Callable, params, batch, rho: float):
    """:func:`sam_gradient` with ``torch.autograd.grad`` in place of
    ``torch.func``: the same two passes and :func:`sam_perturb` arithmetic.
    Returns ``(grads, (loss, aux))`` of the first pass, detached."""
    g1, (loss, aux) = _grad_and_value(loss_fn, params, batch)
    if rho == 0.0:
        return g1, (loss, aux)
    perturbed = sam_perturb(params, g1, rho)
    del g1
    g2, _ = _grad_and_value(loss_fn, perturbed, batch)
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
