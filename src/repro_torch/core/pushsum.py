"""Push-Sum primitives on the flat bank (Kempe et al. 2003; Assran et al.
2019) — the port of ``gossip_bank``, ``gossip_weights``, ``debias_bank``
and ``consensus_error_bank`` from ``repro.core.pushsum``.

Each client carries a push-sum weight ``w_i`` mixed with the same
column-stochastic operator as its parameters; ``z_i = x_i / w_i`` is the
de-biased model and ``sum_i w_i = n`` for all rounds.
"""
from __future__ import annotations

import torch

from repro_torch.core.topology import NeighborList
from repro_torch.kernels import ops as kops

__all__ = ["gossip_bank", "gossip_weights", "debias_bank",
           "consensus_error_bank"]


def gossip_bank(P, X: torch.Tensor) -> torch.Tensor:
    """One mixing step ``X' = P @ X`` on the (n, D) bank: the dense kernel
    for a matrix, the gather kernel for a :class:`NeighborList`."""
    if isinstance(P, NeighborList):
        return kops.gossip_mix_sparse(P.idx, P.wgt, X)
    return kops.gossip_mix(P, X)


def gossip_weights(P, w: torch.Tensor) -> torch.Tensor:
    """Mix the push-sum weights ``w' = P @ w`` (shape (n,)) in float32 — a
    plain (n,) operation, the same neighbor gather as the bank for a
    :class:`NeighborList`."""
    wf = w.float()
    if isinstance(P, NeighborList):
        return torch.sum(P.wgt * wf[P.idx.long()], dim=1).to(w.dtype)
    return (P.float() @ wf).to(w.dtype)


def debias_bank(X: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """z_i = x_i / w_i on the flat (n, D) bank."""
    return X / w[:, None].to(X.dtype)


def consensus_error_bank(X: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Mean squared distance of de-biased rows from the bank average."""
    z = debias_bank(X, w)
    mean = X.mean(dim=0, keepdim=True)
    return torch.sum((z - mean) ** 2) / X.shape[0]
