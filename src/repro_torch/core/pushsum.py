"""Push-Sum primitives (Kempe et al. 2003; Assran et al. 2019) — the port of
``repro.core.pushsum``: the flat-bank forms the round program runs, and the
client-stacked parameter-dict forms (``gossip``, ``debias``,
``consensus_error``) of the ``flat=False`` oracle.

Each client carries a push-sum weight ``w_i`` mixed with the same
column-stochastic operator as its parameters; ``z_i = x_i / w_i`` is the
de-biased model and ``sum_i w_i = n`` for all rounds.

``backend`` selects the mix's executor (``comm.plan.resolve_backend``):
``None`` or ``"xla"`` the kernels on the bank at hand, a
:class:`~repro_torch.comm.plan.HaloBackend` the halo exchange.  Under a
row-sharded bank ``shard`` (a :class:`~repro_torch.launch.sharding.RowShard`)
says which rows this rank holds: ``X`` and ``w`` are its rows, the operator
``P`` is the whole round's, and the result is its rows of ``P @ X``.
"""
from __future__ import annotations

import torch

from repro_torch.core.flat import tree_flatten, tree_map
from repro_torch.core.topology import NeighborList, TwoTierOp
from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref as kref

__all__ = ["gossip", "gossip_bank", "gossip_weights", "debias", "debias_bank",
           "consensus_error", "consensus_error_bank"]


def gossip(P, stacked_params, use_kernel: bool = True):
    """One mixing step ``X' = P @ X`` on every leaf of a client-stacked
    parameter dict (leading dim n).  ``use_kernel=False`` pins the plain
    oracles of ``kernels.ref`` whatever the device, as the reference's
    ``flat=False`` path does with ``use_kernel=False``."""

    def mix(x):
        flat = x.reshape(x.shape[0], -1)
        if not use_kernel:
            out = (kref.gossip_gather_ref(P.idx, P.wgt, flat)
                   if isinstance(P, NeighborList)
                   else kref.gossip_matmul_ref(P, flat))
        else:
            out = gossip_bank(P, flat)
        return out.reshape(x.shape)

    return tree_map(mix, stacked_params)


def _intra(P: TwoTierOp, X: torch.Tensor, shard=None) -> torch.Tensor:
    """The two-tier operator's intra-pod term in f32: one batched product of
    the pod blocks with their rows.  Under a row-sharded bank whose shards
    hold whole pods it is the rank's own pods; otherwise the pods of the
    rank's rows come from the gathered bank."""
    n_pods, ps, _ = P.intra.shape
    if shard is None:
        lo, pods, rows = 0, n_pods, X
    elif shard.m % ps == 0:
        lo, pods, rows = shard.lo // ps, shard.m // ps, X
    else:
        lo, hi = shard.lo // ps, -(-shard.hi // ps)
        pods, rows = hi - lo, shard.all_gather(X)[lo * ps:hi * ps]
    out = torch.bmm(P.intra[lo:lo + pods],
                    rows.reshape(pods, ps, -1).float()).reshape(pods * ps, -1)
    if shard is not None and shard.m % ps:
        out = out[shard.lo - lo * ps:shard.hi - lo * ps]
    return out


def gossip_bank(P, X: torch.Tensor, backend=None, shard=None) -> torch.Tensor:
    """One mixing step ``X' = P @ X`` on the (n, D) bank: the dense kernel
    for a matrix, the gather kernel for a :class:`NeighborList`, and for a
    :class:`TwoTierOp` the f32 intra-pod product (``torch.bmm``, TF32 off)
    plus the cross-pod gather.  Under ``shard``, this rank's rows."""
    if isinstance(P, TwoTierOp):
        inter = gossip_bank(P.inter, X, backend, shard)
        return _intra(P, X, shard).to(X.dtype) + inter
    if isinstance(P, NeighborList):
        return kops.gossip_mix_sparse(P.idx, P.wgt, X, backend, shard)
    return kops.gossip_mix(P, X, shard)


def gossip_weights(P, w: torch.Tensor, shard=None) -> torch.Tensor:
    """Mix the push-sum weights ``w' = P @ w`` (shape (n,)) in float32 — a
    plain (n,) operation, the same neighbor gather as the bank for a
    :class:`NeighborList`.  Under ``shard`` the rank's rows of ``w`` go in
    and out; every rank mixes the whole gathered vector, so its rows equal
    the unsharded result bit for bit."""
    if shard is not None:
        return shard.rows(gossip_weights(P, shard.all_gather(w)))
    wf = w.float()
    if isinstance(P, TwoTierOp):
        n_pods, ps, _ = P.intra.shape
        intra = torch.bmm(P.intra, wf.reshape(n_pods, ps, 1)).reshape(-1)
        inter = torch.sum(P.inter.wgt * wf[P.inter.idx.long()], dim=1)
        return (intra + inter).to(w.dtype)
    if isinstance(P, NeighborList):
        return torch.sum(P.wgt * wf[P.idx.long()], dim=1).to(w.dtype)
    return (P.float() @ wf).to(w.dtype)


def debias(stacked_params, w: torch.Tensor):
    """z_i = x_i / w_i on every leaf of a client-stacked parameter dict."""

    def div(x):
        return x / w.reshape((x.shape[0],) + (1,) * (x.ndim - 1)).to(x.dtype)

    return tree_map(div, stacked_params)


def debias_bank(X: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """z_i = x_i / w_i on the flat (n, D) bank."""
    return X / w[:, None].to(X.dtype)


def consensus_error_bank(X: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Mean squared distance of de-biased rows from the bank average."""
    z = debias_bank(X, w)
    mean = X.mean(dim=0, keepdim=True)
    return torch.sum((z - mean) ** 2) / X.shape[0]


def consensus_error(stacked_params, w: torch.Tensor) -> torch.Tensor:
    """Mean squared distance of de-biased params from the true average
    (the quantity bounded by Lemma 4), summed over leaves in bank order."""
    z = debias(stacked_params, w)
    total = None
    for x, zx in zip(tree_flatten(stacked_params)[1], tree_flatten(z)[1]):
        mean = x.mean(dim=0, keepdim=True)
        err = torch.sum((zx - mean) ** 2) / x.shape[0]
        total = err if total is None else total + err
    return total
