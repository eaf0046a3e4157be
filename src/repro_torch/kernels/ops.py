"""Public kernel entry points of the port — the counterpart of
``repro.kernels.ops``.

Every call goes to the wrapper of its kernel, which launches the CUDA
kernel for a CUDA tensor and takes the plain PyTorch version for a CPU
tensor.  Unlike the reference there is no size threshold: the reference's
``_GOSSIP_KERNEL_MIN_ELEMS`` exists only for the interpret-mode overhead of
Pallas on the CPU.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention import flash_attention as _flash_kernel
from repro_torch.kernels.fused_update import fused_update_bank as _bank_kernel
from repro_torch.kernels.gossip_gather import (
    gossip_gather,
    gossip_gather_halo,
    gossip_gather_xla,
)
from repro_torch.kernels.gossip_matmul import gossip_matmul

__all__ = [
    "gossip_mix",
    "gossip_mix_sparse",
    "use_sparse_gossip",
    "fused_update",
    "fused_update_bank",
    "flash_attention",
]

# Sparse-vs-dense representation dispatch (the reference's rule at
# repro/kernels/ops.py:57-67, with the port's own constants per device).
# The CUDA pair comes from chip_smoke.py's crossover phase, which times the
# dense kernel against the gather kernel at the main path's D (cifar_cnn,
# 1,756,426) over n = 4..128 and k_max = 1..n (device time, the median of
# 5 repeats) and counts a pair as lost by the gather only beyond 1.10x the
# dense time.  On an H100 80GB HBM3 at its 700 W limit, with both mixes'
# Hopper kernels (TMA-fed panels in shared memory), the gather was faster
# at every pair with k_max <= n/4 but (128, 32), where it took 1.05x the
# dense time, and lost from k_max = 3n/8 on at n = 128 (1.47x), from n/2
# at n = 64 (1.19x) and from 3n/4 at n = 32 (1.34x); the floor is the
# least n that k_max = 1 passes.  The CPU pair is the reference's.
_SPARSE_GOSSIP_MIN_CLIENTS_CUDA = 4
_SPARSE_GOSSIP_MAX_DENSITY_CUDA = 0.25
_SPARSE_GOSSIP_MIN_CLIENTS_CPU = 128
_SPARSE_GOSSIP_MAX_DENSITY_CPU = 0.25


def use_sparse_gossip(n: int, k_max: int, device="cuda") -> bool:
    """THE density rule: neighbor-list gossip iff ``n`` is at least the
    device's ``_SPARSE_GOSSIP_MIN_CLIENTS_*`` floor and ``k_max / n`` is at
    most its ``_SPARSE_GOSSIP_MAX_DENSITY_*``."""
    if torch.device(device).type == "cuda":
        floor, density = (_SPARSE_GOSSIP_MIN_CLIENTS_CUDA,
                          _SPARSE_GOSSIP_MAX_DENSITY_CUDA)
    else:
        floor, density = (_SPARSE_GOSSIP_MIN_CLIENTS_CPU,
                          _SPARSE_GOSSIP_MAX_DENSITY_CPU)
    return n >= floor and k_max <= density * n


def gossip_mix(P, M, shard=None):
    """One dense mixing matmul ``M' = P @ M`` (f32 accumulation).  Under a
    row-sharded bank (``shard``, with ``M`` the rank's rows) the rank's row
    panel of ``P`` over the all-gathered bank: a dense operator has no
    sparse row set to ship, so every executor takes the all-gather."""
    if shard is not None:
        return gossip_matmul(shard.rows(P.float()),
                             shard.all_gather(M.contiguous()))
    return gossip_matmul(P.float().contiguous(), M.contiguous())


def gossip_mix_sparse(idx, wgt, M, backend=None, shard=None):
    """Sparse mixing ``M'[i] = sum_l wgt[i,l] * M[idx[i,l]]``.  ``backend``
    is the executor of ``comm.plan.resolve_backend``: a ``HaloBackend``
    takes the halo exchange, ``None`` and ``"xla"`` the all-gather (no
    collective without ``shard``)."""
    idx = idx.to(torch.int32).contiguous()
    wgt = wgt.float().contiguous()
    M = M.contiguous()
    if backend is not None and not isinstance(backend, str):
        return gossip_gather_halo(idx, wgt, M, shard=shard, plan=backend.plan)
    if shard is not None:
        return gossip_gather_xla(idx, wgt, M, shard)
    return gossip_gather(idx, wgt, M)


def fused_update_bank(X, V, G, alpha, eta, w):
    """Fused momentum/descent/de-bias over the whole (n, D) flat bank.  G is
    cast to the bank dtype first, as the reference kernel call does."""
    return _bank_kernel(
        X.contiguous(), V.float().contiguous(), G.to(X.dtype).contiguous(),
        alpha, eta, w.float().contiguous(),
    )


def fused_update(x, v, g, alpha, eta, w):
    """The single-row update: the ``(1, D)`` case of the bank kernel with a
    scalar push-sum weight ``w``."""
    w1 = torch.full((1,), float(w), dtype=torch.float32, device=x.device)
    xo, vo, zo = fused_update_bank(x[None], v[None], g[None], alpha, eta, w1)
    return xo[0], vo[0], zo[0]


def flash_attention(q, k, v, causal=True, window=0):
    """Causal / sliding-window GQA attention, the counterpart of the
    reference's ``ops.flash_attention``: q is (B,H,S,hd), k and v are
    (B,KV,S,hd), any S.  Views with a contiguous head dim pass through
    without a copy (the kernel reads strides).  Inputs that require grad
    differentiate through the hand-written backward kernel."""
    return _flash_kernel(q, k, v, causal=bool(causal), window=int(window))
