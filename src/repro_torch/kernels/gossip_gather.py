"""Sparse push-sum mix ``Y[i] = sum_l wgt[i,l] X[idx[i,l]]`` over fixed-shape
``(n, k_max)`` receiver-side neighbor lists, f32 accumulation one slot at
a time in slot order, stored in X's dtype.

Replaces the TPU kernel ``repro.kernels.gossip_gather.gossip_gather_pallas``
with the CUDA C++ kernels in ``csrc/gossip_gather.cu``.  What bounds it on
the H100 is bytes (2 k_max flops per k_max elements read): X read once and
Y written once, 0.42 ms at n = 100, D = 1,756,426 in f32.  The panel
kernel gets there by staging each column panel of X (all n rows, C
columns) in shared memory once, through a 3-panel ring that a producer
warp fills with TMA bulk copies, in persistent blocks, and mixing every
receiver row of the panel from there with 16 consumer warps,
so the k_max source rows of a receiver are read from shared memory and
not k_max times through L2.  The bank's rows need not be 16-byte aligned
(D = 1,756,426 is 2 mod 4): ``csrc/panel_ring.cuh`` copies each row's
segment as whole aligned 16-byte chunks and keeps the row's offset within
its chunk.  Where not
even the narrowest panel of n rows fits in shared memory (32 columns in
f32, from n in the mid hundreds up; 16 bytes in bf16), the shape selects
the row kernel: one block per
(receiver row, D chunk), source rows read through L2.  Pad slots carry
weight 0 and add exactly 0; every index must lie in ``[0, n)``, which the
port's neighbor-list builders guarantee by construction.

``gossip_gather`` is the wrapper: a CPU tensor goes to
:func:`gossip_gather_plain`; a CUDA tensor goes to the kernel, or the
wrapper raises.  ``launches`` counts kernel launches.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.build import DTYPE_CODES, check, load_library

__all__ = ["gossip_gather", "gossip_gather_plain", "launches"]

launches = 0


def gossip_gather_plain(idx, wgt, X):
    """The kernel's slot loop in plain PyTorch (same f32 accumulation order:
    ``acc = w_0 x_0``, then ``acc += w_l x_l``)."""
    idx = idx.long()
    wgt = wgt.float()
    acc = wgt[:, 0, None] * X[idx[:, 0]].float()
    for slot in range(1, idx.shape[1]):
        acc = acc + wgt[:, slot, None] * X[idx[:, slot]].float()
    return acc.to(X.dtype)


def gossip_gather(idx, wgt, X):
    global launches
    if X.device.type == "cpu":
        return gossip_gather_plain(idx, wgt, X)
    if X.device.type != "cuda":
        raise ValueError(f"no gossip_gather kernel for device {X.device}")
    if X.dim() != 2 or X.dtype not in DTYPE_CODES:
        raise ValueError(
            f"X must be a float32/bfloat16 (n, D) bank, got {X.dtype} "
            f"{tuple(X.shape)}"
        )
    n, d = X.shape
    if idx.dim() != 2 or idx.shape[0] != n or idx.shape[1] < 1:
        raise ValueError(
            f"idx must be (n={n}, k_max >= 1), got {tuple(idx.shape)}"
        )
    if idx.dtype != torch.int32:
        raise TypeError(f"idx must be int32, got {idx.dtype}")
    if wgt.shape != idx.shape or wgt.dtype != torch.float32:
        raise ValueError("wgt must be float32 with idx's shape")
    for name, t in (("idx", idx), ("wgt", wgt), ("X", X)):
        if t.device != X.device:
            raise ValueError(f"{name} is on {t.device}, X on {X.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    lib = load_library()
    Y = torch.empty_like(X)
    with torch.cuda.device(X.device):
        rc = lib.gossip_gather_launch(
            DTYPE_CODES[X.dtype], idx.data_ptr(), wgt.data_ptr(), X.data_ptr(),
            Y.data_ptr(), n, idx.shape[1], d,
            torch.cuda.current_stream().cuda_stream,
        )
    check(rc, "gossip_gather")
    launches += 1
    return Y
