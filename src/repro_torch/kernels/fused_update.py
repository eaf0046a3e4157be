"""Fused DFedSGPSM inner-loop update (Algorithm 1 lines 9-11 + 5) on the
(n, D) bank: ``V' = alpha V + G``, ``X' = X - eta V'``, ``Z' = X' / w``.

Replaces the TPU kernel ``repro.kernels.fused_update.fused_update_bank_pallas``
(and ``fused_update_pallas``, its one-row case) with the CUDA C++ kernel in
``csrc/fused_update.cu``.  What bounds it on the H100 is bytes: 24 B per
element in f32 (3 reads, 3 writes) against 5 flops, so the kernel is one
streaming pass of 16-byte vector loads over the flat bank; see the source
note for the design.

``fused_update_bank`` is the wrapper: a CPU tensor goes to
:func:`fused_update_bank_plain`; a CUDA tensor goes to the kernel, or the
wrapper raises; a meta tensor gets empty outputs of the kernel's shapes.
Every call records its cost (``repro_torch.roofline.cost.update_cost``) in
a counting ``CostMode``.  ``launches`` counts kernel launches; ``row_launches``
counts those of one row (n = 1), the case that replaces ``fused_update_pallas``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.build import DTYPE_CODES, check, load_library
from repro_torch.roofline.cost import kernel as kernel_cost
from repro_torch.roofline.cost import update_cost

__all__ = ["fused_update_bank", "fused_update_bank_plain", "launches",
           "row_launches"]

launches = 0
row_launches = 0


def fused_update_bank_plain(X, V, G, alpha, eta, w):
    """The kernel's arithmetic in plain PyTorch: f32 math, ``Z' = X' * (1/w)``
    (the multiply form of the TPU kernel), outputs in (X.dtype, f32, X.dtype)."""
    v_new = float(alpha) * V.float() + G.float()
    x_new = X.float() - float(eta) * v_new
    w_inv = 1.0 / w.float()
    z_new = x_new * w_inv[:, None]
    return x_new.to(X.dtype), v_new, z_new.to(X.dtype)


def _check_cuda_args(X, V, G, w):
    if X.dim() != 2:
        raise ValueError(f"X must be (n, D), got shape {tuple(X.shape)}")
    if X.dtype not in DTYPE_CODES:
        raise TypeError(f"bank dtype must be float32 or bfloat16, got {X.dtype}")
    if V.shape != X.shape or V.dtype != torch.float32:
        raise ValueError("V must be float32 with X's shape")
    if G.shape != X.shape or G.dtype != X.dtype:
        raise ValueError("G must have X's shape and dtype (cast it first)")
    if w.shape != (X.shape[0],) or w.dtype != torch.float32:
        raise ValueError("w must be float32 of shape (n,)")
    for name, t in (("X", X), ("V", V), ("G", G), ("w", w)):
        if t.device != X.device:
            raise ValueError(f"{name} is on {t.device}, X on {X.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def fused_update_bank(X, V, G, alpha, eta, w):
    """Returns ``(X', V', Z')``: X' and Z' in X's dtype, V' in float32."""
    global launches, row_launches
    dev = X.device.type
    if dev not in ("cpu", "cuda", "meta"):
        raise ValueError(f"no fused_update kernel for device {X.device}")
    with kernel_cost("fused_update_bank", lambda: update_cost(
            *X.shape, X.element_size())):
        if dev == "cpu":
            return fused_update_bank_plain(X, V, G, alpha, eta, w)
        _check_cuda_args(X, V, G, w)
        Xo = torch.empty_like(X)
        Vo = torch.empty_like(V)
        Zo = torch.empty_like(X)
        if dev == "meta":  # the outputs' shapes, no computation
            return Xo, Vo, Zo
        lib = load_library()
        n, d = X.shape
        with torch.cuda.device(X.device):
            stream = torch.cuda.current_stream().cuda_stream
            rc = lib.fused_update_bank_launch(
                DTYPE_CODES[X.dtype], X.data_ptr(), V.data_ptr(), G.data_ptr(),
                w.data_ptr(), Xo.data_ptr(), Vo.data_ptr(), Zo.data_ptr(),
                float(alpha), float(eta), n, d, stream,
            )
        check(rc, "fused_update_bank")
        launches += 1
        if n == 1:
            row_launches += 1
        return Xo, Vo, Zo
