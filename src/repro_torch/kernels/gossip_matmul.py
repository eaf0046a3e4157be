"""Dense push-sum mix ``Y = P @ X`` over the (n, D) bank, f32 accumulation,
stored in X's dtype.  ``P`` is (n, n), or a row panel (m, n) of it: a
row-sharded bank's own m rows of the mix over the gathered bank.

Replaces the TPU kernel ``repro.kernels.gossip_matmul.gossip_matmul_pallas``
with the CUDA C++ kernels in ``csrc/gossip_matmul.cu``: f32 SIMT products
(no TF32, no tensor cores — the reference mixes at ``Precision.HIGHEST``),
each output summing its n products in ascending order.  At the slice's
n = 100 it is bound by f32 operations (2 n^2 D flops over 2 n D elements,
n/4 flop per byte; 0.52 ms at D = 1,756,426), at n = 8 by bytes.  For
n <= 128 the resident kernel keeps P whole in shared memory and streams
X in 192-column panels (128 past n = 104) through a ring that a producer
warp fills with TMA bulk copies (``csrc/panel_ring.cuh``, whole aligned
16-byte chunks whatever the rows' alignment), with rows padded only to a
multiple of 8 and at most 13 x 6 accumulators a thread; larger n takes the
tiled kernel (128 x 128 tiles of Y).  A row panel with m, n <= 128 takes
the resident kernel with m rows of P resident and n rows a stage (128
columns, 2 stages), else the tiled kernel; each output sums its n
products in the square mix's order, so a panel's rows equal the square
mix's rows bit for bit.

``gossip_matmul`` is the wrapper: a CPU tensor goes to
:func:`gossip_matmul_plain`; a CUDA tensor goes to the kernel, or the
wrapper raises; a meta tensor gets an empty output of the kernel's shape.
``launches`` counts kernel launches; every call records its cost
(``repro_torch.roofline.cost.dense_mix_cost``) in a counting ``CostMode``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.build import DTYPE_CODES, check, load_library
from repro_torch.roofline.cost import dense_mix_cost
from repro_torch.roofline.cost import kernel as kernel_cost

__all__ = ["gossip_matmul", "gossip_matmul_plain", "launches"]

launches = 0


def gossip_matmul_plain(P, X):
    """``(P @ X)`` in float32, cast to X's dtype (TF32 must be off on CUDA)."""
    return (P.float() @ X.float()).to(X.dtype)


def gossip_matmul(P, X):
    global launches
    dev = X.device.type
    if dev not in ("cpu", "cuda", "meta"):
        raise ValueError(f"no gossip_matmul kernel for device {X.device}")
    with kernel_cost("gossip_matmul", lambda: dense_mix_cost(
            P.shape[0], *X.shape, X.element_size())):
        if dev == "cpu":
            return gossip_matmul_plain(P, X)
        if X.dim() != 2 or X.dtype not in DTYPE_CODES:
            raise ValueError(
                f"X must be a float32/bfloat16 (n, D) bank, got {X.dtype} "
                f"{tuple(X.shape)}"
            )
        n, d = X.shape
        if (P.dim() != 2 or P.shape[1] != n or P.shape[0] < 1
                or P.dtype != torch.float32):
            raise ValueError(f"P must be float32 of shape (m, {n}), got "
                             f"{P.dtype} {tuple(P.shape)}")
        if P.device != X.device:
            raise ValueError(f"P is on {P.device}, X on {X.device}")
        if not (P.is_contiguous() and X.is_contiguous()):
            raise ValueError("P and X must be contiguous")
        m = P.shape[0]
        Y = X.new_empty((m, d))
        if dev == "meta":  # the output's shape, no computation
            return Y
        lib = load_library()
        stream = torch.cuda.current_stream(X.device).cuda_stream
        with torch.cuda.device(X.device):
            rc = lib.gossip_matmul_launch(
                DTYPE_CODES[X.dtype], P.data_ptr(), X.data_ptr(), Y.data_ptr(),
                m, n, d, stream)
        check(rc, "gossip_matmul")
        launches += 1
        return Y
