#!/usr/bin/env python3
"""What holds the two gossip mixes' kernels back, measured: each kernel
beside two variants of itself, built from the same sources with one of
the diagnosis defines of ``csrc/panel_ring.cuh``.

    python3 mix_diagnose.py

* ``kernel``: the library as the port builds it;
* ``copy only`` (``PANEL_DIAG_COPY_ONLY``): the consumers release each
  panel unread, so the block moves X into shared memory and nothing else
  (no Y);
* ``compute only`` (``PANEL_DIAG_COMPUTE_ONLY``): the producer copies
  nothing (it only arrives on each stage's barrier), so the consumers mix
  whatever shared memory holds and store Y: the arithmetic from shared
  memory and the stores alone.

All three run in one process on one card, in the order kernel, copy only,
compute only, compute only, copy only, kernel, at n = 8 and 100 clients
(kout, k_out = min(10, n - 1)) and the main path's D = 1,756,426, in f32
and bf16, each time beside its bound.  The variants' entry points are
called directly (the wrappers launch the port's own library); each
library is built under ``build/`` beside it.  Without a CUDA card it
exits nonzero.
"""
from __future__ import annotations

import sys
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE / "src"))

import chip_smoke  # noqa: E402  (timing and bounds, shared with the smoke)

D = chip_smoke.CIFAR_CNN_DIM
VARIANTS = {"kernel": (), "copy only": ("PANEL_DIAG_COPY_ONLY",),
            "compute only": ("PANEL_DIAG_COMPUTE_ONLY",)}


def main() -> int:
    if not torch.cuda.is_available():
        print("mix_diagnose.py needs a CUDA card; none is available",
              file=sys.stderr)
        return 2
    from repro_torch.core import topology
    from repro_torch.kernels import build

    dev = torch.device("cuda")
    card = chip_smoke.card_line()
    print(f"card: {card}")
    libs = {name: build.open_library(defs) for name, defs in VARIANTS.items()}
    gen = torch.Generator(device=dev).manual_seed(4)
    cases = []
    for n in (8, 100):
        P = topology.sample_kout(gen, n, min(10, n - 1))
        nl = topology.sample_kout_neighbors(gen, n, min(10, n - 1))
        for dt in (torch.float32, torch.bfloat16):
            X = torch.randn(n, D, generator=gen, device=dev).to(dt)
            cases.append((n, dt, P.contiguous(), nl.idx.contiguous(),
                          nl.wgt.contiguous(), X, torch.empty_like(X)))
    order = ["kernel", "copy only", "compute only", "compute only",
             "copy only", "kernel"]
    for name in order:
        lib = libs[name]
        for n, dt, P, idx, wgt, X, Y in cases:
            es, k, code = X.element_size(), idx.shape[1], build.DTYPE_CODES[dt]

            def dense():
                build.check(lib.gossip_matmul_launch(
                    code, P.data_ptr(), X.data_ptr(), Y.data_ptr(), n, n, D,
                    torch.cuda.current_stream().cuda_stream), "gossip_matmul")

            def gather():
                build.check(lib.gossip_gather_launch(
                    code, idx.data_ptr(), wgt.data_ptr(), X.data_ptr(),
                    Y.data_ptr(), n, n, k, D,
                    torch.cuda.current_stream().cuda_stream), "gossip_gather")

            mm = chip_smoke.timed_ms(dense, dev, 20)
            ga = chip_smoke.timed_ms(gather, dev, 20)
            mm_b, mm_by = chip_smoke.bound_ms(4.0 * n * n + 2.0 * es * n * D,
                                              2.0 * n * n * D)
            ga_b, ga_by = chip_smoke.bound_ms(2.0 * es * n * D + 8.0 * n * k,
                                              2.0 * n * k * D)
            print(f"{name:12s} n={n:3d} {str(dt)[6:]:8s}: gossip_matmul "
                  f"{mm:.4f} ms (bound {mm_b:.4f}, {mm_by}); gossip_gather "
                  f"k_max={k} {ga:.4f} ms (bound {ga_b:.4f}, {ga_by})")
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
