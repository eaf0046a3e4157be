"""Hand-written Hopper kernels of the port, one wrapper module each.

  gossip_matmul  — dense push-sum mix P @ X (tiled f32 SIMT product)
  gossip_gather  — sparse neighbor-list mix, O(n * k_max * D)
  fused_update   — Algorithm-1 inner loop (momentum + descent + de-bias)
  flash_attention — causal / sliding-window GQA attention, online softmax
                    (bf16 on the tensor cores, f32 in SIMT)

``ops`` holds the public entry points, ``ref`` the plain PyTorch oracles,
``build`` the lazy ``nvcc`` build of ``csrc/*.cu``.  Nothing is compiled or
loaded at import time.
"""
from repro_torch.kernels import ops, ref

__all__ = ["ops", "ref"]
