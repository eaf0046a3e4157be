"""Flash attention with a causal mask, a sliding window and grouped-query
heads: q is ``(B, H, S, hd)``, k and v are ``(B, KV, S, hd)``, and query head
h reads kv head ``h // (H // KV)``.  Scores are scaled by ``hd ** -0.5``,
masked scores are replaced by -1e30 (the window closes keys with
``q - k >= window`` whether or not the mask is causal), and the output has
q's dtype.

Replaces the TPU kernel ``repro.kernels.flash_attention.flash_attention_pallas``
with the CUDA C++ kernel in ``csrc/flash_attention.cu``.  What bounds it on
the H100 is operations (4 hd FLOP per open query/key pair); this first
version computes scores and P.V in f32 SIMT arithmetic, and visits only the
key tiles that the masks leave open.  See the source note for the design.

``flash_attention`` is the wrapper: a CPU tensor goes to
:func:`flash_attention_plain`; a CUDA tensor goes to the kernel, or the
wrapper raises.  Inputs are read through their strides (hd contiguous), so
a ``(B, S, H, hd)`` projection may be passed as its ``transpose(1, 2)``
view; the output is laid out like q.  The kernel has no backward, so the
wrapper refuses inputs that require grad.  ``launches`` counts kernel
launches.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.build import DTYPE_CODES, check, load_library

__all__ = ["flash_attention", "flash_attention_plain", "HEAD_DIMS", "launches"]

HEAD_DIMS = (64, 128, 256)  # the head sizes the kernel is built for
NEG = -1.0e30

launches = 0


def _mask(s: int, causal: bool, window: int, device) -> torch.Tensor:
    """(S, S) boolean: True where query row q may attend key column k."""
    qi = torch.arange(s, device=device)[:, None]
    ki = torch.arange(s, device=device)[None, :]
    ok = ki <= qi if causal else torch.ones(s, s, dtype=torch.bool,
                                            device=device)
    if window > 0:
        ok = ok & (qi - ki < window)
    return ok


def flash_attention_plain(q, k, v, causal: bool = True, window: int = 0):
    """The kernel's function in plain PyTorch: q scaled in f32 before the
    product, masked scores set to -1e30, softmax, P.V in f32, q's dtype.
    GQA by a (KV, group) split of the query heads, with no repeat."""
    b, h, s, hd = q.shape
    kv = k.shape[1]
    qf = (q.float() * hd ** -0.5).unflatten(1, (kv, h // kv))
    scores = torch.einsum("bkgqd,bksd->bkgqs", qf, k.float())
    scores = scores.masked_fill(~_mask(s, causal, window, q.device), NEG)
    out = torch.einsum("bkgqs,bksd->bkgqd", scores.softmax(-1), v.float())
    return out.flatten(1, 2).to(q.dtype)


def _check_cuda_args(q, k, v, window):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k and v must be 4-D: (B, H, S, hd), "
                         "(B, KV, S, hd), (B, KV, S, hd)")
    b, h, s, hd = q.shape
    kv = k.shape[1]
    if k.shape != (b, kv, s, hd) or v.shape != k.shape:
        raise ValueError(f"k and v must be (B, KV, S, hd) = (b, kv, {s}, "
                         f"{hd}) with q {tuple(q.shape)}; got k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    if kv < 1 or h % kv:
        raise ValueError(f"query heads {h} are not a multiple of kv heads {kv}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"head dim {hd} has no kernel; built for {HEAD_DIMS}")
    if q.dtype not in DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k and v must share a float32/bfloat16 dtype, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    for name, t in (("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(-1) != 1:
            raise ValueError(f"{name} must have a contiguous head dim")
    if window < 0:
        raise ValueError(f"window must be >= 0, got {window}")


def flash_attention(q, k, v, causal: bool = True, window: int = 0):
    global launches
    if q.requires_grad or k.requires_grad or v.requires_grad:
        raise RuntimeError(
            "flash_attention has no backward: call it on tensors that do not "
            "require grad (e.g. under torch.inference_mode())")
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal, window)
    if q.device.type != "cuda":
        raise ValueError(f"no flash_attention kernel for device {q.device}")
    _check_cuda_args(q, k, v, window)
    b, h, s, hd = q.shape
    # q's layout where q is dense (preserve_format), else contiguous: either
    # way hd is contiguous.
    o = torch.empty_like(q)
    lib = load_library()
    with torch.cuda.device(q.device):
        rc = lib.flash_attention_launch(
            DTYPE_CODES[q.dtype], hd, q.data_ptr(), k.data_ptr(), v.data_ptr(),
            o.data_ptr(), b, h, k.shape[1], s, *q.stride()[:3],
            *k.stride()[:3], *v.stride()[:3], *o.stride()[:3], int(causal),
            int(window), torch.cuda.current_stream().cuda_stream,
        )
    check(rc, "flash_attention")
    launches += 1
    return o
