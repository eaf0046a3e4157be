"""Flash attention with a causal mask, a sliding window and grouped-query
heads: q is ``(B, H, S, hd)``, k and v are ``(B, KV, S, hd)``, and query head
h reads kv head ``h // (H // KV)``.  Scores are scaled by ``hd ** -0.5``,
masked scores are replaced by -1e30 (the window closes keys with
``q - k >= window`` whether or not the mask is causal), and the output has
q's dtype.

Replaces the TPU kernel ``repro.kernels.flash_attention.flash_attention_pallas``
with the CUDA C++ kernels in ``csrc/flash_attention.cu``.  What bounds them
on the H100 is operations (4 hd FLOP per open query/key pair).  bf16 inputs
run a warp-specialised kernel on the tensor cores (wgmma, K and V streamed
by TMA); f32 inputs run an f32 SIMT kernel, which keeps the f32 parity
checks at 2e-5.  Both visit only the key tiles that the masks leave open.
See the source note for the design.

``flash_attention`` is the wrapper: a CPU tensor goes to
:func:`flash_attention_plain`; a CUDA tensor goes to the kernel of its
dtype, or the wrapper raises.  Inputs are read through their strides (hd
contiguous), so a ``(B, S, H, hd)`` projection may be passed as its
``transpose(1, 2)`` view; the output is laid out like q.  bf16 inputs are
loaded by TMA, so they must start on 16 bytes and have (b, head, s) strides
that are multiples of 8 elements (the transposed views of ``gqa_forward``
always do).  The kernel has no backward, so the wrapper refuses inputs that
require grad.  ``launches`` counts kernel launches of both dtypes.
:func:`bf16_tolerance` states how far the bf16 kernel may lie from the plain
version.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.build import DTYPE_CODES, check, load_library

__all__ = ["bf16_tolerance", "flash_attention", "flash_attention_plain",
           "HEAD_DIMS", "launches"]

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


def bf16_tolerance(v, out, causal: bool = True, window: int = 0):
    """Per-element bound on ``|kernel - plain|`` for bf16 inputs, where
    ``out`` is the plain version's output (B, H, S, hd):
    ``2e-5 + 2^-8 max_row|v| + 2^-7 |out|``, with ``max_row|v|`` the
    largest |v| over the keys that the row's mask leaves open.

    Derivation.  Products of bf16 values are exact in f32, so the kernel's
    scores, row max and denominator l = sum_j p_j are the plain version's up
    to the order of f32 sums (the 2e-5, as in f32).  The one new rounding is
    p_j to bf16 before P.V, p~_j = p_j (1 + d_j) with |d_j| <= 2^-8 (bf16's
    unit roundoff), so the f32 output moves by
    |sum_j (p~_j - p_j) v_j| / l <= 2^-8 sum_j p_j |v_j| / l
    <= 2^-8 max_j |v_j| over the open keys j.  Both sides then round the
    f32 output to bf16: at most one bf16 ulp apart, 2^-7 |out|."""
    b, kv, s, hd = v.shape
    vmax = v.float().abs().amax(-1)  # (B, KV, S): per key
    open_ = _mask(s, causal, window, v.device)  # (S queries, S keys)
    row = torch.where(open_, vmax[:, :, None, :], 0.0).amax(-1)  # (B, KV, S)
    row = row.repeat_interleave(out.shape[1] // kv, dim=1)[..., None]
    return 2e-5 + 2.0 ** -8 * row + 2.0 ** -7 * out.float().abs()


def _check_tma(q, k, v):
    """What the bf16 kernel's TMA loads need: a 16-byte aligned base and
    (b, head, s) strides that are multiples of 8 elements (16 bytes) on
    every dimension longer than 1."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.data_ptr() % 16:
            raise ValueError(f"bf16 {name} must start on 16 bytes for TMA, "
                             f"got address {t.data_ptr():#x}")
        bad = [st for n, st in zip(t.shape[:3], t.stride()[:3])
               if n > 1 and st % 8]
        if bad:
            raise ValueError(f"bf16 {name} needs (b, head, s) strides that "
                             f"are multiples of 8 elements for TMA, got "
                             f"{tuple(t.stride()[:3])}")


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
    if q.dtype == torch.bfloat16:
        _check_tma(q, k, v)
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
