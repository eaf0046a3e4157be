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
Both are built for head dims 64, 80 (hubert-xlarge), 128 and 256
(``HEAD_DIMS``).  See the source note for the design.

``flash_attention`` is the wrapper: a CPU tensor goes to
:func:`flash_attention_plain`; a CUDA tensor goes to the kernel of its
dtype, or the wrapper raises; a meta tensor gets empty outputs of the
kernel's shapes (the dry-run's trace, ``repro_torch.launch.dryrun``).  Every
call records its cost (``repro_torch.roofline.cost.flash_forward_cost``) in
a counting ``CostMode``.  Inputs are read through their strides (hd
contiguous), so a ``(B, S, H, hd)`` projection may be passed as its
``transpose(1, 2)`` view; the output is laid out like q.  bf16 inputs are
loaded by TMA, so they must start on 16 bytes and have (b, head, s) strides
that are multiples of 8 elements (the transposed views of ``gqa_forward``
always do).  ``launches`` counts kernel launches of both dtypes, and
``head_dim_launches`` the same launches by head dim.
:func:`bf16_tolerance` states how far the bf16 kernel may lie from the plain
version.

Inputs that require grad go through a ``torch.autograd.Function`` whose
forward also keeps each row's logsumexp (the kernel stores it in its
epilogue; :func:`flash_attention_plain` returns ``torch.logsumexp`` of the
masked scores on the CPU) and whose backward is
:func:`flash_attention_backward`: the CUDA kernels of
``csrc/flash_attention_bwd.cu`` on the card, :func:`flash_attention_backward_plain`
on the CPU.  The TPU package has no Pallas backward (its training path
differentiates the plain attention with JAX); this one computes the
gradient of the forward's function from q, k, v, the forward's output o,
its logsumexp and dO.  bf16 runs tensor-core passes at every head dim (a
D pass, a dK / dV pass and a dQ pass on wgmma, fed by TMA, and a
fixed-order sum of dK / dV shares where a GQA group is split; hd 80 in the
forward's 16-column panels; hd 256 on 64-row tiles whose work the two
consumer warpgroups split); f32 at every head dim runs f32 SIMT passes.
It is built for the forward's head dims (``BACKWARD_HEAD_DIMS``); at
another one it raises ``NotImplementedError`` on the card.
``backward_launches`` counts its calls,
``backward_head_dim_launches`` the same calls by head dim and
``backward_kernel_launches`` the kernels those calls launched.
:func:`backward_tolerance` states how far it may lie from its plain
version, :func:`lse_tolerance` how far the forward's logsumexp may lie from
``torch.logsumexp``.  The backward's CUDA call takes raw pointers, so the
gradient is taken with ``torch.autograd`` (``torch.func`` transforms hand
the backward wrapper tensors without storage).  On a meta tensor the
backward returns empty gradients after allocating the scratch the kernels
take (:func:`backward_shares` says how many f32 shares), and records its
cost (``flash_backward_cost``) as the forward does.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.build import DTYPE_CODES, check, load_library
from repro_torch.roofline.cost import (
    flash_backward_cost,
    flash_forward_cost,
)
from repro_torch.roofline.cost import kernel as kernel_cost

__all__ = ["BACKWARD_HEAD_DIMS", "BWD_TILE_ROWS", "backward_shares", "backward_tolerance",
           "bf16_tolerance", "flash_attention", "flash_attention_backward",
           "flash_attention_backward_plain", "flash_attention_plain",
           "flash_attention_with_lse", "HEAD_DIMS", "head_dim_launches",
           "launches", "backward_launches", "backward_head_dim_launches",
           "backward_kernel_launches", "lse_tolerance"]

HEAD_DIMS = (64, 80, 128, 256)  # the head sizes the forward is built for
BACKWARD_HEAD_DIMS = HEAD_DIMS  # the backward is built for the forward's
# Keys in a dK / dV tile (``tc::tile_rows`` in csrc/flash_attention_bwd.cu):
# 64 at the head dims listed here, else 128.
BWD_TILE_ROWS = {256: 64}
NEG = -1.0e30

launches = 0
head_dim_launches = dict.fromkeys(HEAD_DIMS, 0)  # ``launches`` by head dim
backward_launches = 0  # calls of the backward
# ``backward_launches`` by head dim
backward_head_dim_launches = dict.fromkeys(BACKWARD_HEAD_DIMS, 0)
backward_kernel_launches = 0  # the kernels those calls launched


def _mask(s: int, causal: bool, window: int, device) -> torch.Tensor:
    """(S, S) boolean: True where query row q may attend key column k."""
    qi = torch.arange(s, device=device)[:, None]
    ki = torch.arange(s, device=device)[None, :]
    ok = ki <= qi if causal else torch.ones(s, s, dtype=torch.bool,
                                            device=device)
    if window > 0:
        ok = ok & (qi - ki < window)
    return ok


def _wide(t):
    """``t`` in f32, or in its own dtype where that is wider (f64, which the
    gradient checks use)."""
    return t.to(torch.promote_types(t.dtype, torch.float32))


def _scores(q, k, causal: bool, window: int):
    """The masked, scaled scores (B, KV, group, S, S) in f32 (or f64): q
    scaled before the product, masked scores set to -1e30."""
    b, h, s, hd = q.shape
    kv = k.shape[1]
    qf = (_wide(q) * hd ** -0.5).unflatten(1, (kv, h // kv))
    scores = torch.einsum("bkgqd,bksd->bkgqs", qf, _wide(k))
    return scores.masked_fill(~_mask(s, causal, window, q.device), NEG)


def flash_attention_plain(q, k, v, causal: bool = True, window: int = 0,
                          return_lse: bool = False):
    """The kernel's function in plain PyTorch: q scaled in f32 before the
    product, masked scores set to -1e30, softmax, P.V in f32, q's dtype.
    GQA by a (KV, group) split of the query heads, with no repeat.  With
    ``return_lse`` also each row's ``torch.logsumexp`` of its masked
    scores, (B, H, S) in f32 (f64 for f64 inputs): what the kernel stores
    for the backward."""
    scores = _scores(q, k, causal, window)
    out = torch.einsum("bkgqs,bksd->bkgqd", scores.softmax(-1), _wide(v))
    out = out.flatten(1, 2).to(q.dtype)
    if return_lse:
        return out, torch.logsumexp(scores, -1).flatten(1, 2)
    return out


def bf16_tolerance(v, out, causal: bool = True, window: int = 0):
    """Per-element bound on ``|kernel - plain|`` for bf16 inputs, where
    ``out`` is the plain version's output (B, H, S, hd):
    ``2e-5 + 2^-8 max_row|v| + 2^-7 |out|``, with ``max_row|v|`` the
    largest |v| over the keys that the row's mask leaves open.

    Derivation.  Products of bf16 values are exact in f32, so the kernel's
    scores, row max and denominator l = sum_j p_j are the plain version's up
    to the order of f32 sums and to where the scale hd^-0.5 is applied (to
    q before the product in the plain version, to the f32 scores in the
    kernel: a few f32 roundings apart, at every head dim whether or not the
    scale is a power of two, 80^-0.5 and 128^-0.5 included), the 2e-5, as
    in f32.  The one new rounding is
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


def lse_tolerance(q, k, lse, causal: bool = True, window: int = 0):
    """Per-element bound on ``|kernel lse - plain lse|`` for the forward's
    logsumexp, where ``lse`` is the plain one (B, H, S):
    ``u (2 (hd + 6) s_max + 2 S + 4 |lse| + 16)``, u = 2^-24, s_max the
    largest |q| |k|^T hd^-0.5 of an open pair.

    Derivation.  Each side's scores lie within (hd + 2) u s_max of the
    exact ones (q scaled, hd products and their sum in f32), and
    logsumexp moves by at most the largest change of a score: 2 (hd + 2) u
    s_max between the sides.  The kernel then takes the row max exactly and
    sums S terms 2^((s - m) c) (c = hd^-0.5 log2 e): the exponent's f32
    evaluation is off by at most 4 u s_max in natural units, the ex2
    approximation by 4 u relative, the sum of S positive terms by S u
    relative; the plain side's exp and sum are within S u too; log2 l, the
    product m c and the conversion to natural units add 4 u |lse|, the
    rest 16 u.  A worst-case bound: measured errors are far smaller."""
    b, h, s, hd = q.shape
    kv = k.shape[1]
    qa = (q.float().abs() * hd ** -0.5).unflatten(1, (kv, h // kv))
    s_max = float(torch.einsum("bkgqd,bksd->bkgqs", qa, k.float().abs())
                  .masked_fill(~_mask(s, causal, window, q.device), 0.0)
                  .amax())
    u = 2.0 ** -24
    return u * (2 * (hd + 6) * s_max + 2 * s + 4 * lse.float().abs() + 16)


def _forward(q, k, v, causal: bool, window: int, want_lse: bool = False):
    """o, or (o, lse) with ``want_lse``."""
    global launches
    dev = q.device.type
    if dev not in ("cpu", "cuda", "meta"):
        raise ValueError(f"no flash_attention kernel for device {q.device}")
    with kernel_cost("flash_attention", lambda: flash_forward_cost(
            *q.shape[:2], k.shape[1], *q.shape[2:], causal, window,
            q.element_size(), want_lse)):
        if dev == "cpu":  # laid out like q, as the kernel's output
            out = flash_attention_plain(q, k, v, causal, window, want_lse)
            o = torch.empty_like(q).copy_(out[0] if want_lse else out)
            return (o, out[1]) if want_lse else o
        _check_cuda_args(q, k, v, window)
        if q.dtype == torch.bfloat16:
            _check_tma(q, k, v)
        b, h, s, hd = q.shape
        # q's layout where q is dense (preserve_format), else contiguous:
        # either way hd is contiguous.
        o = torch.empty_like(q)
        lse = (torch.empty(b, h, s, dtype=torch.float32, device=q.device)
               if want_lse else None)
        if dev == "meta":  # the outputs' shapes, no computation
            return (o, lse) if want_lse else o
        lib = load_library()
        with torch.cuda.device(q.device):
            rc = lib.flash_attention_launch(
                DTYPE_CODES[q.dtype], hd, q.data_ptr(), k.data_ptr(),
                v.data_ptr(), o.data_ptr(),
                None if lse is None else lse.data_ptr(), b, h, k.shape[1], s,
                *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                *o.stride()[:3], int(causal), int(window),
                torch.cuda.current_stream().cuda_stream,
            )
        check(rc, "flash_attention")
        launches += 1
        head_dim_launches[hd] += 1
        return (o, lse) if want_lse else o


class _FlashAttention(torch.autograd.Function):
    """The forward kernel, keeping each row's logsumexp, with
    :func:`flash_attention_backward` as its gradient (q, k and v; the masks
    and the logsumexp get none)."""

    @staticmethod
    def forward(q, k, v, causal, window):
        return _forward(q, k, v, causal, window, want_lse=True)

    @staticmethod
    def setup_context(ctx, inputs, output):
        q, k, v, causal, window = inputs
        o, lse = output
        ctx.mark_non_differentiable(lse)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.window = causal, window

    @staticmethod
    def backward(ctx, do, _dlse):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_backward(q, k, v, o, do, ctx.causal,
                                              ctx.window, lse=lse)
        return dq, dk, dv, None, None


def _refuse_dtensor(*ts) -> None:
    """The kernels read raw pointers of whole tensors: a DTensor's would be
    its rank's shard read as the whole, so a DTensor argument raises.  The
    pod runtime calls the kernels on the local shards
    (``models.attention._local_attention``)."""
    for t in ts:
        if isinstance(t, torch.Tensor) and type(t) is not torch.Tensor:
            from torch.distributed.tensor import DTensor

            if isinstance(t, DTensor):
                raise TypeError(
                    "flash attention takes plain tensors, not a DTensor: run "
                    "it on each rank's local shards (to_local) inside a "
                    "manual region")


def flash_attention(q, k, v, causal: bool = True, window: int = 0):
    _refuse_dtensor(q, k, v)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _FlashAttention.apply(q, k, v, causal, window)[0]
    return _forward(q, k, v, causal, window)


def flash_attention_with_lse(q, k, v, causal: bool = True, window: int = 0):
    """(o, lse) with no autograd: the forward as training runs it, each
    row's logsumexp (B, H, S) f32 beside the output (the kernel's on the
    card, the plain version's on the CPU)."""
    _refuse_dtensor(q, k, v)
    return _forward(q, k, v, causal, window, want_lse=True)


def flash_attention_backward_plain(q, k, v, o, do, causal: bool = True,
                                   window: int = 0, lse=None):
    """The backward kernel's function in plain PyTorch, in f32: each row's
    logsumexp over its open keys (``lse`` (B, H, S) where given, as the
    forward returns it, else recomputed: the same values),
    P = exp(s - lse) (0 on masked pairs), D = rowsum(dO o),
    dS = P (dO v^T - D), then dQ = dS k hd^-0.5, dK = dS^T q hd^-0.5 and
    dV = P^T dO summed over each kv head's group.  Returns (dq, dk, dv) in
    the inputs' dtypes (f64 inputs compute in f64)."""
    b, h, s, hd = q.shape
    kv = k.shape[1]
    scale = hd ** -0.5
    qf = (_wide(q) * scale).unflatten(1, (kv, h // kv))
    kf, vf = _wide(k), _wide(v)
    dof = _wide(do).unflatten(1, (kv, h // kv))
    scores = _scores(q, k, causal, window)
    if lse is None:
        lse = torch.logsumexp(scores, -1, keepdim=True)
    else:
        lse = lse.to(scores.dtype).unflatten(1, (kv, h // kv))[..., None]
    p = torch.exp(scores - lse)
    del scores
    dsum = (dof * _wide(o).unflatten(1, (kv, h // kv))).sum(-1, keepdim=True)
    dv = torch.einsum("bkgqs,bkgqd->bksd", p, dof)
    ds = p * (torch.einsum("bkgqd,bksd->bkgqs", dof, vf) - dsum)
    del p
    dq = torch.einsum("bkgqs,bksd->bkgqd", ds, kf) * scale
    dk = torch.einsum("bkgqs,bkgqd->bksd", ds, qf)
    return dq.flatten(1, 2).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def backward_tolerance(q, k, v, o, do, ref, causal: bool = True,
                       window: int = 0, o_err=None):
    """Per-element bounds on ``|kernel - plain|`` for (dq, dk, dv), where
    ``ref`` is the plain version's (dq, dk, dv) on the same inputs:
    ``c |ref| + 2 u n mag``, plus ``2^-8 mag`` where the inputs run the
    tensor-core passes (bf16 at every head dim, :func:`on_tensor_cores`),
    with u = 2^-24, c = 2^-7 for bf16 outputs and 2u for f32,
    n = 2 S + hd (1 + 2 s_max) + 8, and ``mag`` the plain formulas on
    magnitudes: |dS| <= P (|dO| |v|^T + rowsum(|dO| |o|)), then
    mag_dq = |dS| |k| hd^-0.5, mag_dk = |dS|^T |q| hd^-0.5 and
    mag_dv = P^T |dO|.

    ``o_err``, when given, bounds per element how far the kernel's ``o``
    lies from the ``o`` that the plain version was given (the forward
    kernel's output against the plain forward's, within
    :func:`bf16_tolerance` or 2e-5).  o enters only through
    D = rowsum(dO o), so D moves by at most E = rowsum(|dO| o_err) and dS
    by at most P E: dq by E P |k| hd^-0.5 and dk by (P E)^T |q| hd^-0.5,
    which are added; dv does not read o.  ``mag`` then uses |o| + o_err.

    Derivation.  Both sides compute in f32 from the same values (bf16
    inputs widen exactly; products of two of them are exact), so they differ
    only by the order of their f32 sums, and by the final rounding.  A sum
    of m terms in any order is within (m u) of the terms' magnitudes of the
    exact sum.  dO v^T and D sum hd terms; P = exp(s - lse) is off by the
    error of s (hd u s_max, with s_max the largest |q| |k|^T hd^-0.5 of an
    open pair) and of lse (as much again, plus S u for its sum over keys),
    relative; the products with k, q and dO sum up to S terms.  So each
    side lies within n u mag of the exact gradient, and the two within
    2 n u mag of each other.  The outputs then round to their dtype: two
    bf16 roundings of values that close are at most one bf16 ulp apart
    (2^-7 |ref|, the ulp's largest size relative to the value).

    The tensor-core passes' A operands are bf16: P^T is rounded to bf16
    before P^T dO, and dS before dS k and dS^T q, each value to
    p~ = p (1 + d) with |d| <= 2^-8 (bf16's unit roundoff).  So
    dv moves by |sum_q d P^T dO| <= 2^-8 P^T |dO| = 2^-8 mag_dv, and dq and
    dk by 2^-8 |dS| |k| hd^-0.5 <= 2^-8 mag_dq and 2^-8 |dS|^T |q| hd^-0.5
    <= 2^-8 mag_dk (|dS| is within the bound above); these are added.
    At hd 256 the passes store P^T, dS^T and dS in bf16 in shared memory
    instead of registers: the same roundings.  The SIMT passes (f32) keep P
    and dS in f32 and get no such term.  This is a worst-case bound: the
    measured errors are far smaller."""
    b, h, s, hd = q.shape
    kv = k.shape[1]
    scale = hd ** -0.5
    qa = q.float().abs().unflatten(1, (kv, h // kv))
    ka, va = k.float().abs(), v.float().abs()
    doa = do.float().abs().unflatten(1, (kv, h // kv))
    qf = (q.float() * scale).unflatten(1, (kv, h // kv))
    closed = ~_mask(s, causal, window, q.device)
    s_max = float(torch.einsum("bkgqd,bksd->bkgqs", qa * scale, ka)
                  .masked_fill(closed, 0.0).amax())
    scores = torch.einsum("bkgqd,bksd->bkgqs", qf, k.float())
    scores = scores.masked_fill(closed, NEG)
    p = torch.exp(scores - torch.logsumexp(scores, -1, keepdim=True))
    del scores
    oa = o.float().abs()
    extra = [0.0, 0.0, 0.0]
    if o_err is not None:
        oa = oa + o_err
        pe = p * (doa * o_err.float().unflatten(1, (kv, h // kv))).sum(
            -1, keepdim=True)
        extra[0] = (torch.einsum("bkgqs,bksd->bkgqd", pe, ka)
                    * scale).flatten(1, 2)
        extra[1] = torch.einsum("bkgqs,bkgqd->bksd", pe, qa) * scale
        del pe
    dabs = (doa * oa.unflatten(1, (kv, h // kv))).sum(-1, keepdim=True)
    mag_dv = torch.einsum("bkgqs,bkgqd->bksd", p, doa)
    dsa = p * (torch.einsum("bkgqd,bksd->bkgqs", doa, va) + dabs)
    del p
    mag_dq = (torch.einsum("bkgqs,bksd->bkgqd", dsa, ka) * scale).flatten(1, 2)
    mag_dk = torch.einsum("bkgqs,bkgqd->bksd", dsa, qa) * scale
    del dsa
    u = 2.0 ** -24
    n = 2 * s + hd * (1 + 2 * s_max) + 8
    out = []
    rounding = 2.0 ** -8 if on_tensor_cores(q.dtype, hd) else 0.0
    for r, mag, e in zip(ref, (mag_dq, mag_dk, mag_dv), extra):
        c = 2.0 ** -7 if r.dtype == torch.bfloat16 else 2 * u
        out.append(c * r.float().abs() + (2 * u * n + rounding) * mag + e)
    return tuple(out)


def _cuda_view(t, tma: bool = False):
    """``t`` itself when its head dim is contiguous (and, with ``tma``,
    when TMA can load it: a 16-byte aligned base, (b, head, s) strides
    positive multiples of 8 elements), else a contiguous copy."""
    ok = t.stride(-1) == 1
    if tma:
        ok = ok and t.data_ptr() % 16 == 0 and all(
            n == 1 or (st > 0 and st % 8 == 0)
            for n, st in zip(t.shape[:3], t.stride()[:3]))
    return t if ok else t.contiguous()


def on_tensor_cores(dtype, hd: int) -> bool:
    """Whether the backward of this dtype and head dim runs the tensor-core
    passes (bf16, at every head dim); f32 runs the SIMT passes."""
    return dtype == torch.bfloat16 and hd in BACKWARD_HEAD_DIMS


def flash_attention_backward(q, k, v, o, do, causal: bool = True,
                             window: int = 0, lse=None):
    """(dq, dk, dv) of :func:`flash_attention` at (q, k, v), given its
    output ``o``, the output's gradient ``do`` and, where the caller has
    it, the forward's logsumexp ``lse`` (B, H, S) f32: the plain version
    for CPU tensors, the CUDA kernels for CUDA tensors, empty gradients for
    meta tensors (or the wrapper raises).  Without ``lse`` the kernels
    compute it in one more pass.  The gradients are laid out like q, k and
    v (``empty_like``)."""
    global backward_launches, backward_kernel_launches
    _refuse_dtensor(q, k, v, o, do)
    dev = q.device.type
    if dev not in ("cpu", "cuda", "meta"):
        raise ValueError(f"no flash_attention backward kernel for device "
                         f"{q.device}")
    with kernel_cost("flash_attention_backward", lambda: flash_backward_cost(
            *q.shape[:2], k.shape[1], *q.shape[2:], causal, window,
            q.element_size(), lse is not None)):
        if dev == "cpu":  # laid out like q, k and v, as the kernels' output
            grads = flash_attention_backward_plain(q, k, v, o, do, causal,
                                                   window, lse)
            return tuple(torch.empty_like(t).copy_(g)
                         for t, g in zip((q, k, v), grads))
        return _backward_card(q, k, v, o, do, causal, window, lse)


def backward_shares(dtype, hd: int, b: int, h: int, kv: int, s: int) -> int:
    """The f32 dK / dV shares the backward sums for a GQA group: the C entry
    point ``flash_attention_backward_shares`` (``tc::split_for``) on the
    H100 SXM's 132 SMs: on the tensor cores the least divisor of the group
    giving a block per SM over the (b, kv head, key tile) blocks (tiles of
    ``BWD_TILE_ROWS`` keys), else the whole group."""
    sms = 132
    group = h // kv
    if not on_tensor_cores(dtype, hd):
        return group
    rows = BWD_TILE_ROWS.get(hd, 128)
    blocks = b * kv * (-(-s // rows))
    for d in range(1, group):
        if group % d == 0 and blocks * d >= sms:
            return d
    return group


def _backward_card(q, k, v, o, do, causal, window, lse):
    """The backward on a CUDA tensor (the kernels), or on a meta tensor (the
    gradients and the scratch the kernels take, empty: no computation)."""
    global backward_launches, backward_kernel_launches
    if q.dim() == 4 and q.shape[-1] not in BACKWARD_HEAD_DIMS:
        raise NotImplementedError(
            f"the flash backward has no kernel at head dim {q.shape[-1]} "
            f"(built for {BACKWARD_HEAD_DIMS}): another head dim needs its "
            f"own instantiations of the passes in csrc/flash_attention_bwd.cu")
    _check_cuda_args(q, k, v, window)
    b, h, s, hd = q.shape
    kv = k.shape[1]
    meta = q.device.type == "meta"
    tensor_cores = on_tensor_cores(q.dtype, hd)
    if tensor_cores:
        _check_tma(q, k, v)
    o, do = _cuda_view(o), _cuda_view(do, tma=tensor_cores)
    for name, t in (("o", o), ("do", do)):
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"{name} must match q: {tuple(q.shape)} "
                             f"{q.dtype} on {q.device}, got {tuple(t.shape)} "
                             f"{t.dtype} on {t.device}")
    if lse is not None and (lse.shape != (b, h, s) or lse.dtype != torch.float32
                            or lse.device != q.device
                            or not lse.is_contiguous()):
        raise ValueError(f"lse must be a contiguous f32 ({b}, {h}, {s}) on "
                         f"{q.device}, got {tuple(lse.shape)} {lse.dtype} on "
                         f"{lse.device}")
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    f32 = dict(dtype=torch.float32, device=q.device)
    s_pad = -(-s // 64) * 64
    vec = torch.empty(2 * b * h * s_pad, **f32)  # D (and lse log2 e)
    scratch = torch.empty(b, h, s, **f32) if lse is None else None
    if meta:
        shares = backward_shares(q.dtype, hd, b, h, kv, s)
    else:
        lib = load_library()
        with torch.cuda.device(q.device):  # the shares depend on its SM count
            shares = lib.flash_attention_backward_shares(
                DTYPE_CODES[q.dtype], hd, b, h, kv, s)
    # dK and dV shares of the group's runs, summed by the last pass
    parts = ([torch.empty(b, kv * shares, s, hd, **f32) for _ in range(2)]
             if shares > 1 else [])
    if meta:  # the gradients' shapes and the scratch, no computation
        return dq, dk, dv
    n = ctypes.c_int(0)
    with torch.cuda.device(q.device):
        rc = lib.flash_attention_backward_launch(
            DTYPE_CODES[q.dtype], hd, q.data_ptr(), k.data_ptr(),
            v.data_ptr(), o.data_ptr(), do.data_ptr(), dq.data_ptr(),
            dk.data_ptr(), dv.data_ptr(),
            None if lse is None else lse.data_ptr(),
            None if scratch is None else scratch.data_ptr(), vec.data_ptr(),
            *([p.data_ptr() for p in parts] or [None, None]), b, h, kv, s,
            *(st for t in (q, k, v, o, do, dq, dk, dv)
              for st in t.stride()[:3]),
            int(causal), int(window), torch.cuda.current_stream().cuda_stream,
            ctypes.byref(n),
        )
    check(rc, "flash_attention_backward")
    backward_launches += 1
    backward_head_dim_launches[hd] += 1
    backward_kernel_launches += n.value
    return dq, dk, dv
