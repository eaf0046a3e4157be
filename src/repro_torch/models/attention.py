"""Attention — the port of ``repro.models.attention``: grouped-query
attention (GQA) with causal and sliding-window masks, and DeepSeek's
multi-head latent attention (MLA).

GQA's full-sequence mode (:func:`gqa_forward`, used by prefill and by the
training forward) computes its attention core through the hand-written
flash kernel (:func:`repro_torch.kernels.ops.flash_attention`; under
autograd its backward is the hand-written backward kernel).  Under the pod
runtime q, k and v are DTensors (batch on "data", heads on "model"): the
kernel runs on each rank's local batch rows and heads inside a manual
region (:func:`_local_attention`); decode mode
(:func:`gqa_decode`) stays plain PyTorch, one query against the cache, as in
the reference, which has no Pallas kernel there either.  On a cache placed
by the pod runtime (``launch.sharding.cache_spec``) decode reads and writes
each rank's blocks (:func:`_gqa_decode_placed`, :func:`_mla_decode_placed`):
partial scores over a split head_dim summed over "model", and the softmax
over positions split on "data" combined as flash-decode does
(:func:`_attend`).

MLA (:func:`mla_forward`, :func:`mla_decode`) is plain PyTorch in both
modes, as the reference's plain ``jnp`` (under the pod runtime its scores
on each rank's local heads, :func:`_mla_local`): f32 scores ``(B, H, Sq, Sk)``
from a 128-wide no-rope part and a 64-wide rope part shared by the heads,
and 128-wide values; the cache holds the latent ``ckv`` and the rope key
``kpe``, and every step expands the whole cache through ``wkv_b``.

Both kinds take lane-stacked weights (a leading lane axis, one lane per
batch row; ``models.transformer``): the projections are batched matmuls
over the lanes and the norm scales broadcast per lane.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ops
from repro_torch.launch import sharding as shlib
from repro_torch.models.layers import (
    apply_rope,
    lane_scale,
    rms_norm,
    rope,
    shard_act,
)
from repro_torch.models.pdefs import PDef

__all__ = ["gqa_defs", "mla_defs", "gqa_cache_defs", "mla_cache_defs",
           "gqa_forward", "gqa_decode", "mla_forward", "mla_decode",
           "write_positions"]

_NEG = -2.0e38


# ---------------------------------------------------------------------------
# Parameter / cache definitions.
# ---------------------------------------------------------------------------

def gqa_defs(cfg: ArchConfig, stacked: tuple = ()) -> dict:
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    L, Lax = (stacked, ("layers",) * len(stacked)) if stacked else ((), ())
    dt = cfg.dtype
    defs = {
        "wq": PDef(L + (d, h, hd), Lax + ("embed", "heads", "head_dim"), dt, fan_in=d),
        "wk": PDef(L + (d, kv, hd), Lax + ("embed", "kv_heads", "head_dim"), dt, fan_in=d),
        "wv": PDef(L + (d, kv, hd), Lax + ("embed", "kv_heads", "head_dim"), dt, fan_in=d),
        "wo": PDef(L + (h, hd, d), Lax + ("heads", "head_dim", "embed"), dt, fan_in=h * hd),
    }
    if cfg.qk_norm:
        defs["q_norm"] = PDef(L + (hd,), Lax + (None,), torch.float32, "zeros")
        defs["k_norm"] = PDef(L + (hd,), Lax + (None,), torch.float32, "zeros")
    return defs


def mla_defs(cfg: ArchConfig, stacked: tuple = ()) -> dict:
    d, h = cfg.d_model, cfg.n_heads
    qr, kr = cfg.q_lora_rank, cfg.kv_lora_rank
    dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    L, Lax = (stacked, ("layers",) * len(stacked)) if stacked else ((), ())
    dt = cfg.dtype
    return {
        "wq_a": PDef(L + (d, qr), Lax + ("embed", "rank"), dt, fan_in=d),
        "q_norm": PDef(L + (qr,), Lax + (None,), torch.float32, "zeros"),
        "wq_b": PDef(L + (qr, h, dn + dr), Lax + ("rank", "heads", None), dt, fan_in=qr),
        "wkv_a": PDef(L + (d, kr + dr), Lax + ("embed", "rank"), dt, fan_in=d),
        "kv_norm": PDef(L + (kr,), Lax + (None,), torch.float32, "zeros"),
        "wkv_b": PDef(L + (kr, h, dn + dv), Lax + ("rank", "heads", None), dt, fan_in=kr),
        "wo": PDef(L + (h, dv, d), Lax + ("heads", None, "embed"), dt, fan_in=h * dv),
    }


def gqa_cache_defs(cfg: ArchConfig, batch: int, length: int, stacked: tuple = ()) -> dict:
    kv, hd = cfg.n_kv_heads, cfg.resolved_head_dim
    L, Lax = (stacked, ("layers",) * len(stacked)) if stacked else ((), ())
    shape = L + (batch, length, kv, hd)
    axes = Lax + ("batch", "seq", "kv_heads", "head_dim")
    return {"k": PDef(shape, axes, cfg.dtype, "zeros"),
            "v": PDef(shape, axes, cfg.dtype, "zeros")}


def mla_cache_defs(cfg: ArchConfig, batch: int, length: int, stacked: tuple = ()) -> dict:
    L, Lax = (stacked, ("layers",) * len(stacked)) if stacked else ((), ())
    return {
        "ckv": PDef(L + (batch, length, cfg.kv_lora_rank),
                    Lax + ("batch", "seq", "rank"), cfg.dtype, "zeros"),
        "kpe": PDef(L + (batch, length, cfg.qk_rope_head_dim),
                    Lax + ("batch", "seq", None), cfg.dtype, "zeros"),
    }


# ---------------------------------------------------------------------------
# Masking + core dot-product attention (the decode path).
# ---------------------------------------------------------------------------

def _open_keys(q_pos, k_pos, window: int, causal: bool):
    """Bool (..., Sq, Sk): the keys each query may read; window 0 = full.
    A non-causal model reads every key: the window is ignored, as in the
    reference."""
    dq = q_pos[..., :, None]
    dk = k_pos[..., None, :]
    if not causal:
        return torch.ones(torch.broadcast_shapes(dq.shape, dk.shape),
                          dtype=torch.bool, device=dq.device)
    ok = dk <= dq
    if window > 0:
        ok = ok & (dq - dk < window)
    return ok


def _full_mask(q_pos, k_pos, window: int, causal: bool):
    """Additive f32 bias (..., Sq, Sk) of :func:`_open_keys`: 0 on an open
    key, -2e38 on a closed one."""
    return torch.where(_open_keys(q_pos, k_pos, window, causal), 0.0,
                       _NEG).float()


def _dot_attn(q, k, v, bias, scale):
    """q: (B,Sq,KV,G,hd)  k,v: (B,Sk,KV,hd)  bias: (B,1,1,Sq,Sk) or None.
    q is scaled in its own dtype before the f32 product, as the reference."""
    qf = (q * scale).float()
    scores = torch.einsum("bqkgd,bskd->bkgqs", qf, k.float())
    if bias is not None:
        scores = scores + bias
    probs = scores.softmax(-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", probs, v.float())
    return out.to(v.dtype)


def _split_heads(x, kv, g):
    b, s = x.shape[:2]
    return x.reshape(b, s, kv, g, -1)


def _project(x, w):
    """``einsum("bsd,dhk->bshk", x, w)`` as one matmul (a batched one when
    ``w`` carries a leading lane axis, one lane per batch row).  Under the
    pod runtime with ``w``'s last dim (head_dim) on "model", the product
    takes head_dim as the outer of the two flattened dims, so that the
    split stays one DTensor can place."""
    if _on_model(w) == w.dim() - 1:
        y = x @ w.transpose(-1, -2).flatten(-2)
        return y.unflatten(-1, (w.shape[-1], w.shape[-2])).transpose(-1, -2)
    return (x @ w.flatten(-2)).unflatten(-1, w.shape[-2:])


def _on_model(t):
    """The dim of DTensor ``t`` that the "model" mesh dim splits, or None
    (a plain tensor, or no split there)."""
    if not shlib.is_dtensor(t) or "model" not in t.device_mesh.mesh_dim_names:
        return None
    pl = t.placements[t.device_mesh.mesh_dim_names.index("model")]
    return pl.dim if pl.is_shard() else None


# ---------------------------------------------------------------------------
# GQA.
# ---------------------------------------------------------------------------

def _whole_heads(t):
    """Under the pod runtime, a projection whose head_dim is on "model"
    (its heads do not divide the axis) gathered there (one all-gather; the
    gradient's slice comes back, or its partial sum is reduce-scattered):
    the norms, the rope and the attention read whole heads.  Anything else
    as it is."""
    return shlib.gather_model(t) if _on_model(t) == t.dim() - 1 else t


def _gqa_qkv(p, x, cfg: ArchConfig, positions, theta):
    q = _whole_heads(_project(x, p["wq"]))
    k = _whole_heads(_project(x, p["wk"]))
    v = _whole_heads(_project(x, p["wv"]))
    if cfg.qk_norm:
        q = rms_norm(q, lane_scale(p["q_norm"], q), cfg.norm_eps)
        k = rms_norm(k, lane_scale(p["k_norm"], k), cfg.norm_eps)
    if theta is not None:
        sin, cos = rope(positions, cfg.resolved_head_dim, theta)
        q = apply_rope(q, sin, cos)
        k = apply_rope(k, sin, cos)
    return q, k, v


def _out_proj(out, wo):
    """``einsum("bshk,hkd->bsd", out, wo)`` as one matmul (batched over a
    leading lane axis of ``wo``).  Under the pod runtime with ``wo``'s
    head_dim rows on "model" (heads that do not divide it), each rank takes
    its head_dim block of ``out`` (a slice; the gradient is gathered back)
    against its rows: a partial sum over "model", as a row-parallel
    projection's."""
    if _on_model(wo) == wo.dim() - 2:
        from torch.distributed.tensor import Shard

        mesh = wo.device_mesh
        pls = list(out.placements)
        pls[mesh.mesh_dim_names.index("model")] = Shard(out.dim() - 1)
        out = out.redistribute(mesh, pls)
        return (out.transpose(-1, -2).flatten(2)
                @ wo.transpose(-3, -2).flatten(-3, -2))
    return out.flatten(2) @ wo.flatten(-3, -2)


def gqa_forward(p, x, cfg: ArchConfig, window: int = 0, theta=None,
                positions=None, return_kv: bool = False):
    """Full-sequence attention (prefill and training).  ``positions`` feeds the rope; the
    kernel's mask takes query and key i at position i, which is what every
    caller passes (``arange(S)`` per row).

    The attention core is the flash kernel on the ``transpose(1, 2)`` views
    of the (B,S,H,hd) q and (B,S,KV,hd) k/v projections, read through their
    strides with no copy; its output comes back laid out like q's view, so
    transposing it again gives (B,S,H,hd) contiguous on the card.

    Against the reference's ``_dot_attn``: masked scores are replaced by
    -1e30 where the reference adds -2e38, the same softmax as long as each
    row keeps an open key (causal rows keep their diagonal).  Where the
    scale hd^-0.5 is applied differs: the reference scales q in q's dtype;
    the f32 kernel scales q in f32; the bf16 kernel scales the f32 scores
    (folded with log2 e into its exponent) and rounds P to bf16 before
    P.V (``kernels.flash_attention.bf16_tolerance``).  All agree whenever
    hd^-0.5 is a power of two (hd 64, 256); at hd 80 and 128 in bf16 the
    reference's scaled q carries one more bf16 rounding, which neither
    kernel has."""
    b, s, _ = x.shape
    if positions is None:
        positions = torch.arange(s, device=x.device).expand(b, s)
    q, k, v = _gqa_qkv(p, x, cfg, positions, theta)
    q = shard_act(q, ("batch", "seq", "heads", None))
    # The kernel applies a window with or without the causal mask, while the
    # reference's mask ignores it for a non-causal model: pass it only when
    # the model is causal.
    window = window if cfg.causal else 0
    if shlib.is_dtensor(q):
        out = _local_attention(q, k, v, cfg.causal, window)
    else:
        out = ops.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                                  v.transpose(1, 2), causal=cfg.causal,
                                  window=window).transpose(1, 2)
    out = _out_proj(out, p["wo"])
    return (out, (k, v)) if return_kv else out


def _local_attention(q, k, v, causal: bool, window: int):
    """The flash kernel on each rank's shards of DTensor q (B,S,H,hd) and
    k, v (B,S,KV,hd) -> the DTensor output (B,S,H,hd), laid out as q.

    q keeps its placements (batch rows on "data", heads on "model", as
    ``constrain`` left them); k and v follow them where KV divides by the
    axis, and are replicated where it does not (2 kv heads on a 4-wide
    model axis).  Rank r's query heads ``[r H/m, (r+1) H/m)`` then read kv
    heads ``h // (H / KV)`` of the replicated k and v: one kv head when its
    group spans the rank's heads, else one kv head per query head.  The
    kernel runs inside a manual region on the local tensors (``to_local``
    in, ``from_local`` out), and its hand-written backward on the same
    local tensors.  A replicated k's local gradient holds only the rank's
    heads' share, so it goes back as a ``Partial`` sum over the axis."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    mesh = q.device_mesh
    group = q.shape[2] // k.shape[2]
    q_pl, kv_pl, kv_grad = [], [], []
    head_dim = None  # the mesh dim that splits q's heads
    for i, pl in enumerate(q.placements):
        if pl == Shard(2):
            head_dim = i
            split = k.shape[2] % mesh.size(i) == 0
            q_pl.append(pl)
            kv_pl.append(pl if split else Replicate())
            kv_grad.append(pl if split else Partial())
        else:  # batch rows, or replicated (any other split is undone)
            pl = pl if pl == Shard(0) else Replicate()
            q_pl.append(pl)
            kv_pl.append(pl)
            kv_grad.append(pl)
    q = q.redistribute(mesh, q_pl)
    k = k.redistribute(mesh, kv_pl)
    v = v.redistribute(mesh, kv_pl)
    ql = q.to_local(grad_placements=q_pl)
    kl = k.to_local(grad_placements=kv_grad)
    vl = v.to_local(grad_placements=kv_grad)
    if head_dim is not None and kv_pl[head_dim] == Replicate():
        hl = ql.shape[2]
        lo = mesh.get_local_rank(head_dim) * hl
        if group % hl == 0:  # the rank's heads share one kv head
            j = lo // group
            kl, vl = kl[:, :, j:j + 1], vl[:, :, j:j + 1]
        else:  # one kv head per query head
            kv_of = torch.arange(lo, lo + hl, device=ql.device) // group
            kl, vl = kl.index_select(2, kv_of), vl.index_select(2, kv_of)
    with shlib.manual_region(mesh):
        out = ops.flash_attention(ql.transpose(1, 2), kl.transpose(1, 2),
                                  vl.transpose(1, 2), causal=causal,
                                  window=window).transpose(1, 2)
    return DTensor.from_local(out, mesh, q_pl, run_check=False)


def gqa_decode(p, x, cache, cfg: ArchConfig, pos: int, window: int = 0,
               theta=None):
    """One-token decode.  x: (B,1,D); cache slice {"k","v"}: (B,S,kv,hd).

    Writes the new key and value into the cache IN PLACE at ``pos`` (the
    reference returns an updated copy) and returns that same dict.  A
    placed cache (DTensors, ``launch.sharding.place_cache``) is read and
    written on each rank's own block (:func:`_gqa_decode_placed`)."""
    pos = int(pos)
    b = x.shape[0]
    kv, g = cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads
    hd = cfg.resolved_head_dim
    positions = torch.full((b, 1), pos, device=x.device)
    q, k_new, v_new = _gqa_qkv(p, x, cfg, positions, theta)
    k, v = cache["k"], cache["v"]
    write_positions(k, k_new, pos)
    write_positions(v, v_new, pos)
    if shlib.is_dtensor(k):
        return _gqa_decode_placed(q, cache, p["wo"], cfg, pos, window)
    k_pos = torch.arange(k.shape[1], device=x.device).expand(b, k.shape[1])
    bias = _full_mask(positions, k_pos, window, True)[:, None, None]
    out = _dot_attn(_split_heads(q, kv, g), k, v, bias, hd ** -0.5)
    out = out.reshape(b, 1, cfg.n_heads, hd)
    return _out_proj(out, p["wo"]), cache


# ---------------------------------------------------------------------------
# Decode on a placed cache (the pod runtime's serving).
# ---------------------------------------------------------------------------

def _split_dims(t) -> dict:
    """{dim: mesh dim} of the dims that DTensor ``t`` splits."""
    return {pl.dim: i for i, pl in enumerate(t.placements) if pl.is_shard()}


def _block_of(t, dim: int) -> tuple:
    """(first index, length) of this rank's block of DTensor ``t``'s dim."""
    i = _split_dims(t).get(dim)
    n = t.to_local().shape[dim]
    return (0, n) if i is None else (t.device_mesh.get_local_rank(i) * n, n)


def write_positions(cache_t, new, pos: int) -> None:
    """Write ``new`` (B, s, ...) into the cache leaf ``cache_t`` (B, S, ...)
    at positions ``pos .. pos + s``, in place.  A placed cache (DTensors) is
    written on each rank's block: ``new`` takes the cache's placements
    (whole along the positions), and where "data" splits the positions each
    rank writes those its block holds (none, if it holds none)."""
    from torch.distributed.tensor import Replicate

    if not shlib.is_dtensor(cache_t):
        cache_t[:, pos:pos + new.shape[1]] = new.to(cache_t.dtype)
        return
    pls = [Replicate() if pl.is_shard() and pl.dim == 1 else pl
           for pl in cache_t.placements]
    nl = new.redistribute(cache_t.device_mesh, pls).to_local()
    lo, n = _block_of(cache_t, 1)
    a, b = max(lo, pos), min(lo + n, pos + nl.shape[1])
    if a < b:
        cache_t.to_local()[:, a - lo:b - lo] = nl[:, a - pos:b - pos].to(
            cache_t.dtype)


def _attend(scores, ok, pv, mesh, seq_axis):
    """softmax(scores) V over the keys of each rank's cache block: ``scores``
    (f32, the keys last, the query second to last) and ``ok`` (the open
    keys, broadcast to them), ``pv(probs)`` the rank's f32 product with its
    values, ``(B, 1, ..., width)``.  Without a split of the positions
    (``seq_axis`` None) it is the mesh-less decode's softmax.  With the
    positions on mesh dim ``seq_axis``, a flash-decode combine: each rank's
    row maximum over its open keys (-inf where it has none) is all-reduced
    to the global one, the exponentials taken against it (0 on closed
    keys), and one all-reduce sums each rank's row sums and P V."""
    from torch.distributed import _functional_collectives as funcol

    if seq_axis is None:
        return pv((scores + torch.where(ok, 0.0, _NEG)).softmax(-1))
    s = scores.masked_fill(~ok, float("-inf"))
    m = funcol.all_reduce(s.amax(-1, keepdim=True), "max", (mesh, seq_axis))
    p = torch.exp(s - m)
    ol = torch.cat([pv(p), p.sum(-1).movedim(-1, 1)[..., None]], -1)
    ol = funcol.all_reduce(ol, "sum", (mesh, seq_axis))
    return ol[..., :-1] / ol[..., -1:]


def _q_layout(q, cache_t) -> list:
    """The placements of the one-token q ``(B, 1, H, hd)`` against a placed
    kv cache leaf ``(B, S, KV, hd)``: its batch rows and its heads (by kv
    head) or head_dim columns split as the cache's, whole where the cache
    splits its positions; where the cache splits neither on a mesh dim, q's
    heads stay as they are there."""
    from torch.distributed.tensor import Replicate

    out = []
    for qp, cp in zip(q.placements, cache_t.placements):
        if cp.is_shard():
            out.append(Replicate() if cp.dim == 1 else cp)
        else:
            out.append(qp if qp.is_shard() and qp.dim == 2 else Replicate())
    return out


def _reshard(t, pls):
    """DTensor ``t`` redistributed to ``pls``; a split moved from one dim to
    another on a mesh dim goes through the whole (one all-gather of the
    small one-token tensor, then a local slice), the same collective in
    every torch version."""
    from torch.distributed.tensor import Replicate

    mid = [Replicate() if a.is_shard() and b.is_shard() and a.dim != b.dim
           else a for a, b in zip(t.placements, pls)]
    if mid != list(t.placements):
        t = t.redistribute(t.device_mesh, mid)
    return t.redistribute(t.device_mesh, pls)


def _as_wo_rows(out, wo):
    """The attention output ``(B, 1, H, hd)`` split on "model" as ``wo``'s
    rows are: its heads, its head_dim, or whole (:func:`_reshard`)."""
    from torch.distributed.tensor import Replicate, Shard

    mesh = out.device_mesh
    names = mesh.mesh_dim_names
    if "model" not in names:
        return out
    i = names.index("model")
    pl = wo.placements[i]
    dim = pl.dim - wo.dim() + 5 if pl.is_shard() else None  # (H, hd, d)
    want = Shard(dim) if dim in (2, 3) else Replicate()
    pls = list(out.placements)
    pls[i] = want
    return _reshard(out, pls)


def _gqa_decode_placed(q, cache, wo, cfg: ArchConfig, pos: int, window: int):
    """:func:`gqa_decode` on a placed cache (``launch.sharding.cache_spec``:
    its batch on "data", else its positions; its kv heads on "model", else
    its head_dim).  The one token's q, k and v are computed as the forward's
    (whole heads where head_dim is split); k and v are written on each
    rank's block and q redistributed to the cache's layout — the cache is
    never moved.  Each rank scores its q against its keys: on its kv heads
    and their query heads, or, with head_dim split, partial dot products
    over its columns summed by one all-reduce of the ``(B_local, H, 1,
    S_local)`` f32 scores over "model" (as GSPMD lowers a contraction over a
    split dim); then the softmax (the combine of :func:`_attend` over
    "data" where the positions are split) and P V on its own columns.  The
    output goes to the output projection split as ``wo``'s rows are."""
    from torch.distributed import _functional_collectives as funcol
    from torch.distributed.tensor import DTensor

    g = cfg.n_heads // cfg.n_kv_heads
    hd = cfg.resolved_head_dim
    k, v = cache["k"], cache["v"]
    mesh = k.device_mesh
    q = _reshard(q, _q_layout(q, k))
    on = _split_dims(k)
    ql, kl, vl = q.to_local(), k.to_local(), v.to_local()
    with shlib.manual_region(mesh):
        bl, hq = ql.shape[0], ql.shape[2]
        if kl.shape[2] * g != hq:  # the kv heads whole, q's a block of them
            lo = mesh.get_local_rank(_split_dims(q)[2]) * hq
            kv_of = torch.arange(lo, lo + hq, device=ql.device) // g
            kl, vl = kl.index_select(2, kv_of), vl.index_select(2, kv_of)
        qs = ql.reshape(bl, 1, kl.shape[2], -1, ql.shape[-1])
        scores = torch.einsum("bqkgd,bskd->bkgqs",
                              (qs * hd ** -0.5).float(), kl.float())
        if 3 in on:
            scores = funcol.all_reduce(scores, "sum", (mesh, on[3]))
        s_lo, s_n = _block_of(k, 1)
        k_pos = torch.arange(s_lo, s_lo + s_n, device=ql.device)
        ok = _open_keys(torch.full((bl, 1), pos, device=ql.device),
                        k_pos.expand(bl, s_n), window, True)[:, None, None]
        out = _attend(scores, ok, lambda pr: torch.einsum(
            "bkgqs,bskd->bqkgd", pr, vl.float()), mesh, on.get(1))
        out = out.to(vl.dtype).reshape(bl, 1, hq, -1)
    out = DTensor.from_local(out, mesh, q.placements, run_check=False)
    return _out_proj(_as_wo_rows(out, wo), wo), cache


# ---------------------------------------------------------------------------
# MLA (multi-head latent attention, DeepSeek-V3).
# ---------------------------------------------------------------------------

def _mla_q(p, x, cfg: ArchConfig, positions):
    dn, dr = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    cq = x @ p["wq_a"]
    cq = rms_norm(cq, lane_scale(p["q_norm"], cq), cfg.norm_eps)
    q = _project(cq, p["wq_b"])
    q_nope, q_pe = q[..., :dn], q[..., dn:]
    sin, cos = rope(positions, dr, cfg.rope_theta)
    return q_nope, apply_rope(q_pe, sin, cos)


def _mla_kv_latent(p, x, cfg: ArchConfig, positions):
    kr, dr = cfg.kv_lora_rank, cfg.qk_rope_head_dim
    a = x @ p["wkv_a"]
    ckv = rms_norm(a[..., :kr], lane_scale(p["kv_norm"], a), cfg.norm_eps)
    sin, cos = rope(positions, dr, cfg.rope_theta)
    kpe = apply_rope(a[..., None, kr:], sin, cos)[..., 0, :]  # shared head
    return ckv, kpe


def _mla_attend(p, q_nope, q_pe, ckv, kpe, cfg: ArchConfig, bias):
    """The attention of MLA's queries on the latent keys and values, and
    its output projection.  Under the pod runtime (DTensor q, heads on
    "model") the scores run on each rank's local heads (:func:`_mla_local`)."""
    dn = cfg.qk_nope_head_dim
    kvb = _project(ckv, p["wkv_b"])
    k_nope, v = kvb[..., :dn], kvb[..., dn:]
    core = _mla_local if shlib.is_dtensor(q_nope) else _mla_core
    return _out_proj(core(q_nope, q_pe, k_nope, v, kpe, cfg, bias), p["wo"])


def _mla_core(q_nope, q_pe, k_nope, v, kpe, cfg: ArchConfig, bias):
    """Scores in f32 from q scaled in the model dtype first, as the
    reference: the scale (dn + dr)^-0.5 = 192^-0.5 is not a power of two,
    so in bf16 the order of the scaling and the cast matters."""
    scale = (cfg.qk_nope_head_dim + cfg.qk_rope_head_dim) ** -0.5
    scores = torch.einsum("bqhd,bshd->bhqs", (q_nope * scale).float(),
                          k_nope.float())
    scores += torch.einsum("bqhd,bsd->bhqs", (q_pe * scale).float(),
                           kpe.float())
    if bias is not None:
        scores += bias
    probs = scores.softmax(-1)
    del scores
    return torch.einsum("bhqs,bshd->bqhd", probs, v.float()).to(v.dtype)


def _mla_local(q_nope, q_pe, k_nope, v, kpe, cfg: ArchConfig, bias):
    """:func:`_mla_core` on each rank's shards of the DTensors: its batch
    rows and, where "model" splits the heads (dim 2), its heads, reading
    the whole rope key ``kpe`` that the heads share (its gradient a partial
    sum over "model"), in a manual region.  Without a head split every rank
    runs every head alike, and the inputs' gradients are whole there."""
    mesh = q_nope.device_mesh
    rank_heads = q_nope.placements[mesh.mesh_dim_names.index("model")] \
        if "model" in mesh.mesh_dim_names else None
    split = rank_heads is not None and rank_heads.is_shard()
    local = [shlib.local_part(t, q_nope, own_model=split)
             for t in (q_nope, q_pe, k_nope, v, kpe)]
    with shlib.manual_region(mesh):
        out = _mla_core(*local, cfg, bias[:local[0].shape[0]])
    return shlib.from_local(out, q_nope, rank_heads if split else None)


def mla_forward(p, x, cfg: ArchConfig, window: int = 0, theta=None,
                positions=None, return_kv: bool = False):
    """Full-sequence MLA (prefill and training); ``window`` and ``theta``
    are ignored (deepseek has neither), as in the reference."""
    b, s, _ = x.shape
    if positions is None:
        positions = torch.arange(s, device=x.device).expand(b, s)
    q_nope, q_pe = _mla_q(p, x, cfg, positions)
    ckv, kpe = _mla_kv_latent(p, x, cfg, positions)
    bias = _full_mask(positions, positions, 0, cfg.causal)[:, None]
    out = _mla_attend(p, q_nope, q_pe, ckv, kpe, cfg, bias)
    return (out, (ckv, kpe)) if return_kv else out


def mla_decode(p, x, cache, cfg: ArchConfig, pos: int, window: int = 0,
               theta=None):
    """Decode against the latent cache (ckv + kpe).  Writes the new entries
    IN PLACE at ``pos`` (the reference returns an updated copy) and returns
    that same dict.  A placed cache is read and written on each rank's own
    block (:func:`_mla_decode_placed`)."""
    b = x.shape[0]
    pos = int(pos)
    positions = torch.full((b, 1), pos, device=x.device)
    q_nope, q_pe = _mla_q(p, x, cfg, positions)
    ckv_new, kpe_new = _mla_kv_latent(p, x, cfg, positions)
    ckv, kpe = cache["ckv"], cache["kpe"]
    write_positions(ckv, ckv_new, pos)
    write_positions(kpe, kpe_new, pos)
    if shlib.is_dtensor(ckv):
        return _mla_decode_placed(p, q_nope, q_pe, cache, cfg, pos)
    k_pos = torch.arange(ckv.shape[1], device=x.device).expand(b, ckv.shape[1])
    bias = _full_mask(positions, k_pos, 0, True)[:, None]
    out = _mla_attend(p, q_nope, q_pe, ckv, kpe, cfg, bias)
    return out, cache


def _mla_decode_placed(p, q_nope, q_pe, cache, cfg: ArchConfig, pos: int):
    """:func:`mla_decode` on a placed latent cache (its batch on "data",
    else its positions; nothing on "model"), the new entries written: the
    rank's cache block expanded through ``wkv_b`` on
    the rank's heads (those of ``wq_b`` and ``wkv_b``'s columns on
    "model"), the scores, softmax (:func:`_attend`'s combine over "data"
    where the positions are split) and P V on those heads, the output
    split by head for ``wo``'s rows."""
    from torch.distributed.tensor import DTensor

    ckv, kpe = cache["ckv"], cache["kpe"]
    mesh = ckv.device_mesh
    dn = cfg.qk_nope_head_dim
    kvb = _project(ckv, p["wkv_b"])
    scale = (dn + cfg.qk_rope_head_dim) ** -0.5
    ql, qpl, kvl, kpel = (t.to_local() for t in (q_nope, q_pe, kvb, kpe))
    with shlib.manual_region(mesh):
        k_nope, v = kvl[..., :dn], kvl[..., dn:]
        scores = torch.einsum("bqhd,bshd->bhqs", (ql * scale).float(),
                              k_nope.float())
        scores += torch.einsum("bqhd,bsd->bhqs", (qpl * scale).float(),
                               kpel.float())
        bl = ql.shape[0]
        s_lo, s_n = _block_of(ckv, 1)
        k_pos = torch.arange(s_lo, s_lo + s_n, device=ql.device)
        ok = _open_keys(torch.full((bl, 1), pos, device=ql.device),
                        k_pos.expand(bl, s_n), 0, True)[:, None]
        out = _attend(scores, ok, lambda pr: torch.einsum(
            "bhqs,bshd->bqhd", pr, v.float()), mesh,
            _split_dims(ckv).get(1)).to(v.dtype)
    out = DTensor.from_local(out, mesh, q_nope.placements, run_check=False)
    return _out_proj(out, p["wo"]), cache
