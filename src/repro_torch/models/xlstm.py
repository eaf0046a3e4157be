"""xLSTM (arXiv:2405.04517) — the port of ``repro.models.xlstm``: mLSTM
(matrix memory; a stabilized parallel form for the full sequence, an O(1)
recurrent step for decode) and sLSTM (scalar memory, a time loop with
block-diagonal recurrent gate connections and a post-FFN).

Every ``cfg.slstm_every``-th layer is sLSTM, the rest mLSTM: 24 layers with
``slstm_every=6`` are 4 groups of [5 mLSTM, 1 sLSTM].  Parameters stay
stacked on a double leading axis, ``(groups, n_m, ...)`` for the mLSTM
blocks and ``(groups, n_s, ...)`` for the sLSTM blocks, as in the
reference, so a reference tree carries across leaf for leaf; the
reference's scans over groups and blocks become Python loops over the
views.  With ``cfg.remat`` each group of a forward that records gradients
runs under ``torch.utils.checkpoint`` (the reference checkpoints its group
body).

Plain PyTorch throughout: the reference computes all of it outside any
Pallas kernel.  Two numerical choices are the reference's and are kept:

- the sLSTM loop of :func:`forward` starts from the stabilizer m = -2e38,
  while :func:`prefill` runs :func:`decode_step` over the prompt from the
  zero state of :func:`cache_defs` (sLSTM m = 0, and mLSTM m = 0 against
  the parallel form's row maximum), so the two agree only to a tolerance;
- the mLSTM denominator ``max(|q . n|, exp(-m))`` has an f32 floor
  ``exp(-m)`` that overflows to inf when m < about -88 (the output is then
  0 in both packages); the causal mask is -2e38, not -inf.

The sLSTM's four gates are interleaved on the last axis: the input
projection ``(..., 4d)`` and the recurrent product ``(..., 4 hd)`` read as
``(..., heads, hd, 4)`` (:func:`_gates`), not as four contiguous blocks.

:func:`decode_step` updates the cache IN PLACE and returns it (the
reference returns a new one).  Every entry point also takes lane-stacked
parameters (a leading lane axis, one lane per batch row; see
``models.transformer``): the block views follow the lane axis
(``(B, groups, n, ...)`` leaves), the projections are batched matmuls,
norm scales and biases broadcast per lane, and the sLSTM's block-diagonal
recurrence reads each lane's own ``r``.

Under the pod runtime (DTensor activations and weights placed by
``spec_for``: batch rows on "data", the up-projections' columns and the
heads on "model") the mLSTM's parallel form and the sLSTM's time loop run
in a manual region on each rank's local heads (:func:`_mlstm_placed`,
:func:`_slstm_local`); each block's output is then summed over "model" (a
row-parallel ``w_down`` or ``ffn_wo``) or gathered there (the sLSTM's
heads).  Where the heads do not divide "model", an mLSTM rank computes the
whole heads its columns fall in (:func:`_mlstm_sub_head`) and every sLSTM
rank runs every head.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.launch import sharding as shlib
from repro_torch.models.layers import lane_scale, shard_act, softmax_xent
from repro_torch.models.pdefs import PDef
from repro_torch.models.transformer import (
    _embed_tokens,
    _lanes,
    _norm,
    new_cache,
)

__all__ = ["param_defs", "cache_defs", "forward", "loss", "prefill",
           "decode_step", "mlstm_parallel", "mlstm_step"]

_NEG = -2.0e38


def _dims(cfg: ArchConfig):
    d = cfg.d_model
    di = 2 * d  # mLSTM projection factor 2 (paper)
    h = cfg.n_heads
    return d, di, h, di // h


def _groups(cfg: ArchConfig):
    """(mLSTM blocks a group, groups, sLSTM blocks a group)."""
    if not cfg.slstm_every:
        return cfg.n_layers, 1, 0
    p = cfg.slstm_every
    if cfg.n_layers % p:
        raise ValueError(f"n_layers {cfg.n_layers} must divide by "
                         f"slstm_every {p}")
    return p - 1, cfg.n_layers // p, 1


# ---------------------------------------------------------------------------
# Parameter / cache declarations.
# ---------------------------------------------------------------------------

def _mlstm_defs(cfg: ArchConfig, stacked: tuple) -> dict:
    d, di, h, hd = _dims(cfg)
    L, Lax = stacked, ("layers",) * len(stacked)
    dt, f32 = cfg.dtype, torch.float32
    return {
        "ln": PDef(L + (d,), Lax + (None,), f32, "zeros"),
        "w_up": PDef(L + (d, 2 * di), Lax + ("embed", "mlp"), dt, fan_in=d),
        "wq": PDef(L + (di, di), Lax + ("ssm_inner", "mlp"), dt, fan_in=di),
        "wk": PDef(L + (di, di), Lax + ("ssm_inner", "mlp"), dt, fan_in=di),
        "wv": PDef(L + (di, di), Lax + ("ssm_inner", "mlp"), dt, fan_in=di),
        "w_if": PDef(L + (di, 2 * h), Lax + ("ssm_inner", None), f32, fan_in=di),
        "b_if": PDef(L + (2 * h,), Lax + (None,), f32, "zeros"),
        "out_norm": PDef(L + (hd,), Lax + (None,), f32, "zeros"),
        "w_down": PDef(L + (di, d), Lax + ("mlp", "embed"), dt, fan_in=di),
    }


def _slstm_defs(cfg: ArchConfig, stacked: tuple) -> dict:
    d, _, h, _ = _dims(cfg)
    hd = d // h
    f = int(math.ceil(4 * d / 3 / 128) * 128)  # post-FFN (pf 4/3)
    L, Lax = stacked, ("layers",) * len(stacked)
    dt, f32 = cfg.dtype, torch.float32
    return {
        "ln": PDef(L + (d,), Lax + (None,), f32, "zeros"),
        "wx": PDef(L + (d, 4 * d), Lax + ("embed", "mlp"), dt, fan_in=d),
        "r": PDef(L + (h, hd, 4 * hd), Lax + ("heads", None, None), dt, fan_in=hd),
        "b": PDef(L + (4 * d,), Lax + (None,), f32, "zeros"),
        "out_norm": PDef(L + (hd,), Lax + (None,), f32, "zeros"),
        "ln_ffn": PDef(L + (d,), Lax + (None,), f32, "zeros"),
        "ffn_wi": PDef(L + (d, f), Lax + ("embed", "mlp"), dt, fan_in=d),
        "ffn_wg": PDef(L + (d, f), Lax + ("embed", "mlp"), dt, fan_in=d),
        "ffn_wo": PDef(L + (f, d), Lax + ("mlp", "embed"), dt, fan_in=f),
    }


def param_defs(cfg: ArchConfig) -> dict:
    d, v = cfg.d_model, cfg.padded_vocab
    n_m, g, n_s = _groups(cfg)
    defs = {
        "mlstm": _mlstm_defs(cfg, (g, n_m)),
        "final_norm": PDef((d,), (None,), torch.float32, "zeros"),
        "embed": PDef((v, d), ("vocab", "embed"), cfg.dtype, fan_in=d),
        "lm_head": PDef((d, v), ("embed", "vocab"), cfg.dtype, fan_in=d),
    }
    if n_s:
        defs["slstm"] = _slstm_defs(cfg, (g, n_s))
    return defs


def cache_defs(cfg: ArchConfig, batch: int, length: int) -> dict:
    """Decode state, O(1) in the sequence length (``length`` is unused)."""
    del length
    d, _, h, hd = _dims(cfg)
    n_m, g, n_s = _groups(cfg)
    f32 = torch.float32
    lay = ("layers", "layers", "batch", "heads")
    defs = {
        "m_C": PDef((g, n_m, batch, h, hd, hd), lay + (None, None), f32, "zeros"),
        "m_n": PDef((g, n_m, batch, h, hd), lay + (None,), f32, "zeros"),
        "m_m": PDef((g, n_m, batch, h), lay, f32, "zeros"),
    }
    if n_s:
        shape = (g, n_s, batch, h, d // h)
        for name in ("s_c", "s_n", "s_m", "s_h"):
            defs[name] = PDef(shape, lay + (None,), f32, "zeros")
    return defs


def _block(tree: dict, gi: int, j: int, lanes: bool = False) -> dict:
    """Block j of group gi: views of the doubly stacked leaves (behind the
    lane axis when there is one); under the pod runtime with FSDP a block's
    "data" shards are gathered here, a block at a time."""
    if lanes:
        return {k: t[:, gi, j] for k, t in tree.items()}
    return {k: shlib.unshard_data(t[gi, j]) for k, t in tree.items()}


# ---------------------------------------------------------------------------
# mLSTM core.
# ---------------------------------------------------------------------------

def _mlstm_qkvif(pl, xm, cfg: ArchConfig):
    _, _, h, hd = _dims(cfg)
    b, s, _ = xm.shape
    q = (xm @ pl["wq"]).reshape(b, s, h, hd)
    k = (xm @ pl["wk"]).reshape(b, s, h, hd)
    v = (xm @ pl["wv"]).reshape(b, s, h, hd)
    gates = xm.float() @ pl["w_if"]
    gates = gates + lane_scale(pl["b_if"], gates)
    return q, k, v, gates[..., :h], gates[..., h:]


def mlstm_parallel(q, k, v, i_pre, f_pre):
    """Stabilized quadratic form (training and the forward): q, k, v
    ``(B, S, H, hd)``, gate pre-activations ``(B, S, H)`` -> ``(B, S, H,
    hd)`` in f32.  ``D[t, s] = F_t - F_s + i_s`` for s <= t (F the
    cumulative log forget gate), stabilized by its row maximum m."""
    hd = q.shape[-1]
    s = q.shape[1]
    lf = F.logsigmoid(f_pre)
    F_cum = torch.cumsum(lf, dim=1)
    D = F_cum[:, :, None, :] - F_cum[:, None, :, :] + i_pre[:, None, :, :]
    t_idx = torch.arange(s, device=q.device)
    causal = t_idx[:, None] >= t_idx[None, :]
    D = torch.where(causal[None, :, :, None], D, _NEG)  # (B, T, S, H)
    m = D.amax(dim=2)  # (B, T, H)
    w = torch.exp(D - m[:, :, None, :])
    scores = torch.einsum("bthd,bshd->btsh", q.float(),
                          k.float()) / np.sqrt(hd)
    sw = scores * w
    num = torch.einsum("btsh,bshd->bthd", sw, v.float())
    denom = torch.maximum(sw.sum(dim=2).abs(), torch.exp(-m))
    return num / denom[..., None]


def mlstm_step(state, q, k, v, i_pre, f_pre):
    """Recurrent form (decode): q, k, v ``(B, H, hd)``, state ``(C, n, m)``
    -> (new state, ``(B, H, hd)`` in f32)."""
    C, n, m = state
    hd = q.shape[-1]
    lf = F.logsigmoid(f_pre.float())
    li = i_pre.float()
    m_new = torch.maximum(lf + m, li)
    f_eff = torch.exp(lf + m - m_new)[..., None]
    i_eff = torch.exp(li - m_new)[..., None]
    k32 = k.float() / np.sqrt(hd)
    v32 = v.float()
    C_new = (f_eff[..., None] * C
             + i_eff[..., None] * k32[..., :, None] * v32[..., None, :])
    n_new = f_eff * n + i_eff * k32
    q32 = q.float()
    num = torch.einsum("bhd,bhde->bhe", q32, C_new)
    denom = torch.maximum(torch.einsum("bhd,bhd->bh", q32, n_new).abs(),
                          torch.exp(-m_new))
    return (C_new, n_new, m_new), num / denom[..., None]


def _mlstm_block(pl, x, cfg: ArchConfig, state=None):
    """Full block over x ``(B, S, D)``; with ``state`` one recurrent step
    (S = 1) -> (x, the new state or None)."""
    d, di, h, hd = _dims(cfg)
    b, s, _ = x.shape
    up = _norm(x, pl["ln"], cfg) @ pl["w_up"]
    if shlib.is_dtensor(up):  # a placed state is written in place
        return x + _mlstm_placed(pl, up, cfg, state), None
    xm, z = up[..., :di], up[..., di:]
    xm = shard_act(xm, ("batch", "seq", "mlp"))
    q, k, v, i_pre, f_pre = _mlstm_qkvif(pl, xm, cfg)
    if state is None:
        hcell, new_state = mlstm_parallel(q, k, v, i_pre, f_pre), None
    else:
        new_state, hcell = mlstm_step(state, q[:, 0], k[:, 0], v[:, 0],
                                      i_pre[:, 0], f_pre[:, 0])
        hcell = hcell[:, None]
    hcell = _norm(hcell, pl["out_norm"], cfg)
    hflat = hcell.reshape(b, s, di).to(cfg.dtype) * F.silu(z)
    return x + hflat @ pl["w_down"], new_state


def _mlstm_placed(pl, up, cfg: ArchConfig, state=None):
    """The mLSTM block after its up-projection, on DTensor ``up`` ``(B, S,
    2 di)`` (its columns on "model") -> the block's output, replicated.

    ``up`` is gathered over "model" (its gradient reduce-scattered back),
    then each rank runs its heads in a manual region: q, k and v from its
    columns of ``wq``, ``wk``, ``wv`` (the heads ``[r H/m, (r+1) H/m)``),
    the gates from its rows of ``w_if`` (a partial sum over "model",
    summed by one all-reduce of ``(B, S, 2H)``), the parallel form, and its
    rows of ``w_down`` (a partial sum of the output, summed by one
    all-reduce).  With ``state`` (one block's placed decode state, its
    heads split as q's) the recurrent step runs instead of the parallel
    form, and the new state is written into the rank's blocks."""
    from torch.distributed.tensor import Partial

    d, di, h, hd = _dims(cfg)
    mesh = up.device_mesh
    rank, m = shlib.model_block(mesh)
    if h % m or pl["wq"].to_local().shape[-1] != di // m:
        return _mlstm_sub_head(pl, up, cfg, state)
    hl = h // m
    cols = slice(rank * hl * hd, (rank + 1) * hl * hd)
    upl = shlib.local_part(shlib.gather_model(up), up)
    loc = {k: shlib.local_part(pl[k], up) for k in (
        "wq", "wk", "wv", "w_if", "b_if", "out_norm", "w_down")}
    with shlib.manual_region(mesh):
        xm, z = upl[..., :di], upl[..., di:]
        xm = shard_act(xm, ("batch", "seq", "mlp"))
        b, s, _ = xm.shape
        q = (xm @ loc["wq"]).reshape(b, s, hl, hd)
        k = (xm @ loc["wk"]).reshape(b, s, hl, hd)
        v = (xm @ loc["wv"]).reshape(b, s, hl, hd)
        gates = xm[..., cols].float() @ loc["w_if"]
    gates = shlib.sum_partial(shlib.from_local(gates, up, Partial()))
    gates = shlib.local_part(gates, up)
    with shlib.manual_region(mesh):
        gates = gates + lane_scale(loc["b_if"], gates)
        i_pre = gates[..., rank * hl:(rank + 1) * hl]
        f_pre = gates[..., h + rank * hl:h + (rank + 1) * hl]
        hcell = _norm(_mlstm_core(q, k, v, i_pre, f_pre, state),
                      loc["out_norm"], cfg)
        hflat = hcell.reshape(b, s, hl * hd).to(cfg.dtype) * F.silu(z[..., cols])
        out = hflat @ loc["w_down"]
    return shlib.sum_partial(shlib.from_local(out, up, Partial()))


def _mlstm_sub_head(pl, up, cfg: ArchConfig, state=None):
    """:func:`_mlstm_placed` where the heads do not divide "model": a rank's
    columns of ``wq``, ``wk``, ``wv`` and ``w_down`` are part of a head
    (16 ranks over 4 heads: a quarter each), or the block is not on
    "model" at all.  ``wq``, ``wk`` and ``wv`` are gathered over "model"
    (one all-gather each; their gradients, partial sums over the ranks
    that share a head, are reduce-scattered back), and each rank computes
    the whole parallel form and ``out_norm`` of the heads its columns fall
    in, then keeps its own columns of h before its rows of ``w_down``: the
    output a partial sum over "model", summed by one all-reduce as the
    whole-heads path's.  The gates come whole from the same all-reduce of
    the rank's rows of ``w_if``.  Without the block on "model" every rank
    runs every head alike and nothing is summed.  With ``state`` (one
    block's decode state, whole on every rank of "model") the one token's
    q, k and v are cheaper to gather than the weights
    (:func:`_mlstm_sub_head_step`)."""
    from torch.distributed.tensor import Partial

    d, di, h, hd = _dims(cfg)
    mesh = up.device_mesh
    rank, m = shlib.model_block(mesh)
    width = pl["w_down"].to_local().shape[-2]  # the rank's columns of h
    split = m > 1 and width != di
    lo = rank * width if split else 0
    h0, h1 = lo // hd, -(-(lo + width) // hd)  # the heads the columns meet
    cols = slice(lo, lo + width)
    upl = shlib.local_part(shlib.gather_model(up), up, own_model=split)
    if state is not None:
        return _mlstm_sub_head_step(pl, up, upl, cfg, state, split, cols)
    loc = {k: shlib.gathered_local(pl[k], up) for k in ("wq", "wk", "wv")}
    loc.update({k: shlib.local_part(pl[k], up, own_model=split) for k in (
        "w_if", "b_if", "out_norm", "w_down")})
    with shlib.manual_region(mesh):
        xm, z = upl[..., :di], upl[..., di:]
        b, s, _ = xm.shape
        heads = slice(h0 * hd, h1 * hd)
        q, k, v = ((xm @ loc[w][:, heads]).reshape(b, s, h1 - h0, hd)
                   for w in ("wq", "wk", "wv"))
        gates = xm[..., cols].float() @ loc["w_if"]
    gates = shlib.from_local(gates, up, Partial() if split else None)
    gates = shlib.local_part(shlib.sum_partial(gates), up, own_model=split)
    with shlib.manual_region(mesh):
        gates = gates + lane_scale(loc["b_if"], gates)
        hcell = _norm(mlstm_parallel(q, k, v, gates[..., h0:h1],
                                     gates[..., h + h0:h + h1]),
                      loc["out_norm"], cfg)
        hflat = hcell.reshape(b, s, (h1 - h0) * hd)[
            ..., lo - h0 * hd:lo - h0 * hd + width]
        out = (hflat.to(cfg.dtype) * F.silu(z[..., cols])) @ loc["w_down"]
    return shlib.sum_partial(
        shlib.from_local(out, up, Partial() if split else None))


def _mlstm_core(q, k, v, i_pre, f_pre, state):
    """The parallel form over the sequence, or with ``state`` (placed, the
    rank's blocks a match for the heads given) one recurrent step whose
    new state is written into the rank's blocks -> h ``(B, S, H, hd)``."""
    if state is None:
        return mlstm_parallel(q, k, v, i_pre, f_pre)
    st = tuple(t.to_local() for t in state)
    new, hcell = mlstm_step(st, q[:, 0], k[:, 0], v[:, 0], i_pre[:, 0],
                            f_pre[:, 0])
    for old, t in zip(st, new):
        old.copy_(t)
    return hcell[:, None]


def _mlstm_sub_head_step(pl, up, upl, cfg: ArchConfig, state, split: bool,
                         cols: slice):
    """One decode step of :func:`_mlstm_sub_head`: each rank projects the
    token on its columns of ``wq``, ``wk`` and ``wv``, one all-gather over
    "model" makes q, k and v whole (``3 x B x di`` values, where the
    forward gathers ``3 x di x di`` of weights), and every rank steps the
    whole state alike; its columns of h then meet its rows of ``w_down``
    (a partial sum over "model", summed by one all-reduce)."""
    from torch.distributed import _functional_collectives as funcol
    from torch.distributed.tensor import Partial

    d, di, h, hd = _dims(cfg)
    mesh = up.device_mesh
    loc = {k: shlib.local_part(pl[k], up, own_model=split) for k in (
        "wq", "wk", "wv", "w_if", "b_if", "out_norm", "w_down")}
    with shlib.manual_region(mesh):
        xm, z = upl[..., :di], upl[..., di:]
        qkv = torch.stack([xm @ loc[w] for w in ("wq", "wk", "wv")])
        if qkv.shape[-1] != di:
            qkv = funcol.all_gather_tensor(
                qkv, 3, (mesh, mesh.mesh_dim_names.index("model")))
        gates = xm[..., cols].float() @ loc["w_if"]
    gates = shlib.from_local(gates, up, Partial() if split else None)
    gates = shlib.local_part(shlib.sum_partial(gates), up, own_model=split)
    with shlib.manual_region(mesh):
        gates = gates + lane_scale(loc["b_if"], gates)
        b = xm.shape[0]
        q, k, v = (t.reshape(b, 1, h, hd) for t in qkv)
        hcell = _norm(_mlstm_core(q, k, v, gates[..., :h], gates[..., h:],
                                  state), loc["out_norm"], cfg)
        hflat = hcell.reshape(b, 1, di)[..., cols]
        out = (hflat.to(cfg.dtype) * F.silu(z[..., cols])) @ loc["w_down"]
    return shlib.sum_partial(
        shlib.from_local(out, up, Partial() if split else None))


# ---------------------------------------------------------------------------
# sLSTM core.
# ---------------------------------------------------------------------------

def _gates(t, h: int, hd: int):
    """``(..., 4 h hd)`` gate pre-activations -> ``(..., h, hd, 4)``: the
    four gates of a unit are adjacent (interleaved), as in the reference."""
    return t.reshape(t.shape[:-1] + (h, hd, 4))


def _slstm_cell(pre, state):
    """pre ``(B, H, hd, 4)`` gate pre-activations; state ``(c, n, m, h)``."""
    c, n, m, _ = state
    i_pre, f_pre, z_pre, o_pre = pre.unbind(-1)
    lf = F.logsigmoid(f_pre)
    m_new = torch.maximum(lf + m, i_pre)
    i_eff = torch.exp(i_pre - m_new)
    f_eff = torch.exp(lf + m - m_new)
    c_new = f_eff * c + i_eff * torch.tanh(z_pre)
    n_new = torch.clamp_min(f_eff * n + i_eff, 1e-6)
    h_new = torch.sigmoid(o_pre) * (c_new / n_new)
    return (c_new, n_new, m_new, h_new)


def _slstm_recur(r, px, h_prev, lanes: bool):
    """The recurrent gate contribution added to one step's precomputed
    input projection px ``(B, H, hd, 4)``; h_prev ``(B, H, hd)``; ``r`` the
    ``(H, hd, 4 hd)`` block-diagonal weights, with ``lanes`` each row's own
    of the ``(B, H, hd, 4 hd)`` stack."""
    pr = torch.einsum("bhe,bheg->bhg" if lanes else "bhe,heg->bhg",
                      h_prev, r.float())
    return px + pr.reshape(px.shape)


def _slstm_scan(r, px_all, lanes: bool):
    """The sLSTM's time loop (the reference's ``lax.scan``) over the input
    projections ``px_all`` ``(B, S, H, hd, 4)`` from the zero state with
    the stabilizer at -2e38 -> h ``(B, S, H, hd)``."""
    zeros = px_all.new_zeros(px_all.shape[:1] + px_all.shape[2:4])
    st = (zeros, zeros, torch.full_like(zeros, _NEG), zeros)
    hs = []
    for t in range(px_all.shape[1]):
        st = _slstm_cell(_slstm_recur(r, px_all[:, t], st[3], lanes), st)
        hs.append(st[3])
    return torch.stack(hs, dim=1)


def _slstm_local(pl, px, cfg: ArchConfig, state=None):
    """The sLSTM's gates and :func:`_slstm_scan` from DTensor ``px`` ``(B,
    S, 4d)``, its input projection without the bias (the columns, one head
    after another, on "model" where the heads divide it), on each rank's
    local heads and batch rows, in a manual region: the recurrence is
    block-diagonal, one block a head, so a rank's heads need no other
    rank's.  -> h ``(B, S, H, hd)``, the heads placed as ``px``'s columns.
    Where the heads do not divide "model" (4 heads on 16 ranks), the
    recurrence cannot be split inside a head without a collective every
    position: ``px``'s columns are gathered there (one all-gather) and
    every rank runs every head alike, its inputs' gradients whole.  With
    ``state`` (one block's placed decode state, its heads split as the
    columns are) one step runs from it, and the new state is written into
    the rank's blocks."""
    from torch.distributed.tensor import Shard

    hd = cfg.d_model // cfg.n_heads
    mesh = px.device_mesh
    rank, m = shlib.model_block(mesh)
    split = m > 1 and cfg.n_heads % m == 0 and px.placements[
        mesh.mesh_dim_names.index("model")].is_shard()
    if not split:  # every head on every rank: the columns gathered first
        px = shlib.gather_model(px)
    r = shlib.local_part(pl["r"], px, own_model=split)
    b = shlib.local_part(pl["b"], px, own_model=split)
    pxl = shlib.local_part(px, px, own_model=split)
    with shlib.manual_region(mesh):
        w = pxl.shape[-1]
        lo = rank * w if split else 0
        gates = _gates(pxl + b[lo:lo + w], w // (4 * hd), hd)
        if state is None:
            hs = _slstm_scan(r, gates, False)
        else:
            st = tuple(t.to_local() for t in state)
            new = _slstm_cell(_slstm_recur(r, gates[:, 0], st[3], False), st)
            for old, t in zip(st, new):
                old.copy_(t)
            hs = new[3][:, None]
    return shlib.from_local(hs, px, Shard(2) if split else None)


def _slstm_input_proj(pl, xn, cfg: ArchConfig):
    """The input projection of the whole sequence, ``(B, S, H, hd, 4)``,
    outside the time loop (only ``h @ R`` stays sequential)."""
    d, _, h, _ = _dims(cfg)
    px = xn.float() @ pl["wx"].float()
    px = px + lane_scale(pl["b"], px)
    return _gates(px, h, d // h)


def _slstm_block(pl, x, cfg: ArchConfig, state=None, lanes: bool = False):
    d = cfg.d_model
    b, s, _ = x.shape
    xn = _norm(x, pl["ln"], cfg)
    if shlib.is_dtensor(xn):  # a placed state is written in place
        hs = _slstm_local(pl, xn.float() @ pl["wx"].float(), cfg, state)
        new_state = None
    elif state is None:
        hs = _slstm_scan(pl["r"], _slstm_input_proj(pl, xn, cfg),
                         lanes)  # (B, S, H, hd)
        new_state = None
    else:
        px = _slstm_input_proj(pl, xn[:, :1], cfg)[:, 0]
        new_state = _slstm_cell(_slstm_recur(pl["r"], px, state[3], lanes),
                                state)
        hs = new_state[3][:, None]
    hs = _norm(hs, pl["out_norm"], cfg)
    # A rank's heads under the pod runtime: gathered over "model".
    x = x + shlib.gather_model(hs.reshape(b, s, d).to(cfg.dtype))
    xn2 = _norm(x, pl["ln_ffn"], cfg)  # post-FFN (pf 4/3)
    hmid = F.silu(xn2 @ pl["ffn_wi"]) * (xn2 @ pl["ffn_wg"])
    return x + shlib.sum_partial(hmid @ pl["ffn_wo"]), new_state


# ---------------------------------------------------------------------------
# Stack: groups of n_m mLSTM blocks and n_s sLSTM blocks.
# ---------------------------------------------------------------------------

def _logits(params, x, cfg: ArchConfig):
    return (_norm(x, params["final_norm"], cfg)
            @ shlib.unshard_data(params["lm_head"]))


def forward(params, batch, cfg: ArchConfig):
    """Full-sequence forward (the parallel mLSTM form) -> (logits, {})."""
    lanes = _lanes(params)
    x = shard_act(_embed_tokens(params, batch["tokens"], cfg),
                  ("batch", "seq", "embed"))
    n_m, g, n_s = _groups(cfg)
    remat = cfg.remat and torch.is_grad_enabled()
    for gi in range(g):
        def group(x, gi=gi):
            for j in range(n_m):
                x, _ = _mlstm_block(_block(params["mlstm"], gi, j, lanes),
                                    x, cfg)
            for j in range(n_s):
                x, _ = _slstm_block(_block(params["slstm"], gi, j, lanes),
                                    x, cfg, lanes=lanes)
            return x

        x = checkpoint(group, x, use_reentrant=False) if remat else group(x)
    return shard_act(_logits(params, x, cfg), ("batch", "seq", "vocab")), {}


def loss(params, batch, cfg: ArchConfig):
    logits, _ = forward(params, batch, cfg)
    # Each row's softmax reads every vocab entry: under the pod runtime the
    # logits' vocab shards are gathered first (one all-gather).
    logits = shard_act(logits, ("batch", "seq", None))
    ce, acc = softmax_xent(logits[:, :-1], batch["tokens"][:, 1:])
    return ce, (ce, acc)


def prefill(params, batch, cfg: ArchConfig, cache_len: int):
    """Recurrent prefill, as the reference's: :func:`decode_step` over the
    prompt from the zero state -> (logits ``(B, S, V)``, final state).
    ``cache_len`` is unused (the state is O(1))."""
    del cache_len
    tokens = batch["tokens"]
    b, s = tokens.shape
    cache = new_cache(cache_defs(cfg, b, 0), tokens, cfg)
    out = []
    for t in range(s):
        logits, cache = decode_step(params, cache, tokens[:, t], 0, cfg)
        out.append(logits)
    return torch.stack(out, dim=1), cache


_M_STATE = ("m_C", "m_n", "m_m")
_S_STATE = ("s_c", "s_n", "s_m", "s_h")


def decode_step(params, cache, tokens, pos, cfg: ArchConfig):
    """One token (B,) -> (logits (B, V), cache); the recurrent state is
    position-free (``pos`` is unused) and updated IN PLACE; under the pod
    runtime on each rank's blocks (the blocks write their own)."""
    del pos
    lanes = _lanes(params)
    x = shard_act(_embed_tokens(params, tokens[:, None], cfg),
                  ("batch", None, "embed"))
    n_m, g, n_s = _groups(cfg)
    for gi in range(g):
        for j in range(n_m):
            st = tuple(cache[k][gi, j] for k in _M_STATE)
            x, new = _mlstm_block(_block(params["mlstm"], gi, j, lanes), x,
                                  cfg, st)
            for old, t in zip(st, new or ()):
                old.copy_(t)
        for j in range(n_s):
            st = tuple(cache[k][gi, j] for k in _S_STATE)
            x, new = _slstm_block(_block(params["slstm"], gi, j, lanes), x,
                                  cfg, st, lanes)
            for old, t in zip(st, new or ()):
                old.copy_(t)
    return _logits(params, x, cfg)[:, 0], cache
