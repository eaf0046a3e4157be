"""Hymba (arXiv:2411.13676) — the port of ``repro.models.hymba``: hybrid
layers that run attention heads and a Mamba-style selective SSM head *in
parallel* on the same input, learnable meta tokens before the sequence,
and sliding-window attention except on the global layers.

Per layer: ``y = 0.5 * (rmsnorm(attn(x)) + rmsnorm(ssm(x)))``, then a
SwiGLU MLP.  The ``cfg.n_meta_tokens`` meta tokens take positions 0 ..
n_meta - 1 (for the rope and the masks) and the text the positions after
them, so on a windowed layer the window closes the meta tokens to text far
enough along, as in the reference.  The attention is the port's GQA
(:func:`repro_torch.models.attention.gqa_forward`): its core is the flash
kernel, and under autograd the flash backward kernel.  Decode keeps a KV
cache of n_meta + ``length`` positions and the SSM state ``ssm_h`` (O(1)
in the length); :func:`decode_step` writes and reads the cache at ``pos +
n_meta`` and updates it IN PLACE (the reference returns a new one).

The SSM scan over the sequence, ``h_t = decay_t h_{t-1} + u_t B_t`` from h
= 0, is the reference's ``associative_scan`` done as a Hillis-Steele scan
(:func:`_scan`): ceil(log2 S) passes over the whole ``(B, S, d_inner, N)``
operand, each one fused multiply-add and a concatenation, with the decays
kept at ``(B, S, d_inner)``.  It sums in a tree order, as the reference
does, and plain autograd differentiates it.

Every entry point also takes lane-stacked parameters (a leading lane axis,
one lane per batch row; see ``models.transformer``): each lane puts its own
``(n_meta, d)`` meta tokens before its row, the projections are batched
matmuls, and the norm scales and the SSM's per-channel ``b_dt``,
``A_log`` and ``D`` broadcast per lane; :func:`_scan` has no weights.

Under the pod runtime (DTensor activations and weights placed by
``spec_for``) the attention runs on each rank's local heads
(``attention.gqa_forward``) and the SSM branch on each rank's
``"ssm_inner"`` channels, in a manual region (:func:`_ssm_placed`); each
branch's output, a partial sum over "model", is summed there before its
norm.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.launch import sharding as shlib
from repro_torch.models import attention as attn
from repro_torch.models.layers import lane_scale, shard_act, softmax_xent
from repro_torch.models.moe import swiglu_defs, swiglu_forward
from repro_torch.models.pdefs import PDef
from repro_torch.models.transformer import (
    _embed_tokens,
    _lanes,
    _layer,
    _layer_meta,
    _norm,
    new_cache,
)

__all__ = ["param_defs", "cache_defs", "forward", "loss", "prefill",
           "decode_step"]


def _di(cfg: ArchConfig) -> int:
    return cfg.ssm_expand * cfg.d_model


def _ssm_defs(cfg: ArchConfig, stacked: tuple) -> dict:
    d, di, n = cfg.d_model, _di(cfg), cfg.ssm_state
    L, Lax = stacked, ("layers",) * len(stacked)
    dt, f32 = cfg.dtype, torch.float32
    return {
        "w_in": PDef(L + (d, 2 * di), Lax + ("embed", "ssm_inner"), dt, fan_in=d),
        "w_dt": PDef(L + (di, di), Lax + ("ssm_inner", None), dt, fan_in=di),
        "b_dt": PDef(L + (di,), Lax + (None,), f32, "zeros"),
        "A_log": PDef(L + (di,), Lax + ("ssm_inner",), f32, "zeros"),
        "w_B": PDef(L + (di, n), Lax + ("ssm_inner", None), dt, fan_in=di),
        "w_C": PDef(L + (di, n), Lax + ("ssm_inner", None), dt, fan_in=di),
        "D": PDef(L + (di,), Lax + ("ssm_inner",), f32, "ones"),
        "w_out": PDef(L + (di, d), Lax + ("ssm_inner", "embed"), dt, fan_in=di),
    }


def param_defs(cfg: ArchConfig) -> dict:
    L, d, v = (cfg.n_layers,), cfg.d_model, cfg.padded_vocab
    f32 = torch.float32
    layers = {
        "attn": attn.gqa_defs(cfg, stacked=L),
        "ssm": _ssm_defs(cfg, L),
        "ln1": PDef(L + (d,), ("layers", None), f32, "zeros"),
        "ln2": PDef(L + (d,), ("layers", None), f32, "zeros"),
        "norm_attn": PDef(L + (d,), ("layers", None), f32, "zeros"),
        "norm_ssm": PDef(L + (d,), ("layers", None), f32, "zeros"),
        "mlp": swiglu_defs(cfg, stacked=L),
    }
    return {
        "layers": layers,
        "meta_tokens": PDef((cfg.n_meta_tokens, d), (None, "embed"), cfg.dtype,
                            fan_in=d),
        "embed": PDef((v, d), ("vocab", "embed"), cfg.dtype, fan_in=d),
        "lm_head": PDef((d, v), ("embed", "vocab"), cfg.dtype, fan_in=d),
        "final_norm": PDef((d,), (None,), f32, "zeros"),
    }


def cache_defs(cfg: ArchConfig, batch: int, length: int) -> dict:
    """KV cache over the meta tokens and ``length`` positions, and the SSM
    state."""
    kv = attn.gqa_cache_defs(cfg, batch, length + cfg.n_meta_tokens,
                             stacked=(cfg.n_layers,))
    kv["ssm_h"] = PDef((cfg.n_layers, batch, _di(cfg), cfg.ssm_state),
                       ("layers", "batch", "ssm_inner", None), torch.float32,
                       "zeros")
    return kv


# ---------------------------------------------------------------------------
# SSM branch (diagonal selective state space, S6-style).
# ---------------------------------------------------------------------------

def _ssm_proj(pl, xn, cfg: ArchConfig):
    di = _di(cfg)
    up = xn @ pl["w_in"]
    xm, z = up[..., :di], up[..., di:]
    x32 = xm.float()
    dt = x32 @ pl["w_dt"].float()
    dt = F.softplus(dt + lane_scale(pl["b_dt"], dt))
    # (B, S, di) in (0, 1]
    decay = torch.exp(dt * -torch.exp(lane_scale(pl["A_log"], dt)))
    Bm = x32 @ pl["w_B"].float()
    Cm = x32 @ pl["w_C"].float()
    return xm, z, decay, Bm, Cm, dt * x32


def _scan(decay, contrib):
    """``h_t = decay_t h_{t-1} + contrib_t`` from h = 0 over axis 1:
    decay ``(B, S, di)``, contrib ``(B, S, di, N)`` -> h like contrib.

    Hillis-Steele: after the pass at offset k, position t holds the
    composition of positions t - 2k + 1 .. t (the reference's combine,
    ``(a_l a_r, b_l a_r + b_r)``, with the earlier window on the left)."""
    a, h = decay, contrib
    s, k = a.shape[1], 1
    while k < s:
        h = torch.cat([h[:, :k], torch.addcmul(h[:, k:], a[:, k:, :, None],
                                               h[:, :-k])], dim=1)
        if 2 * k < s:
            a = torch.cat([a[:, :k], a[:, k:] * a[:, :-k]], dim=1)
        k *= 2
    return h


def _ssm_scan(pl, xn, cfg: ArchConfig, state=None, last: bool = False):
    """The SSM branch over xn ``(B, S, D)``: from h = 0 over the sequence,
    or one step (S = 1) from ``state`` ``(B, di, N)`` -> (y ``(B, S, D)``,
    the last h).  Under the pod runtime (a DTensor ``xn``) the branch runs
    on each rank's channels (:func:`_ssm_placed`): the last h comes back as
    a DTensor with ``last`` (None without), and a step's ``state`` (a
    placed cache leaf) is updated in place."""
    if shlib.is_dtensor(xn):
        return _ssm_placed(pl, xn, cfg, state, last)
    xm, z, decay, Bm, Cm, u = _ssm_proj(pl, xn, cfg)
    contrib = u[..., None] * Bm[:, :, None, :]  # (B, S, di, N)
    if state is None:
        h = _scan(decay, contrib)
    else:
        h = (decay[:, 0, :, None] * state + contrib[:, 0])[:, None]
    y = (torch.einsum("bsen,bsn->bse", h, Cm)
         + lane_scale(pl["D"], xm) * xm.float())
    y = y.to(cfg.dtype) * F.silu(z)
    return y @ pl["w_out"], h[:, -1]


def _ssm_placed(pl, xn, cfg: ArchConfig, state=None, last: bool = False):
    """The SSM branch over DTensor ``xn`` (batch rows on "data") with its
    weights placed by ``spec_for`` (``"ssm_inner"`` on "model") -> (its
    output, replicated; with ``last`` the last h on the rank's channels, a
    DTensor, else None).

    The up-projection's columns are gathered over "model" (its gradient
    reduce-scattered back), and each rank takes its channels ``[r di/m,
    (r+1) di/m)`` of ``xm`` and ``z``.  The projections by the rows of
    ``w_dt``, ``w_B`` and ``w_C`` it holds are partial sums over "model":
    dt is reduce-scattered to the rank's channels, B and C (``2N`` columns)
    all-reduced whole.  The scan runs over the sequence on the rank's
    channels, and its rows of ``w_out`` give a partial sum of the output,
    summed by one all-reduce.  Where "model" does not split the channels,
    every rank runs them all, whose gradient then counts once.  With
    ``state`` (the placed ``(B, di, N)`` cache leaf of one layer, split as
    the channels are) the branch takes one step from it instead of the
    scan, and writes the new h into the rank's block."""
    from torch.distributed.tensor import Partial, Shard

    di, n = _di(cfg), cfg.ssm_state
    up = xn @ pl["w_in"]
    mesh = up.device_mesh
    rank, m = shlib.model_block(mesh)
    upl = shlib.local_part(shlib.gather_model(up), up)
    loc = {k: shlib.local_part(pl[k], up) for k in (
        "w_dt", "b_dt", "A_log", "w_B", "w_C", "D", "w_out")}
    c = loc["A_log"].shape[-1]  # the rank's channels
    split = c < di
    lo = rank * c if split else 0
    with shlib.manual_region(mesh):
        xm, z = upl[..., lo:lo + c], upl[..., di + lo:di + lo + c]
        x32 = xm.float()
        dt = x32 @ loc["w_dt"].float()
        bc = torch.cat([x32 @ loc["w_B"].float(), x32 @ loc["w_C"].float()],
                       -1)
    if split:
        dt = shlib.from_local(dt, up, Partial())
        dt = shlib.local_part(dt.redistribute(mesh, [
            Shard(2) if p.is_partial() else p for p in dt.placements]), up)
        bc = shlib.local_part(shlib.sum_partial(
            shlib.from_local(bc, up, Partial())), up)
    with shlib.manual_region(mesh):
        dt = F.softplus(dt + loc["b_dt"][lo:lo + c])
        decay = torch.exp(dt * -torch.exp(loc["A_log"]))
        contrib = (dt * x32)[..., None] * bc[:, :, None, :n]
        if state is None:
            h = _scan(decay, contrib)
        else:
            hl = state.to_local()
            h = (decay[:, 0, :, None] * hl + contrib[:, 0])[:, None]
            hl.copy_(h[:, 0])
        y = (torch.einsum("bsen,bsn->bse", h, bc[..., n:])
             + loc["D"] * xm.float())
        out = (y.to(cfg.dtype) * F.silu(z)) @ loc["w_out"]
        if not split:
            out = shlib.shared_grad(out, m)
    h_last = (shlib.from_local(h[:, -1], up, Shard(1) if split else None)
              if last else None)
    return shlib.sum_partial(shlib.from_local(
        out, up, Partial() if split else None)), h_last


# ---------------------------------------------------------------------------
# Hybrid layer + stack.
# ---------------------------------------------------------------------------

def _with_meta(params, tokens, cfg: ArchConfig, lanes: bool):
    """The meta tokens, then the token embeddings: ``(B, n_meta + S, D)``;
    with ``lanes``, each row's own lane's meta tokens."""
    x = _embed_tokens(params, tokens, cfg)
    meta = shlib.unshard_data(params["meta_tokens"])
    if shlib.is_dtensor(x):  # the meta tokens of the rank's rows
        ml = shlib.local_part(meta, x, own_model=False)
        return torch.cat([shlib.from_local(ml[None].expand(
            x.to_local().shape[:1] + ml.shape), x), x], dim=1)
    if not lanes:
        meta = meta[None].expand((x.shape[0],) + meta.shape)
    return torch.cat([meta, x], dim=1)


def _mix(pl, x, a, s_out, cfg: ArchConfig):
    """The residual update of a layer from its attention and SSM outputs
    (under the pod runtime each a partial sum over "model" until summed
    here)."""
    mix = 0.5 * (_norm(shlib.sum_partial(a), pl["norm_attn"], cfg)
                 + _norm(s_out, pl["norm_ssm"], cfg))
    x = x + shard_act(mix, ("batch", "seq", "embed"))
    return x + shlib.sum_partial(swiglu_forward(pl["mlp"],
                                                _norm(x, pl["ln2"], cfg)))


def _hybrid(pl, x, cfg: ArchConfig, window, theta, positions,
            return_kv=False):
    """One layer over the full sequence -> (x, (k, v) or None, last h)."""
    xn = _norm(x, pl["ln1"], cfg)
    a = attn.gqa_forward(pl["attn"], xn, cfg, window=window, theta=theta,
                         positions=positions, return_kv=return_kv)
    a, kv = a if return_kv else (a, None)
    s_out, h_last = _ssm_scan(pl["ssm"], xn, cfg, last=return_kv)
    return _mix(pl, x, a, s_out, cfg), kv, h_last


def _head(params, x, cfg: ArchConfig):
    return (_norm(x, params["final_norm"], cfg)
            @ shlib.unshard_data(params["lm_head"]))


def forward(params, batch, cfg: ArchConfig):
    """Full-sequence forward -> (logits of the text positions, {})."""
    lanes = _lanes(params)
    x = shard_act(_with_meta(params, batch["tokens"], cfg, lanes),
                  ("batch", "seq", "embed"))
    b, s = x.shape[:2]
    positions = torch.arange(s, device=x.device).expand(b, s)
    remat = cfg.remat and torch.is_grad_enabled()
    for i, (win, th) in enumerate(zip(*_layer_meta(cfg))):
        def body(x, pl=_layer(params["layers"], i, lanes), win=win, th=th):
            return _hybrid(pl, x, cfg, win, th, positions)[0]

        x = checkpoint(body, x, use_reentrant=False) if remat else body(x)
    return shard_act(_head(params, x[:, cfg.n_meta_tokens:], cfg),
                     ("batch", "seq", "vocab")), {}


def loss(params, batch, cfg: ArchConfig):
    logits, _ = forward(params, batch, cfg)
    # Each row's softmax reads every vocab entry: under the pod runtime the
    # logits' vocab shards are gathered first (one all-gather).
    logits = shard_act(logits, ("batch", "seq", None))
    ce, acc = softmax_xent(logits[:, :-1], batch["tokens"][:, 1:])
    return ce, (ce, acc)


def prefill(params, batch, cfg: ArchConfig, cache_len: int):
    """Forward over the meta tokens and the prompt that also fills the
    cache -> (logits of the prompt, cache): KV zero-padded to n_meta +
    ``cache_len`` positions, and each layer's last SSM state."""
    lanes = _lanes(params)
    x = _with_meta(params, batch["tokens"], cfg, lanes)
    b, s = x.shape[:2]
    if s > cfg.n_meta_tokens + cache_len:
        raise ValueError(f"prompt length {s - cfg.n_meta_tokens} exceeds "
                         f"cache_len {cache_len}")
    positions = torch.arange(s, device=x.device).expand(b, s)
    cache = new_cache(cache_defs(cfg, b, cache_len), x, cfg)
    for i, (win, th) in enumerate(zip(*_layer_meta(cfg))):
        x, (k, v), h_last = _hybrid(_layer(params["layers"], i, lanes), x,
                                    cfg, win, th, positions, return_kv=True)
        attn.write_positions(cache["k"][i], k, 0)
        attn.write_positions(cache["v"][i], v, 0)
        h = cache["ssm_h"][i]
        if shlib.is_dtensor(h):  # the rank's block
            h.to_local().copy_(h_last.redistribute(
                h.device_mesh, h.placements).to_local())
        else:
            h.copy_(h_last)
    return _head(params, x[:, cfg.n_meta_tokens:], cfg), cache


def decode_step(params, cache, tokens, pos, cfg: ArchConfig):
    """One token (B,) at text position ``pos`` -> (logits (B, V), cache);
    the cache is read and written at ``pos + n_meta`` (its head holds the
    meta tokens), IN PLACE; under the pod runtime on each rank's blocks."""
    lanes = _lanes(params)
    x = shard_act(_embed_tokens(params, tokens[:, None], cfg),
                  ("batch", None, "embed"))
    cache_pos = int(pos) + cfg.n_meta_tokens
    for i, (win, th) in enumerate(zip(*_layer_meta(cfg))):
        pl = _layer(params["layers"], i, lanes)
        xn = _norm(x, pl["ln1"], cfg)
        a, _ = attn.gqa_decode(pl["attn"], xn, {
            "k": cache["k"][i], "v": cache["v"][i]}, cfg, cache_pos,
            window=win, theta=th)
        s_out, h_new = _ssm_scan(pl["ssm"], xn, cfg, state=cache["ssm_h"][i])
        if h_new is not None:  # a placed state is written in place
            cache["ssm_h"][i] = h_new
        x = _mix(pl, x, a, s_out, cfg)
    return _head(params, x, cfg)[:, 0], cache
