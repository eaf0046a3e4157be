"""Config-driven transformer stack — the port of
``repro.models.transformer``: GQA or MLA attention, a dense SwiGLU (or
GELU) MLP or a mixture of experts, for the three tasks of the zoo:

- ``lm``: a decoder over ``{"tokens": (B, S)}``, next-token loss;
- ``vlm``: a decoder over ``{"tokens": (B, St), "image_feats": (B, Ni,
  Fd)}``: the image features go through the projector MLP and sit before
  the text embeddings, and the loss is next-token over the text;
- ``masked_lm``: an encoder (``causal=False``) over ``{"features": (B, S,
  Fd), "mask": (B, S), "targets": (B, S)}``: masked frames take the learned
  ``mask_emb``, sinusoidal positions are added, and the loss is the cross
  entropy at the masked frames.

Parameters stay stacked on a leading layer axis as in the reference, so a
reference parameter tree carries across as a copy; the reference's
``lax.scan`` over layers becomes a Python loop over the layer views.
Per-layer heterogeneity (gemma3's 5:1 sliding-window pattern, dual rope
thetas) comes from :func:`_layer_meta` as plain Python numbers; with
``cfg.remat`` each layer of a forward that records gradients runs under
``torch.utils.checkpoint`` (the reference's ``jax.checkpoint`` of its scan
body: the layer is recomputed in the backward, with the same numbers).
:func:`forward` returns the MoE layers' mean aux load-balance loss as
``moe_aux`` (0 for a dense model), and :func:`loss` is the task's cross
entropy plus ``router_aux_coef`` times it.

:func:`prefill` of a vlm batch puts the image prefix in the cache first:
the caller sizes the cache as prefix + prompt + new tokens and decodes at
position prefix + prompt + i (``launch.serve.generate`` does).
:func:`decode_step` takes tokens only, as in the reference.  Under the pod
runtime (params, tokens placed over a pod's submesh) :func:`prefill` builds
the cache in the placement ``launch.sharding.cache_spec`` gives it
(:func:`new_cache`), and :func:`decode_step` reads and writes each rank's
blocks of it.

**Lanes.**  Every entry point also takes parameters stacked on a leading
*lane* axis, one lane per batch row (``final_norm`` of shape ``(B, d)``):
batch row b then runs on lane b's weights — the personalized serving of
``launch.steps.make_personalized_serve_step``, where the reference vmaps
over (params, batch) lanes with an inner batch of 1.  This holds for every
task and block kind (the xlstm and hymba modules call :func:`_lanes` too).
The projections, the MLP, the vlm projector and the encoder's ``in_proj``
become batched matmuls over the lane axis; norm scales and per-channel
vectors (``mask_emb`` among them) broadcast per lane through
:func:`~repro_torch.models.layers.lane_scale`; a MoE layer's router and
experts run on each lane's own weights, with capacity per batch row, that
is per lane (``models.moe``).  The attention core has no weights, so the
flash kernel sees the lanes as its batch.  With lanes, :func:`forward`
returns ``moe_aux`` per lane, shape ``(B,)``, as ``jax.vmap`` of the
reference's forward does.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.launch import sharding as shlib
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_lib
from repro_torch.models.layers import (
    lane_scale,
    rms_norm,
    shard_act,
    sinusoidal_positions,
    softmax_xent,
)
from repro_torch.models.pdefs import PDef

__all__ = [
    "param_defs",
    "cache_defs",
    "forward",
    "loss",
    "prefill",
    "decode_step",
    "new_cache",
]


def _layer_meta(cfg: ArchConfig) -> tuple[list[int], list[float]]:
    """(window, rope theta) of every layer; window 0 = full attention."""
    windows = [cfg.window_for_layer(i) for i in range(cfg.n_layers)]
    if cfg.global_rope_theta:
        thetas = [cfg.global_rope_theta if w == 0 else cfg.rope_theta
                  for w in windows]
    else:
        thetas = [cfg.rope_theta] * cfg.n_layers
    return windows, thetas


def _lanes(params) -> bool:
    """Whether ``params`` carry a leading lane axis (see the module
    docstring), told by ``final_norm``, a leaf of every task and block
    kind."""
    return params["final_norm"].dim() == 2


def _layer(tree, i: int, lanes: bool = False):
    """Layer ``i``'s view of a layer-stacked tree (no copy); the layer axis
    follows the lane axis when there is one.  Under the pod runtime with
    FSDP the layer's "data" shards are gathered here, a layer at a time."""
    if isinstance(tree, dict):
        return {k: _layer(v, i, lanes) for k, v in tree.items()}
    return shlib.unshard_data(tree[:, i] if lanes else tree[i])


# ---------------------------------------------------------------------------
# Parameter / cache declarations.
# ---------------------------------------------------------------------------

def param_defs(cfg: ArchConfig) -> dict:
    L, d, v = (cfg.n_layers,), cfg.d_model, cfg.padded_vocab
    layers = {
        "attn": (attn.mla_defs(cfg, stacked=L) if cfg.attn_type == "mla"
                 else attn.gqa_defs(cfg, stacked=L)),
        "mlp": (moe_lib.moe_defs(cfg, stacked=L) if cfg.n_experts
                else moe_lib.swiglu_defs(cfg, stacked=L)),
        "ln1": PDef(L + (d,), ("layers", None), torch.float32, "zeros"),
        "ln2": PDef(L + (d,), ("layers", None), torch.float32, "zeros"),
    }
    defs = {
        "layers": layers,
        "final_norm": PDef((d,), (None,), torch.float32, "zeros"),
    }
    if cfg.task in ("lm", "vlm"):
        defs["embed"] = PDef((v, d), ("vocab", "embed"), cfg.dtype, fan_in=d)
        if not cfg.tie_embeddings:
            defs["lm_head"] = PDef((d, v), ("embed", "vocab"), cfg.dtype,
                                   fan_in=d)
    if cfg.task == "vlm":
        fd = cfg.frontend_dim
        defs["projector"] = {
            "w1": PDef((fd, d), ("frontend", "embed"), cfg.dtype, fan_in=fd),
            "w2": PDef((d, d), ("embed", "mlp"), cfg.dtype, fan_in=d),
        }
    if cfg.task == "masked_lm":
        fd = cfg.frontend_dim
        defs["in_proj"] = PDef((fd, d), ("frontend", "embed"), cfg.dtype,
                               fan_in=fd)
        defs["mask_emb"] = PDef((d,), (None,), cfg.dtype)
        defs["lm_head"] = PDef((d, v), ("embed", "vocab"), cfg.dtype, fan_in=d)
    return defs


def cache_defs(cfg: ArchConfig, batch: int, length: int) -> dict:
    L = (cfg.n_layers,)
    if cfg.attn_type == "mla":
        return attn.mla_cache_defs(cfg, batch, length, stacked=L)
    return attn.gqa_cache_defs(cfg, batch, length, stacked=L)


# ---------------------------------------------------------------------------
# Embedding and head.
# ---------------------------------------------------------------------------

def _embed_tokens(params, tokens, cfg: ArchConfig):
    """Embedding rows times sqrt(d_model), the constant rounded to the model
    dtype first as the reference does (sqrt(3840) = 61.97 is 62.0 in bf16).
    A table placed over the pod runtime's submesh (a DTensor) is looked up
    vocab-parallel (:func:`_vocab_parallel_rows`)."""
    emb = params["embed"]
    if emb.dim() == 3:  # lanes: row b looks up lane b's table
        lane = torch.arange(emb.shape[0], device=emb.device)[:, None]
        x = emb[lane, tokens.long()]
    elif shlib.is_dtensor(emb):
        x = _vocab_parallel_rows(emb, tokens)
    else:
        x = emb[tokens.long()]
    return x * torch.tensor(np.sqrt(cfg.d_model), dtype=cfg.dtype)


def _vocab_parallel_rows(emb, tokens):
    """The rows of DTensor ``emb`` (V, d) at DTensor ``tokens``, as the
    pod runtime places them: the table's vocab on "model" (its embed dim on
    "data" under FSDP, gathered first), the tokens' batch on "data".  Each
    rank looks up the tokens that fall in its vocab block on its local rows
    (0 elsewhere) and one all-reduce over the vocab axis sums them: the
    lookup, exactly (each row has one nonzero term).  The backward writes
    each rank's rows of the table's gradient from the whole activation
    gradient; it is a partial sum over the batch shards, reduced where the
    gradient takes the table's placements."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    mesh = emb.device_mesh
    emb = shlib.unshard_data(emb)
    out_pl, emb_grad, lo, rows = [], [], 0, emb.shape[0]
    for i, (pe, pt) in enumerate(zip(emb.placements, tokens.placements)):
        if pe == Shard(0):  # the vocab block of this rank
            rows //= mesh.size(i)
            lo += mesh.get_local_rank(i) * rows
            out_pl.append(Partial())
            emb_grad.append(pe)
        else:
            out_pl.append(pt)
            emb_grad.append(Partial() if pt == Shard(0) else pe)
    tl = tokens.to_local().long() - lo
    inside = (tl >= 0) & (tl < rows)
    local = emb.to_local(grad_placements=emb_grad)
    xl = torch.where(inside[..., None], local[tl.clamp(0, rows - 1)],
                     torch.zeros((), dtype=local.dtype, device=local.device))
    x = DTensor.from_local(xl, mesh, out_pl, run_check=False)
    return x.redistribute(mesh, [Replicate() if isinstance(pl, Partial)
                                 else pl for pl in out_pl])


def embed_inputs(params, batch, cfg: ArchConfig):
    """(x, loss_mask) of a batch of ``cfg``'s task (the module docstring
    gives the layouts), in the model dtype.

    vlm: ``gelu(feats w1) w2`` with the tanh GELU (``jax.nn.gelu``'s
    default) for the image rows, then the text embeddings; the loss mask is
    0 on the image rows.  masked_lm: ``feats in_proj``, masked frames
    replaced by ``mask_emb``, plus the sinusoidal positions rounded to the
    model dtype; the loss mask is the frame mask."""
    if cfg.task == "lm":
        x = _embed_tokens(params, batch["tokens"], cfg)
        mask = torch.ones(batch["tokens"].shape, dtype=torch.float32,
                          device=x.device)
    elif cfg.task == "vlm":
        proj = params["projector"]
        img = batch["image_feats"].to(cfg.dtype) @ proj["w1"]
        # Under the pod runtime w2's columns are on "model": the hidden's
        # gradient is summed there, and the image rows are gathered there
        # before they join the text.
        img = shlib.whole_grad(F.gelu(img, approximate="tanh")) @ proj["w2"]
        img = shard_act(img, ("batch", "seq", "embed"))
        txt = _embed_tokens(params, batch["tokens"], cfg)
        x = torch.cat([img, txt], dim=1)
        mask = torch.cat([
            torch.zeros(img.shape[:2], dtype=torch.float32, device=x.device),
            torch.ones(batch["tokens"].shape, dtype=torch.float32,
                       device=x.device)], dim=1)
    elif cfg.task == "masked_lm":
        x = batch["features"].to(cfg.dtype) @ params["in_proj"]
        m = batch["mask"].to(cfg.dtype)[..., None]
        x = x * (1 - m) + lane_scale(params["mask_emb"], x) * m
        pos = sinusoidal_positions(torch.arange(x.shape[1], device=x.device),
                                   cfg.d_model)
        x = x + pos[None].to(cfg.dtype)
        mask = batch["mask"].float()
    else:
        raise ValueError(f"unknown task {cfg.task!r}")
    return shard_act(x, ("batch", "seq", "embed")), mask


def _logits(params, x, cfg: ArchConfig):
    x = rms_norm(x, lane_scale(params["final_norm"], x), cfg.norm_eps)
    head = shlib.unshard_data(params["embed"].transpose(-1, -2)
                       if cfg.tie_embeddings else params["lm_head"])
    return x @ head


# ---------------------------------------------------------------------------
# Layer body + stack.
# ---------------------------------------------------------------------------

def _norm(x, scale, cfg: ArchConfig):
    return rms_norm(x, lane_scale(scale, x), cfg.norm_eps)


def _mlp(pl, x, cfg: ArchConfig, lanes: bool):
    """The layer's MLP on the normed residual -> (y, aux loss or None)."""
    h = _norm(x, pl["ln2"], cfg)
    if cfg.n_experts:
        return moe_lib.moe_forward(pl["mlp"], h, cfg, lanes)
    return moe_lib.swiglu_forward(pl["mlp"], h), None


def _block(pl, x, cfg: ArchConfig, window, theta, positions, lanes: bool,
           return_kv=False):
    """One layer -> (x, the attention's cache entries or None, aux or
    None)."""
    fwd = attn.mla_forward if cfg.attn_type == "mla" else attn.gqa_forward
    h = fwd(pl["attn"], _norm(x, pl["ln1"], cfg), cfg, window=window,
            theta=theta, positions=positions, return_kv=return_kv)
    h, kv = h if return_kv else (h, None)
    x = x + shard_act(h, ("batch", "seq", "embed"))
    y, aux = _mlp(pl, x, cfg, lanes)
    return x + shard_act(y, ("batch", "seq", "embed")), kv, aux


def forward(params, batch, cfg: ArchConfig):
    """Full-sequence forward -> (logits, aux)."""
    lanes = _lanes(params)
    x, mask = embed_inputs(params, batch, cfg)
    b, s = x.shape[:2]
    positions = torch.arange(s, device=x.device).expand(b, s)
    remat = cfg.remat and torch.is_grad_enabled()
    auxs = []
    for i, (win, th) in enumerate(zip(*_layer_meta(cfg))):
        pl = _layer(params["layers"], i, lanes)

        def body(x, pl=pl, win=win, th=th):
            x, _, aux = _block(pl, x, cfg, win, th, positions, lanes)
            return x, aux

        x, aux = (checkpoint(body, x, use_reentrant=False) if remat
                  else body(x))
        auxs.append(aux)
    logits = shard_act(_logits(params, x, cfg), ("batch", "seq", "vocab"))
    # (B,) with lanes: each lane's mean over the layers.
    moe_aux = (torch.stack(auxs).mean(0) if cfg.n_experts
               else torch.zeros((), device=x.device))
    return logits, {"moe_aux": moe_aux, "loss_mask": mask}


def loss(params, batch, cfg: ArchConfig):
    """The task's cross entropy -> (scalar, (ce, acc)), the FL / pod train
    target.  lm and vlm: next-token, the logits at the text positions but
    the last against text tokens 1..St-1 (a vlm's image positions are
    skipped); masked_lm: ``targets`` at the masked frames."""
    logits, aux = forward(params, batch, cfg)
    # Each row's softmax reads every vocab entry: under the pod runtime the
    # logits' vocab shards are gathered first (one all-gather).
    logits = shard_act(logits, ("batch", "seq", None))
    if cfg.task == "masked_lm":
        ce, acc = softmax_xent(logits, batch["targets"], aux["loss_mask"])
    else:
        labels = batch["tokens"]
        n_prefix = logits.shape[1] - labels.shape[1]  # the vlm's image rows
        lg = (logits[:, n_prefix:-1] if labels.shape[1] > 1
              else logits[:, n_prefix:])
        ce, acc = softmax_xent(lg, labels[:, 1:], None)
    total = ce + cfg.router_aux_coef * aux["moe_aux"]
    return total, (ce, acc)


def prefill(params, batch, cfg: ArchConfig, cache_len: int):
    """Full-sequence forward that also fills the KV cache (zero-padded to
    ``cache_len``) -> (logits for every position, cache).  A vlm batch's
    image prefix takes the cache's first positions, so ``cache_len`` must
    count it."""
    lanes = _lanes(params)
    x, _ = embed_inputs(params, batch, cfg)
    b, s = x.shape[:2]
    if s > cache_len:
        raise ValueError(f"prompt length {s} (an image prefix included) "
                         f"exceeds cache_len {cache_len}")
    positions = torch.arange(s, device=x.device).expand(b, s)
    cache = new_cache(cache_defs(cfg, b, cache_len), x, cfg)
    for i, (win, th) in enumerate(zip(*_layer_meta(cfg))):
        x, kv, _ = _block(_layer(params["layers"], i, lanes), x, cfg, win,
                          th, positions, lanes, return_kv=True)
        for name, t in zip(cache, kv):  # ("k", "v") or ("ckv", "kpe")
            attn.write_positions(cache[name][i], t, 0)
    return _logits(params, x, cfg), cache


def new_cache(defs: dict, x, cfg: ArchConfig) -> dict:
    """A zero cache of ``defs`` for the activations ``x``: on their device,
    or under the pod runtime (a DTensor ``x``) placed over its mesh as
    ``launch.sharding.cache_spec`` places a cache, each rank holding its
    own blocks."""
    if shlib.is_dtensor(x):
        return shlib.cache_zeros(defs, x.device_mesh, cfg, x.device)
    return {k: torch.zeros(d.shape, dtype=d.dtype, device=x.device)
            for k, d in defs.items()}


def decode_step(params, cache, tokens, pos: int, cfg: ArchConfig):
    """One-token decode: tokens (B,), cache from :func:`cache_defs` ->
    (logits (B, V), cache).  The cache is updated IN PLACE at ``pos`` and
    returned (the reference returns a new cache).  Under the pod runtime
    (placed params, tokens and cache) each attention reads and writes the
    rank's cache blocks, and each sub-block's output is summed over "model"
    as the forward's is."""
    x = _embed_tokens(params, tokens[:, None], cfg)
    x = shard_act(x, ("batch", None, "embed"))
    lanes = _lanes(params)
    dec = attn.mla_decode if cfg.attn_type == "mla" else attn.gqa_decode
    for i, (win, th) in enumerate(zip(*_layer_meta(cfg))):
        pl = _layer(params["layers"], i, lanes)
        h, _ = dec(pl["attn"], _norm(x, pl["ln1"], cfg),
                   {k: t[i] for k, t in cache.items()}, cfg, pos, window=win,
                   theta=th)
        x = x + shard_act(h, ("batch", None, "embed"))
        y, _ = _mlp(pl, x, cfg, lanes)
        x = x + shard_act(y, ("batch", None, "embed"))
    return _logits(params, x, cfg)[:, 0], cache
