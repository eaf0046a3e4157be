"""The decoders' MLPs — the port of ``repro.models.moe``: the dense
SwiGLU MLP and the mixture of experts.

The MoE covers DBRX (softmax top-4 of 16) and DeepSeek-V3 (sigmoid gating
with normalized top-8 of 256 + 1 shared expert); the aux load-balance loss
follows Switch/GShard: E * sum_e(frac_tokens_e * mean_prob_e).

``_moe_gshard`` keeps the reference's capacity dispatch — its function, not
its formulation.  The reference builds one-hot ``(B, S, E, C)`` dispatch
and combine tensors and contracts them with einsums, which at
deepseek-v3's shape spends a third of the expert FLOPs selecting rows.
Here each kept assignment's token row is scattered into its slot of an
``(E, B, C, d)`` buffer (:func:`_dispatch`), every expert runs ``bmm`` over
its ``B * C`` slots (:func:`_expert_products`), and each token gathers its
``k`` slots back with their combine weights (:func:`_combine`).  The
positions, the capacity, the kept set and the rounding of the combine
weights are the reference's.

With lane-stacked weights (a leading lane axis, one lane per batch row,
``lanes=True``; see ``models.transformer``), each row routes through its
own lane's router and experts: the slots are laid out ``(B, E, C)``
instead, so that lane b's ``(E, C, d)`` block runs through
:func:`_expert_products` against lane b's ``(E, d, f)`` experts, a
contiguous block of the ``(B, L, E, d, f)`` leaf (``B`` calls and no copy
of the weights), and the aux loss is per lane, ``(B,)``.  Capacity and
positions are per batch row as without lanes, which under the reference's
vmap with an inner batch of 1 is per lane.

Under the pod runtime (DTensor activations, ``launch.sharding``) the
experts sit on the "model" axis and the tokens are replicated there (the
batch rows are on "data"): each rank routes its whole local token set,
fills only its own experts' slots, runs its experts and combines their
outputs in a manual region (:func:`_moe_placed`); the combine is then a
partial sum over the experts, summed over "model" by one all-reduce — what
the reference's combine einsum over an expert dim sharded on "model"
amounts to.  The aux loss is the mean over every data shard's rows.  The
reference's constraints on its one-hot ``(B, S, E, C)`` dispatch and
combine tensors have no counterpart here (the slot arrays carry them);
those on its expert buffers stand on :func:`_moe_gshard`'s ``(E, B, C,
d)`` buffers, where, in the manual region, they are the identity.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.launch import sharding as shlib
from repro_torch.models.layers import shard_act
from repro_torch.models.pdefs import PDef

__all__ = ["moe_defs", "moe_forward", "swiglu_defs", "swiglu_forward",
           "moe_capacity", "moe_positions"]


def swiglu_defs(cfg: ArchConfig, stacked: tuple = (), d_ff: int = 0) -> dict:
    d, f = cfg.d_model, d_ff or cfg.d_ff
    L, Lax = (stacked, ("layers",) * len(stacked)) if stacked else ((), ())
    dt = cfg.dtype
    defs = {
        "wi": PDef(L + (d, f), Lax + ("embed", "mlp"), dt, fan_in=d),
        "wo": PDef(L + (f, d), Lax + ("mlp", "embed"), dt, fan_in=f),
    }
    if cfg.mlp_act == "swiglu":
        defs["wg"] = PDef(L + (d, f), Lax + ("embed", "mlp"), dt, fan_in=d)
    return defs


def swiglu_forward(p, x):
    """``(act(x wi) * (x wg)) wo`` with act = silu (gelu without ``wg``)."""
    if "wg" in p:
        h = F.silu(x @ p["wi"]) * (x @ p["wg"])
    else:
        h = F.gelu(x @ p["wi"], approximate="tanh")
    h = shard_act(h, ("batch", "seq", "mlp"))
    return h @ p["wo"]


def moe_defs(cfg: ArchConfig, stacked: tuple = ()) -> dict:
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    L, Lax = (stacked, ("layers",) * len(stacked)) if stacked else ((), ())
    dt = cfg.dtype
    defs = {
        "router": PDef(L + (d, e), Lax + ("embed", None), torch.float32, fan_in=d),
        "wi": PDef(L + (e, d, f), Lax + ("expert", "embed", "mlp"), dt, fan_in=d),
        "wg": PDef(L + (e, d, f), Lax + ("expert", "embed", "mlp"), dt, fan_in=d),
        "wo": PDef(L + (e, f, d), Lax + ("expert", "mlp", "embed"), dt, fan_in=f),
    }
    if cfg.n_shared_experts:
        fs = f * cfg.n_shared_experts
        defs["shared"] = swiglu_defs(cfg, stacked, d_ff=fs)
    return defs


def _router_probs(p, x, cfg: ArchConfig):
    """Returns (weights (B,S,k) f32, sel (B,S,k) int64, probs (B,S,E) f32):
    sigmoid gating for deepseek (a shared expert), softmax over the experts
    for dbrx; both take the top k and renormalize them."""
    logits = x.float() @ p["router"]
    probs = torch.sigmoid(logits) if cfg.n_shared_experts else logits.softmax(-1)
    w, sel = torch.topk(probs, cfg.top_k, dim=-1)
    w = w / (w.sum(-1, keepdim=True) + 1e-9)
    return w, sel, probs


def _one_hot(sel, e: int):
    """``F.one_hot(sel, e)`` as floats, by one comparison with ``arange(e)``:
    the same operators on every device (``F.one_hot`` checks its range with a
    host read and scatters on the CPU, scatters on CUDA and compares on
    meta), so a meta trace counts what the card runs."""
    return (sel[..., None] == torch.arange(e, device=sel.device)).float()


def _aux_loss(sel, probs, cfg: ArchConfig, lanes: bool = False):
    """E * sum_e(frac_e * imp_e): frac counts every assignment, dropped or
    not; imp is the mean router probability.  With lanes, one per batch
    row, ``(B,)``."""
    e = cfg.n_experts
    if lanes:
        frac = _one_hot(sel, e).mean((1, 2))
        return e * (frac * probs.mean(1)).sum(-1)
    frac = _one_hot(sel, e).mean((0, 1, 2))
    imp = probs.mean((0, 1))
    return e * (frac * imp).sum()


def _moe_dense(p, x, w, sel, cfg: ArchConfig, lanes: bool = False,
               e_lo: int = 0):
    """Exact reference: every expert on every token, mask-combined; the
    experts of ``p`` are experts ``e_lo ..`` of the router's."""
    e = cfg.n_experts
    gates = (_one_hot(sel, e) * w[..., None]).sum(2)  # (B,S,E)
    gates = gates[..., e_lo:e_lo + p["wi"].shape[-3]]
    ln = "b" if lanes else ""
    h = torch.einsum(f"bsd,{ln}edf->bsef", x, p["wi"])
    g = torch.einsum(f"bsd,{ln}edf->bsef", x, p["wg"])
    h = F.silu(h) * g
    out = torch.einsum(f"bsef,{ln}efd->bsed", h, p["wo"])
    return torch.einsum("bsed,bse->bsd", out.float(), gates).to(x.dtype)


def _positions_cumsum(sel, b, s, k, e):
    """Each assignment's position within its expert, counted within its
    batch row in (s, k) arrival order: a cumsum of the one-hot assignments
    over the S*k arrivals (O(T*E) memory).  The one-hot is laid out (B, E,
    S*k), so that the scan runs along the contiguous axis (the reference's
    (B, S*k, E) layout scans across rows: 1.5 ms a dbrx layer on an H100)."""
    flat_e = sel.reshape(b, 1, s * k)
    oh = flat_e == torch.arange(e, device=sel.device)[None, :, None]
    count = torch.cumsum(oh, -1, dtype=torch.int32)  # inclusive, (B,E,T)
    pos = torch.gather(count, 1, flat_e)[:, 0] - 1
    return pos.reshape(b, s, k)


def _positions_sort(sel, b, s, k, e):
    """The same positions in O(T) memory: a stable argsort groups each row's
    assignments by expert in arrival order, so the rank within a group is
    the position."""
    t = s * k
    flat_e = sel.reshape(b, t)
    counts = torch.zeros((b, e), dtype=torch.int64, device=sel.device)
    counts.scatter_add_(1, flat_e, torch.ones_like(flat_e))
    starts = torch.cumsum(counts, 1) - counts  # exclusive, (B,E)
    order = torch.argsort(flat_e, dim=1, stable=True)
    sorted_e = torch.gather(flat_e, 1, order)
    pos_sorted = (torch.arange(t, device=sel.device)[None, :]
                  - torch.gather(starts, 1, sorted_e))
    pos = torch.empty_like(flat_e).scatter_(1, order, pos_sorted)
    return pos.reshape(b, s, k).to(torch.int32)


def moe_capacity(s: int, cfg: ArchConfig) -> int:
    """Slots per expert and batch row for a sequence of ``s`` tokens."""
    return max(int(s * cfg.top_k / cfg.n_experts * cfg.capacity_factor),
               cfg.top_k)


def moe_positions(sel, cfg: ArchConfig):
    """(position within expert (B,S,k) int32, kept (B,S,k) bool) of each
    assignment: the reference's rule (``cfg.moe_pos``), capacity per batch
    row."""
    b, s, k = sel.shape
    pos_fn = _positions_sort if cfg.moe_pos == "sort" else _positions_cumsum
    pos = pos_fn(sel, b, s, k, cfg.n_experts)
    return pos, pos < moe_capacity(s, cfg)


def _dispatch(x, slot, keep, n_slots: int):
    """(n_slots, d) buffer holding each kept assignment's token row at its
    slot, zeros elsewhere.  Dropped assignments go to one extra row, cut
    off before the buffer is returned."""
    b, s, k = slot.shape
    buf = x.new_zeros((n_slots + 1, x.shape[-1]))
    idx = torch.where(keep, slot, n_slots)
    buf.index_put_((idx,), x[:, :, None, :].expand(b, s, k, x.shape[-1]))
    return buf[:n_slots]


def _expert_products(p, xin):
    """``(silu(xin wi) * (xin wg)) wo`` for every expert: xin (E, M, d) ->
    (E, M, d), one ``bmm`` a product."""
    h = F.silu(torch.bmm(xin, p["wi"])) * torch.bmm(xin, p["wg"])
    return torch.bmm(h, p["wo"])


def _combine(out, slot, keep, w, ddt, dtype):
    """Each token's sum over its k slots of the combine weight times the
    expert's output row: a (1, k) x (k, d) matmul a token, accumulated in
    f32 and rounded to ``dtype`` once.  The weight is the reference's
    combine entry: w rounded to the dispatch dtype, zero where the
    assignment was dropped, then rounded to ``dtype``."""
    b, s, k = slot.shape
    cw = torch.where(keep, w.to(ddt), 0).to(dtype)
    rows = out[torch.where(keep, slot, 0)]  # (B,S,k,d)
    y = torch.bmm(cw.view(b * s, 1, k), rows.view(b * s, k, -1))
    return y.view(b, s, -1)


def _moe_gshard(p, x, w, sel, cfg: ArchConfig, lanes: bool = False,
                e_lo: int = 0):
    """Capacity-based dispatch and combine (see the module docstring).
    Without lanes the experts of ``p`` may be a block of the router's,
    experts ``e_lo ..``: only the assignments to them are dispatched and
    combined (a rank's partial sum under the pod runtime)."""
    b, s, d = x.shape
    e = cfg.n_experts
    capacity = moe_capacity(s, cfg)
    pos, keep = moe_positions(sel, cfg)
    rows = torch.arange(b, device=x.device)[:, None, None]
    ddt = torch.bfloat16 if cfg.moe_dispatch_dtype == "bf16" else torch.float32
    if lanes:
        # Slot (b, e, c) of the (B, E, C) buffer: lane b's experts.
        slot = (rows * e + sel) * capacity + pos
        xin = _dispatch(x, slot, keep, e * b * capacity).view(b, e, capacity,
                                                              d)
        out = torch.stack([
            _expert_products({k: p[k][i] for k in ("wi", "wg", "wo")},
                             xin[i]) for i in range(b)])
    else:
        # Slot (e, b, c) of the (E, B, C) buffer, in row-major order, for
        # the experts at hand.
        e = p["wi"].shape[0]
        keep = keep & (sel >= e_lo) & (sel < e_lo + e)
        slot = ((sel - e_lo) * b + rows) * capacity + pos
        xin = shard_act(_dispatch(x, slot, keep, e * b * capacity).view(
            e, b, capacity, d), ("expert", "batch", None, None))
        out = _expert_products(p, xin.view(e, b * capacity, d))
        out = shard_act(out.view(e, b, capacity, d),
                        ("expert", "batch", None, None))
    return _combine(out.view(e * b * capacity, d), slot, keep, w, ddt, x.dtype)


def _placed_aux(terms, x, cfg: ArchConfig):
    """:func:`_aux_loss` of the whole batch from ``terms``, a rank's
    ``(2, E)`` fractions and mean probabilities over its rows: their mean
    over the mesh dims where DTensor ``x`` splits the batch (one all-reduce
    of the ``2 x E`` means each; equal rows a shard) -> a replicated 0-d
    DTensor."""
    from torch.distributed.tensor import DTensor, Partial, Replicate

    mesh = x.device_mesh
    split = [i for i, pl in enumerate(x.placements)
             if pl.is_shard() and mesh.size(i) > 1]
    n = 1
    for i in split:
        n *= mesh.size(i)
    t = DTensor.from_local(terms / n, mesh, [
        Partial() if i in split else Replicate() for i in range(mesh.ndim)],
        run_check=False)
    t = t.redistribute(mesh, [Replicate()] * mesh.ndim)
    return cfg.n_experts * (t[0] * t[1]).sum()


def _moe_placed(p, x, cfg: ArchConfig):
    """:func:`moe_forward` of DTensor ``x`` (batch rows on "data",
    replicated on "model") with the experts placed by ``spec_for``: the
    routing, the dispatch to this rank's experts, their products, the
    combine and the shared expert (:func:`swiglu_forward` on the rank's
    ``"mlp"`` columns) in a manual region on the local tokens and weights,
    the output a partial sum over "model".  A part whose leaves "model"
    does not split counts on the axis's rank 0 only; where it splits
    neither, every rank computes the whole output, whose gradient then
    counts once."""
    from torch.distributed.tensor import Partial

    mesh = x.device_mesh
    rank, m = shlib.model_block(mesh)

    def split(leaf):
        return m > 1 and leaf.placements[
            mesh.mesh_dim_names.index("model")].is_shard()

    xl = shlib.local_part(x, x)
    local = {k: shlib.local_part(p[k], x) for k in ("router", "wi", "wg",
                                                     "wo")}
    e_n = local["wi"].shape[0]
    e_lo = rank * e_n if e_n < cfg.n_experts else 0
    with shlib.manual_region(mesh):
        w, sel, probs = _router_probs(local, xl, cfg)
        impl = _moe_dense if cfg.moe_impl == "dense" else _moe_gshard
        parts = [(impl(local, xl, w, sel, cfg, e_lo=e_lo), split(p["wi"]))]
        if cfg.n_shared_experts:
            shared = {k: shlib.local_part(v, x)
                      for k, v in p["shared"].items()}
            parts.append((swiglu_forward(shared, xl),
                          split(p["shared"]["wi"])))
        partial = any(sp for _, sp in parts)
        y = None
        for part, sp in parts:
            if not partial:
                part = shlib.shared_grad(part, m)
            elif not sp and rank:
                part = torch.zeros_like(part)
            y = part if y is None else y + part
        terms = torch.stack([_one_hot(sel, cfg.n_experts).mean((0, 1, 2)),
                             shlib.shared_grad(probs.mean((0, 1)), m)])
    y = shlib.from_local(y, x, Partial() if partial else None)
    return y, _placed_aux(terms, x, cfg)


def moe_forward(p, x, cfg: ArchConfig, lanes: bool = False):
    """Returns (y, aux_loss); with ``lanes`` (lane-stacked weights) the aux
    loss is per lane."""
    if shlib.is_dtensor(x):
        return _moe_placed(p, x, cfg)
    w, sel, probs = _router_probs(p, x, cfg)
    impl = _moe_dense if cfg.moe_impl == "dense" else _moe_gshard
    y = impl(p, x, w, sel, cfg, lanes)
    if cfg.n_shared_experts:
        y = y + swiglu_forward(p["shared"], x)
    return y, _aux_loss(sel, probs, cfg, lanes)
