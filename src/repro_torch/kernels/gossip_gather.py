"""Sparse push-sum mix ``Y[i] = sum_l wgt[i,l] X[idx[i,l]]`` over fixed-shape
``(n, k_max)`` receiver-side neighbor lists, f32 accumulation one slot at
a time in slot order, stored in X's dtype.

Replaces the TPU kernel ``repro.kernels.gossip_gather.gossip_gather_pallas``
with the CUDA C++ kernels in ``csrc/gossip_gather.cu``.  What bounds it on
the H100 is bytes (2 k_max flops per k_max elements read): X read once and
Y written once, 0.42 ms at n = 100, D = 1,756,426 in f32.  The panel
kernel gets there by staging each column panel of X (all n rows, C
columns) in shared memory once, through a 3-panel ring that a producer
warp fills with TMA bulk copies, in persistent blocks, and mixing every
receiver row of the panel from there with 16 consumer warps,
so the k_max source rows of a receiver are read from shared memory and
not k_max times through L2.  The bank's rows need not be 16-byte aligned
(D = 1,756,426 is 2 mod 4): ``csrc/panel_ring.cuh`` copies each row's
segment as whole aligned 16-byte chunks and keeps the row's offset within
its chunk.  Where not
even the narrowest panel of n rows fits in shared memory (32 columns in
f32, from n in the mid hundreds up; 16 bytes in bf16), the shape selects
the row kernel: one block per
(receiver row, D chunk), source rows read through L2.  Pad slots carry
weight 0 and add exactly 0; every index must lie in ``[0, n)``, which the
port's neighbor-list builders guarantee by construction.

``gossip_gather`` is the wrapper: a CPU tensor goes to
:func:`gossip_gather_plain`; a CUDA tensor goes to the kernel, or the
wrapper raises; a meta tensor gets an empty output of the kernel's shape.
``launches`` counts kernel launches; every call records its cost
(``repro_torch.roofline.cost.gather_cost``) in a counting ``CostMode``.
The lists may name m receivers over n source rows (``idx`` and ``wgt`` (m,
k_max), ``X`` (n, D), ``Y`` (m, D)): a row-sharded bank's own receivers
over the gathered bank or over its rows and their halo.

The row-sharded bank's two executors (the reference's, over
``torch.distributed`` in place of ``shard_map`` and GSPMD) both end in that
kernel: :func:`gossip_gather_xla` all-gathers the bank and mixes the rank's
receivers over it; :func:`gossip_gather_halo` ships only the rows its
receivers read (the ``CommPlan``) and mixes them over ``[own rows; halo
rows]`` with the slots remapped in place, so that the slot order, and with
it every bit of the result, is the all-gather's.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.build import DTYPE_CODES, check, load_library
from repro_torch.roofline.cost import gather_cost
from repro_torch.roofline.cost import kernel as kernel_cost

__all__ = ["gossip_gather", "gossip_gather_plain", "gossip_gather_xla",
           "gossip_gather_halo", "launches"]

launches = 0


def gossip_gather_plain(idx, wgt, X):
    """The kernel's slot loop in plain PyTorch (same f32 accumulation order:
    ``acc = w_0 x_0``, then ``acc += w_l x_l``)."""
    idx = idx.long()
    wgt = wgt.float()
    acc = wgt[:, 0, None] * X[idx[:, 0]].float()
    for slot in range(1, idx.shape[1]):
        acc = acc + wgt[:, slot, None] * X[idx[:, slot]].float()
    return acc.to(X.dtype)


def gossip_gather(idx, wgt, X):
    global launches
    dev = X.device.type
    if dev not in ("cpu", "cuda", "meta"):
        raise ValueError(f"no gossip_gather kernel for device {X.device}")
    with kernel_cost("gossip_gather", lambda: gather_cost(
            idx.shape[0], X.shape[0], idx.shape[1], X.shape[1],
            X.element_size())):
        if dev == "cpu":
            return gossip_gather_plain(idx, wgt, X)
        if X.dim() != 2 or X.dtype not in DTYPE_CODES:
            raise ValueError(
                f"X must be a float32/bfloat16 (n, D) bank, got {X.dtype} "
                f"{tuple(X.shape)}"
            )
        n, d = X.shape
        if idx.dim() != 2 or idx.shape[0] < 1 or idx.shape[1] < 1:
            raise ValueError(
                f"idx must be (m >= 1, k_max >= 1), got {tuple(idx.shape)}"
            )
        if idx.dtype != torch.int32:
            raise TypeError(f"idx must be int32, got {idx.dtype}")
        if wgt.shape != idx.shape or wgt.dtype != torch.float32:
            raise ValueError("wgt must be float32 with idx's shape")
        for name, t in (("idx", idx), ("wgt", wgt), ("X", X)):
            if t.device != X.device:
                raise ValueError(f"{name} is on {t.device}, X on {X.device}")
            if not t.is_contiguous():
                raise ValueError(f"{name} must be contiguous")
        m, k_max = idx.shape
        Y = X.new_empty((m, d))
        if dev == "meta":  # the output's shape, no computation
            return Y
        lib = load_library()
        stream = torch.cuda.current_stream(X.device).cuda_stream
        with torch.cuda.device(X.device):
            rc = lib.gossip_gather_launch(
                DTYPE_CODES[X.dtype], idx.data_ptr(), wgt.data_ptr(),
                X.data_ptr(), Y.data_ptr(), m, n, k_max, d, stream)
        check(rc, "gossip_gather")
        launches += 1
        return Y


def gossip_gather_xla(idx, wgt, X, shard=None):
    """The all-gather executor: every rank gathers the whole bank and mixes
    its own receivers over it (``idx`` / ``wgt`` the whole round's lists,
    ``X`` the rank's rows).  Without ``shard`` it is the kernel on the bank
    at hand (the reference's ``"xla"`` on one device: the same mix, no
    collective)."""
    if shard is None:
        return gossip_gather(idx, wgt, X)
    return gossip_gather(shard.rows(idx), shard.rows(wgt), shard.all_gather(X))


def _static_halo(X, shard, plan):
    """One point-to-point leg per ``ShiftLeg``: rank p sends its rows at the
    leg's offsets to rank p + delta and receives rank p - delta's.  Returns
    the halo rows and where each (source rank, source offset) landed."""
    import torch.distributed as dist

    s, m, me = plan.n_shards, plan.m, shard.rank
    pos = torch.zeros((s, m), dtype=torch.long, device=X.device)
    ops, bufs, base = [], [], 0
    for leg in plan.legs:
        offs = torch.tensor(leg.offsets, dtype=torch.long, device=X.device)
        send = X[offs].contiguous()
        recv = torch.empty_like(send)
        ops.append(dist.P2POp(dist.isend, send, dist.get_global_rank(
            shard.group, (me + leg.delta) % s), shard.group))
        ops.append(dist.P2POp(dist.irecv, recv, dist.get_global_rank(
            shard.group, (me - leg.delta) % s), shard.group))
        bufs.append(recv)
        # The rows just received came from rank me - delta.
        pos[(me - leg.delta) % s, offs] = base + torch.arange(
            len(leg.offsets), device=X.device)
        base += len(leg.offsets)
    for req in (dist.batch_isend_irecv(ops) if ops else ()):
        req.wait()
    halo = torch.cat(bufs) if bufs else X.new_zeros((1, X.shape[1]))
    return halo, pos


def _dynamic_halo(X, src, off, remote, shard, plan):
    """The fixed-capacity request/response pair: each rank lists, per source
    rank, the offsets its receivers read there (ascending, padded with the
    fill value m to the plan's capacity), ships the lists with one
    ``all_to_all_single``, serves the rows asked of it and ships them back
    with a second.  A zero-weight slot (a dropped, churned or delayed-away
    edge) asks for nothing."""
    import torch.distributed as dist

    s, m, H = plan.n_shards, plan.m, plan.capacity
    dev = X.device
    need = torch.zeros((s, m), dtype=torch.bool, device=dev)
    need[src[remote], off[remote]] = True
    # Row p: the offsets needed from rank p first, in ascending order.
    order = torch.argsort((~need).to(torch.int8), dim=1, stable=True)[:, :H]
    count = need.sum(dim=1, keepdim=True)
    slot = torch.arange(H, device=dev)[None, :]
    req = torch.where(slot < count, order, torch.full_like(order, m))
    req_in = torch.empty_like(req)
    dist.all_to_all_single(req_in, req.contiguous(), group=shard.group)
    payload = X[req_in.clamp(0, m - 1).reshape(-1)].reshape(
        (s, H) + tuple(X.shape[1:]))
    halo = torch.empty_like(payload)
    dist.all_to_all_single(halo, payload, group=shard.group)
    # Fill values land in the throwaway column m; real offsets get their
    # flat halo row.
    pos = torch.zeros((s, m + 1), dtype=torch.long, device=dev)
    pos[torch.arange(s, device=dev)[:, None], req] = torch.arange(
        s * H, device=dev).reshape(s, H)
    return halo.reshape((s * H,) + tuple(X.shape[1:])), pos[:, :m]


def gossip_gather_halo(idx, wgt, X, *, shard, plan):
    """The halo executor: the same mix as :func:`gossip_gather_xla`,
    shipping only the remote rows the rank's receivers read.  Static plans
    (ring, exponential) run :func:`_static_halo`, dynamic ones (sampled
    families) :func:`_dynamic_halo`; then the gather kernel runs over
    ``[own rows; halo rows]`` with each slot pointing at its row there.  A
    zero-weight slot whose row was not shipped points at halo row 0 and adds
    exactly 0, as it would from its own row.  With one shard it runs the
    all-gather form, as the reference does."""
    s, m = plan.n_shards, plan.m
    if s == 1 or shard is None:
        return gossip_gather_xla(idx, wgt, X, shard)
    idx_s = shard.rows(idx).long()
    wgt_s = shard.rows(wgt)
    src, off = idx_s // m, idx_s % m
    local = src == shard.rank
    if plan.static:
        halo, pos = _static_halo(X, shard, plan)
    else:
        halo, pos = _dynamic_halo(X, src, off, (wgt_s != 0.0) & ~local,
                                  shard, plan)
    slots = torch.where(local, off, m + pos[src, off]).to(torch.int32)
    return gossip_gather(slots.contiguous(), wgt_s.contiguous(),
                         torch.cat([X, halo.to(X.dtype)]))
