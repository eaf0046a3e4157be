"""One rank of the pod runtime's CPU world (``test_torch_pod_runtime.py``):
8 ranks over gloo at ``tcp://localhost:PORT``, the reference's ``(2, 2,
2)`` ``("pod", "data", "model")`` host mesh, reduced glm4-9b, 2 pods, K =
2 local steps, 2 rounds.

    python tests/_torch_pod_world.py --rank R --port P --port2 P2 \
        --out DIR --reference FILE

``FILE`` holds the reference's initial pod-stacked params and its token
batches (a pickle of numpy arrays, which ``test_torch_pod_runtime.py``
records with the JAX reference: the world itself imports no JAX).  Every
rank places its pod's replica over its (data, model) submesh
(``launch.steps.place_pods``) and runs the rounds under ``gossip`` "auto",
"xla" and "halo"; the state is gathered whole after each run.  Rank 0 also
runs the mesh-less port round (every pod stacked on its one device) from
the same state, and writes what it measured to ``DIR/results.json`` and
the gathered states to ``DIR/states.pkl``:

* ``shards``: every rank's local shard shape of each placed leaf;
* ``runs``: each gossip mode's params, w, loss, accuracy and mass against
  the mesh-less round, and halo against xla; ``fsdp``: "xla" with FSDP on
  (the weights' embed dims on "data" too);
* ``collectives``: the bytes and counts of each collective kind that one
  rank moves in the first "xla" round, counted by a dispatch mode around
  the round (:class:`CountingMode`, this script's, not the package's);
  ``collectives_fsdp`` the same with FSDP on;
* ``norm``: ``core.sam.global_norm`` of the placed replica against the
  whole one;
* ``kv_replicated``: ``models.attention.gqa_forward`` with 1 kv head on
  the 2-wide model axis (k and v replicated, each rank's query heads
  reading kv head 0) and its gradient, against the plain forward;
* ``xlstm``: after the 8-rank world closes, ranks 0 and 1 start a 2-rank
  world on ``P2``: reduced xlstm-350m on a pod-only ``(2, 1, 1)`` mesh,
  "halo" against "xla".

Torch runs one intra-op thread.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import pickle
import sys
import time

import torch
from torch.utils._python_dispatch import TorchDispatchMode

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(os.path.dirname(HERE), "src"))

from repro_torch.interop import params_from_numpy  # noqa: E402

WORLD = 8
MESH = ((2, 2, 2), ("pod", "data", "model"))
ARCH = "glm4-9b"
N_PODS, K, B, S, ROUNDS = 2, 2, 4, 16, 2
STEP = dict(lr=0.05, alpha=0.9, rho=0.05, local_steps=K)
MODES = ("auto", "xla", "halo")


class CountingMode(TorchDispatchMode):
    """Counts the collectives this rank issues: each ``_c10d_functional``
    op (DTensor's redistributions) and ``c10d`` op (the process-group
    calls of the gossip), by kind, with the bytes of its output on this
    rank (the gathered block of an all-gather, the kept shard of a
    reduce-scatter, the operand of an all-reduce, a sent block)."""

    KINDS = {"all_gather_into_tensor": "all-gather", "allgather_": "all-gather",
             "_allgather_base_": "all-gather",
             "allgather_into_tensor_coalesced_": "all-gather",
             "reduce_scatter_tensor": "reduce-scatter",
             "_reduce_scatter_base_": "reduce-scatter",
             "all_reduce": "all-reduce", "allreduce_": "all-reduce",
             "all_to_all_single": "all-to-all", "alltoall_base_": "all-to-all",
             "send": "collective-permute"}

    def __init__(self):
        super().__init__()
        self.bytes, self.count, self.ops = {}, {}, {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        kwargs = kwargs or {}
        if any(t is DTensor for t in types):
            return NotImplemented  # let DTensor lower into collectives first
        out = func(*args, **kwargs)
        ns = func.namespace
        if ns in ("_c10d_functional", "c10d"):
            name = func._opname
            self.ops[name] = self.ops.get(name, 0) + 1
            kind = self.KINDS.get(name)
            if kind is not None:
                self._add(kind, self._bytes(name, args, out))
        return out

    @staticmethod
    def _bytes(name, args, out):
        def size(t):
            if isinstance(t, torch.Tensor):
                return t.numel() * t.element_size()
            if isinstance(t, (list, tuple)):
                return sum(size(x) for x in t)
            return 0

        if name == "alltoall_base_":  # (output, input): the operand
            return size(args[1])
        if name in ("allreduce_", "send", "allgather_", "_allgather_base_",
                    "_reduce_scatter_base_"):  # the operand or the output
            return size(args[0])
        return size(out)

    def _add(self, kind, n):
        self.bytes[kind] = self.bytes.get(kind, 0) + n
        self.count[kind] = self.count.get(kind, 0) + 1


def _walk(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _walk(tree[k], prefix + (k,))
    else:
        yield prefix, tree


def _rel(a, b) -> float:
    """max |a - b| over max |b| (0 for an all-zero b equal to a)."""
    a, b = a.detach().double(), b.detach().double()
    scale = float(b.abs().max())
    err = float((a - b).abs().max())
    return err / scale if scale else err


def _run(api, step_cfg, whole, toks, gossip, mesh=None, count=False):
    """ROUNDS rounds from the whole pod-stacked ``whole``; with ``mesh`` the
    pod runtime (this rank's pods placed), else mesh-less.  Returns the
    whole state after the rounds, each round's metrics and, with
    ``count``, the first round's collectives."""
    from repro_torch.core.flat import tree_map
    from repro_torch.launch import sharding as shlib
    from repro_torch.launch import steps

    step = steps.make_round_step(api, step_cfg, gossip=gossip)
    P = steps.pod_mixing_neighbors(N_PODS)
    whole = tree_map(torch.clone, whole)
    w = torch.ones((N_PODS,))
    if mesh is None:
        params, v = whole, tree_map(torch.zeros_like, whole)
        rows = None
    else:
        rows = steps.pod_rows(mesh, N_PODS)
        params = steps.place_pods(api, whole, mesh)
        v = tree_map(torch.zeros_like, params)
        w = rows.rows(w)
    metrics, counted = [], None
    on_mesh = (shlib.use_mesh(mesh) if mesh is not None
               else contextlib.nullcontext())
    with on_mesh:
        for r in range(ROUNDS):
            tk = toks[r] if rows is None else rows.rows(toks[r])
            mode = CountingMode() if count and r == 0 else None
            with mode if mode is not None else contextlib.nullcontext():
                params, v, w, _, _, m = step(params, v, w, (), (),
                                             {"tokens": tk}, P)
            if mode is not None:
                counted = {"bytes": mode.bytes, "count": mode.count,
                           "ops": mode.ops}
            metrics.append({"loss": float(m["loss"]), "acc": float(m["acc"])})
    if mesh is not None:
        params = steps.gather_pods(params, mesh, N_PODS)
        v = steps.gather_pods(v, mesh, N_PODS)
        w = rows.all_gather(w)
    return {"params": params, "v": v, "w": w, "metrics": metrics,
            "collectives": counted}


def case_glm(mesh, rank, reference):
    from repro_torch.configs.registry import get_config
    from repro_torch.core.flat import tree_flatten
    from repro_torch.launch import steps
    from repro_torch.models.registry import get_model_api

    with open(reference, "rb") as f:
        ref = pickle.load(f)
    api = get_model_api(get_config(ARCH, smoke=True))
    step_cfg = steps.StepConfig(**STEP)
    whole = params_from_numpy(ref["params"])
    toks = torch.as_tensor(ref["tokens"])
    placed = steps.place_pods(api, whole, mesh)
    shards = {"/".join(p): list(x.to_local().shape) for p, x in _walk(placed)}
    out = {"shards": shards, "runs": {}}
    runs = {}
    for gossip in MODES:
        t0 = time.time()
        runs[gossip] = _run(api, step_cfg, whole, toks, gossip, mesh,
                            count=gossip != "auto")
        out["runs"][gossip] = {"seconds": time.time() - t0}
    out["collectives"] = runs["xla"]["collectives"]
    out["collectives_halo"] = runs["halo"]["collectives"]
    # FSDP on: the weights' embed dims on "data" too.
    fsdp_api = get_model_api(dataclasses.replace(api.cfg, fsdp=True))
    t0 = time.time()
    runs["fsdp"] = _run(fsdp_api, step_cfg, whole, toks, "xla", mesh,
                        count=True)
    out["runs"]["fsdp"] = {"seconds": time.time() - t0}
    out["collectives_fsdp"] = runs["fsdp"]["collectives"]
    if rank == 0:
        base = _run(api, step_cfg, whole, toks, "auto")
        for gossip, run in runs.items():
            rec = out["runs"][gossip]
            rec["params"] = max(_rel(a, b) for a, b in zip(
                tree_flatten(run["params"])[1], tree_flatten(base["params"])[1]))
            rec["v"] = max(_rel(a, b) for a, b in zip(
                tree_flatten(run["v"])[1], tree_flatten(base["v"])[1]))
            rec["w"] = float((run["w"] - base["w"]).abs().max())
            rec["loss"] = max(abs(a["loss"] - b["loss"]) / abs(b["loss"])
                              for a, b in zip(run["metrics"], base["metrics"]))
            rec["acc"] = max(abs(a["acc"] - b["acc"]) for a, b in
                             zip(run["metrics"], base["metrics"]))
            rec["mass"] = float(run["w"].sum())
        out["halo_vs_xla_equal"] = all(
            torch.equal(a, b) for a, b in zip(
                tree_flatten(runs["halo"]["params"])[1],
                tree_flatten(runs["xla"]["params"])[1])) and torch.equal(
            runs["halo"]["w"], runs["xla"]["w"])
        out["states"] = {g: {"params": {"/".join(p): x.numpy()
                                        for p, x in _walk(r["params"])},
                             "w": r["w"].numpy(), "metrics": r["metrics"]}
                         for g, r in runs.items() if g in MODES}
    return out


def case_norm(mesh, reference):
    """``global_norm`` of this rank's placed pods against the whole ones,
    and the norm of the rank's shards alone (what a local norm would
    give)."""
    from repro_torch.configs.registry import get_config
    from repro_torch.core.flat import tree_flatten, tree_map
    from repro_torch.core.sam import global_norm
    from repro_torch.launch import steps
    from repro_torch.models.registry import get_model_api

    with open(reference, "rb") as f:
        ref = pickle.load(f)
    api = get_model_api(get_config(ARCH, smoke=True))
    whole = params_from_numpy(ref["params"])
    placed = steps.place_pods(api, whole, mesh)
    rows = steps.pod_rows(mesh, N_PODS)
    local = torch.sqrt(sum(torch.sum(torch.square(x.to_local().float()))
                           for x in tree_flatten(placed)[1]))
    return {"placed": float(global_norm(placed)),
            "whole": float(global_norm(tree_map(rows.rows, whole))),
            "local": float(local)}


def case_kv_replicated(mesh):
    """``gqa_forward`` on the (data, model) submesh with kv heads that do
    not divide by the 2-wide model axis — 1 kv head under 4 query heads
    (each rank's 2 query heads share kv head 0) and 3 under 6 (rank r's 3
    query heads read one kv head each, ``h // 2``) — forward and gradient
    against the plain forward on the whole tensors."""
    import dataclasses

    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.configs.registry import get_config
    from repro_torch.core.flat import tree_flatten, tree_unflatten
    from repro_torch.launch import sharding as shlib
    from repro_torch.models import attention
    from repro_torch.models.pdefs import init_tree

    out = {}
    sub = shlib.submesh(mesh)
    for heads, kv in ((4, 1), (6, 3)):
        cfg = dataclasses.replace(get_config(ARCH, smoke=True),
                                  n_heads=heads, n_kv_heads=kv, head_dim=64)
        defs = attention.gqa_defs(cfg)
        gen = torch.Generator().manual_seed(heads)
        p = init_tree(gen, defs, "cpu")
        x = torch.randn((B, S, cfg.d_model), generator=gen)
        r = torch.randn((B, S, cfg.d_model), generator=gen)
        pos = torch.arange(S).expand(B, S)

        def run(p, x, r):
            paths, leaves = tree_flatten(p)
            leaves = [t.detach().requires_grad_(True) for t in leaves]
            with torch.enable_grad():
                y = attention.gqa_forward(tree_unflatten(paths, leaves), x,
                                          cfg, theta=cfg.rope_theta,
                                          positions=pos)
                loss = (y * r).sum()
                g = torch.autograd.grad(loss, leaves)
            return y, g

        y0, g0 = run(p, x, r)
        placed = shlib.place_params(p, defs, mesh, fsdp=False)
        pl = [Shard(0) if n == "data" else Replicate()
              for n in sub.mesh_dim_names]
        with shlib.use_mesh(mesh), implicit_replication():
            y1, g1 = run(placed, shlib.place_tensor(x, sub, pl),
                         shlib.place_tensor(r, sub, pl))
        out[f"{heads}q-{kv}kv"] = {
            "y": _rel(y1.full_tensor(), y0),
            "grads": max(_rel(a.full_tensor(), b) for a, b in zip(g1, g0)),
            "wk_placements": str(placed["wk"].placements)}
    return out


def case_xlstm(rank, port):
    """Reduced xlstm-350m on a pod-only (2, 1, 1) mesh of 2 ranks: each
    rank's replica whole (DTensors over a one-device submesh), "halo"
    against "xla" over 2 rounds."""
    from repro_torch.configs.registry import get_config
    from repro_torch.core.flat import tree_flatten, tree_map
    from repro_torch.data.synthetic import make_lm_stream
    from repro_torch.launch import sharding as shlib
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import close_clients_world, init_world
    from repro_torch.models.registry import get_model_api

    mesh = init_world(rank, 2, port, "cpu", (2, 1, 1), MESH[1])
    try:
        api = get_model_api(get_config("xlstm-350m", smoke=True))
        p = api.init(torch.Generator().manual_seed(0), "cpu")
        whole = tree_map(lambda x: torch.stack([x, 0.5 * x]), p)
        toks = make_lm_stream(api.cfg.vocab_size, S,
                              ROUNDS * N_PODS * 1 * B).reshape(
            ROUNDS, N_PODS, 1, B, S)
        cfg = steps.StepConfig(lr=0.05, rho=0.0, local_steps=1)
        runs = {g: _run(api, cfg, whole, toks, g, mesh)
                for g in ("xla", "halo")}
        a, b = runs["xla"], runs["halo"]
        return {"err": max(float((x - y).abs().max()) for x, y in zip(
                    tree_flatten(a["params"])[1], tree_flatten(b["params"])[1])),
                "w_rel": float(((a["w"] - b["w"]) / a["w"]).abs().max()),
                "mass": float(b["w"].sum()),
                "placed": all(shlib.is_dtensor(x)
                              and x.to_local().shape == x.shape
                              for x in tree_flatten(steps.place_pods(
                                  api, whole, mesh))[1])}
    finally:
        close_clients_world()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--port", type=int, required=True)
    ap.add_argument("--port2", type=int, required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--reference", required=True)
    args = ap.parse_args(argv)
    torch.set_num_threads(1)
    from repro_torch.launch.mesh import close_clients_world, init_world

    mesh = init_world(args.rank, WORLD, args.port, "cpu", *MESH)
    try:
        t0 = time.time()
        glm = case_glm(mesh, args.rank, args.reference)
        glm["seconds"] = time.time() - t0
        glm["norm"] = case_norm(mesh, args.reference)
        glm["kv_replicated"] = case_kv_replicated(mesh)
    finally:
        close_clients_world()
    xlstm = case_xlstm(args.rank, args.port2) if args.rank < 2 else None
    if args.rank == 0:
        states = glm.pop("states")
        with open(os.path.join(args.out, "states.pkl"), "wb") as f:
            pickle.dump(states, f)
        with open(os.path.join(args.out, "results.json"), "w") as f:
            json.dump({"glm": glm, "xlstm": xlstm}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
