"""One rank of the pod runtime's CPU world for every family
(``test_torch_pod_families.py``): 8 ranks over gloo at
``tcp://localhost:PORT``, the reference's ``(2, 2, 2)`` ``("pod", "data",
"model")`` host mesh, the reduced xlstm-350m, hymba-1.5b,
llava-next-mistral-7b, hubert-xlarge, dbrx-132b and deepseek-v3-671b, and
a reduced hymba-1.5b with 5 heads on 5 kv heads; 2 pods, K = 2 local steps
(one for the 5-head hymba) of B = 4 rows of S = 16 positions, one round
under ``gossip`` "xla".

    python tests/_torch_pod_families_world.py --rank R --port P \
        --out DIR --initial FILE

``FILE`` holds each config's initial pod-stacked params and its round
batches, as numpy (``test_torch_pod_families.py`` writes it, and the
reference's round reads it too).  Every rank places each
replica over its pod's (data, model) submesh (``launch.steps.place_pods``)
and runs the rounds; the state is gathered whole after them.  Rank 0 also
runs the mesh-less port round from the same state.  Each rank writes
``DIR/rank{R}.json``:

* ``shards``: the rank's local shard shape of each placed leaf, and
  whether every leaf is a DTensor;
* ``collectives`` (rank 0): the bytes and counts of each collective kind
  that the rank issues in the round (``_torch_pod_world.CountingMode``);
* ``norm``: ``core.sam.global_norm`` of the placed pods against the whole
  ones;

and rank 0 also ``run``: params (the largest of each leaf's error, and
that leaf), w, loss, accuracy and mass against the mesh-less round, and
``DIR/states.pkl``, the gathered states of the configs the reference's
host-mesh round is held to.

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

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
sys.path.insert(0, os.path.join(os.path.dirname(HERE), "src"))

from _torch_pod_world import CountingMode, _rel, _walk  # noqa: E402
from repro_torch.interop import params_from_numpy  # noqa: E402

WORLD = 8
MESH = ((2, 2, 2), ("pod", "data", "model"))
N_PODS, K, B, S, ROUNDS = 2, 2, 4, 16, 1
STEP = dict(lr=0.05, alpha=0.9, rho=0.05, local_steps=K)
ARCHS = ("xlstm-350m", "hymba-1.5b", "llava-next-mistral-7b",
         "hubert-xlarge", "dbrx-132b", "deepseek-v3-671b")
HYMBA_5 = "hymba-1.5b-5q5kv"  # 5 heads on 5 kv heads: no head split
HELD = ("xlstm-350m", "dbrx-132b")  # held to the reference's round too


def local_steps(name) -> int:
    """K of ``name``'s round (its batches' K dim, which the round runs):
    one step for the 5-head hymba, whose one step holds what it checks
    (heads that stay replicated)."""
    return 1 if name == HYMBA_5 else K


def config(name):
    from repro_torch.configs.registry import get_config

    if name == HYMBA_5:
        return dataclasses.replace(get_config("hymba-1.5b", smoke=True),
                                   n_heads=5, n_kv_heads=5)
    return get_config(name, smoke=True)


def _run(api, whole, batches, mesh=None, count=False):
    """ROUNDS "xla" rounds from the whole pod-stacked ``whole``: with
    ``mesh`` the pod runtime (this rank's pods placed), else mesh-less.
    Returns the whole state after the rounds, each round's metrics and,
    with ``count``, the first round's collectives."""
    from repro_torch.core.flat import tree_map
    from repro_torch.launch import sharding as shlib
    from repro_torch.launch import steps

    step = steps.make_round_step(api, steps.StepConfig(**STEP), gossip="xla")
    P = steps.pod_mixing_neighbors(N_PODS)
    whole = tree_map(torch.clone, whole)
    w = torch.ones((N_PODS,))
    rows = None if mesh is None else steps.pod_rows(mesh, N_PODS)
    if mesh is None:
        params = whole
    else:
        params = steps.place_pods(api, whole, mesh)
        w = rows.rows(w)
    v = tree_map(torch.zeros_like, params)
    metrics, counted = [], None
    with (shlib.use_mesh(mesh, fsdp=api.cfg.fsdp) if mesh is not None
          else contextlib.nullcontext()):
        for r in range(ROUNDS):
            batch = {k: x[r] if rows is None else rows.rows(x[r])
                     for k, x in batches.items()}
            mode = CountingMode() if count and r == 0 else None
            with mode if mode is not None else contextlib.nullcontext():
                params, v, w, _, _, m = step(params, v, w, (), (), batch, P)
            if mode is not None:
                counted = {"bytes": mode.bytes, "count": mode.count}
            metrics.append({"loss": float(m["loss"]), "acc": float(m["acc"])})
    if mesh is not None:
        params = steps.gather_pods(params, mesh, N_PODS)
        w = rows.all_gather(w)
    return {"params": params, "w": w, "metrics": metrics,
            "collectives": counted}


def case(name, mesh, rank, initial):
    from repro_torch.core.flat import tree_flatten, tree_map
    from repro_torch.core.sam import global_norm
    from repro_torch.launch import sharding as shlib
    from repro_torch.launch import steps
    from repro_torch.models.registry import get_model_api

    api = get_model_api(config(name))
    whole = params_from_numpy(initial["params"])
    batches = {k: torch.as_tensor(x) for k, x in initial["batch"].items()}
    placed = steps.place_pods(api, whole, mesh)
    out = {"shards": {"/".join(p): list(x.to_local().shape)
                      for p, x in _walk(placed)},
           "all_dtensors": all(shlib.is_dtensor(x)
                               for x in tree_flatten(placed)[1])}
    rows = steps.pod_rows(mesh, N_PODS)
    out["norm"] = {"placed": float(global_norm(placed)),
                   "whole": float(global_norm(tree_map(rows.rows, whole)))}
    del placed
    t0 = time.time()
    run = _run(api, whole, batches, mesh, count=rank == 0)
    out["seconds"] = time.time() - t0
    out["collectives"] = run["collectives"]
    if rank == 0:
        base = _run(api, whole, batches)
        errs = {"/".join(p): _rel(a, b) for (p, a), (_, b) in zip(
            _walk(run["params"]), _walk(base["params"]))}
        out["run"] = {
            "params": max(errs.values()),
            "worst": max(errs, key=errs.get),
            "w": float((run["w"] - base["w"]).abs().max()),
            "loss": max(abs(a["loss"] - b["loss"]) / abs(b["loss"])
                        for a, b in zip(run["metrics"], base["metrics"])),
            "acc": max(abs(a["acc"] - b["acc"]) for a, b in
                       zip(run["metrics"], base["metrics"])),
            "mass": float(run["w"].sum())}
        if name in HELD:
            out["state"] = {"params": {"/".join(p): x.numpy()
                                       for p, x in _walk(run["params"])},
                            "w": run["w"].numpy(), "metrics": run["metrics"]}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--port", type=int, required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--initial", required=True)
    ap.add_argument("--only", default="", help="comma-separated configs")
    args = ap.parse_args(argv)
    torch.set_num_threads(1)
    from repro_torch.launch.mesh import close_clients_world, init_world

    with open(args.initial, "rb") as f:
        initial = pickle.load(f)
    names = args.only.split(",") if args.only else list(initial)
    mesh = init_world(args.rank, WORLD, args.port, "cpu", *MESH)
    results = {}
    try:
        for name in names:
            results[name] = case(name, mesh, args.rank, initial[name])
    finally:
        close_clients_world()
    states = {n: r.pop("state") for n, r in results.items() if "state" in r}
    if states:
        with open(os.path.join(args.out, "states.pkl"), "wb") as f:
            pickle.dump(states, f)
    with open(os.path.join(args.out, f"rank{args.rank}.json"), "w") as f:
        json.dump(results, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
