"""One rank of the pod runtime's CPU world for every family
(``test_torch_pod_families.py``): 8 ranks over gloo at
``tcp://localhost:PORT``, the reference's ``(2, 2, 2)`` ``("pod", "data",
"model")`` host mesh, the reduced xlstm-350m, hymba-1.5b,
llava-next-mistral-7b, hubert-xlarge, dbrx-132b and deepseek-v3-671b, and
a reduced hymba-1.5b with 5 heads on 5 kv heads; 2 pods, K = 2 local steps
(one for the 5-head hymba) of B = 4 rows of S = 16 positions, one round
under ``gossip`` "xla".  A second mesh of the same world, ``(2, 1, 4)``,
runs a reduced xlstm-350m with 2 heads (each head's columns on 2 ranks of
"model") the same way.

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
* ``counts`` (rank 0): the FLOPs, bytes, kernel records and collectives
  that ``roofline.cost.CostMode`` counts on the rank in one round of the
  2-head xlstm on each mesh, its arguments made by
  ``launch.dryrun.placed_step_args`` (:func:`count`);

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
XLSTM_2 = "xlstm-350m-2h"  # 2 heads, run on WIDE too: 4 ranks over 2 heads
HELD = ("xlstm-350m", "dbrx-132b")  # held to the reference's round too
# The second mesh of the same world: a model axis wider than XLSTM_2's
# heads, each head's columns on 2 ranks.
WIDE = ((2, 1, 4), ("pod", "data", "model"))
# rank 0's counts under a CostMode, against the fake world's meta trace:
# XLSTM_2's round on each mesh (whole heads a rank on MESH, half a head on
# WIDE).
COUNTED = {"(2, 2, 2)": MESH, "(2, 1, 4)": WIDE}


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
    if name == XLSTM_2:
        return dataclasses.replace(get_config("xlstm-350m", smoke=True),
                                   n_heads=2, n_kv_heads=2)
    return get_config(name, smoke=True)


# The round :func:`count` runs: one local step a pod (K = 1) of B rows of S
# positions, 2 SAM passes.
COUNTED_STEP = {**STEP, "local_steps": 1}


def counted_shape():
    """The step :func:`count` runs: one round of N_PODS pods, one step of
    B rows of S positions each."""
    from repro_torch.configs.base import InputShape

    return InputShape("round", S, N_PODS * B, "train")


def count(name, mesh):
    """FLOPs, bytes and collectives that this rank counts under a
    ``CostMode`` around one round of ``name`` on ``mesh``, its arguments
    made as the dry-run makes them (``launch.dryrun.placed_step_args``,
    values drawn from seed 0) and the step run for real over gloo."""
    from repro_torch.launch import dryrun
    from repro_torch.launch import steps
    from repro_torch.models.registry import get_model_api
    from repro_torch.roofline.cost import CostMode

    api = get_model_api(config(name))
    args, run = dryrun.placed_step_args(
        api, counted_shape(), "round_step", mesh,
        steps.StepConfig(**COUNTED_STEP), device="cpu", seed=0)
    with CostMode(args) as mode:
        out = run(*args)
    rec = mode.result(out)
    return {k: rec[k] for k in ("flops", "bytes accessed", "kernels",
                                "collectives")}


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
        if name in HELD or name == XLSTM_2:
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
    results, counts = {}, {}
    try:
        for name in names:
            if name == XLSTM_2:
                continue
            results[name] = case(name, mesh, args.rank, initial[name])
        if XLSTM_2 in names:
            from repro_torch.launch.mesh import make_host_mesh

            wide = make_host_mesh(*WIDE, device="cpu")
            results[XLSTM_2] = case(XLSTM_2, wide, args.rank,
                                    initial[XLSTM_2])
            for label, (shape, axes) in COUNTED.items():
                m = mesh if (shape, axes) == MESH else wide
                counts[label] = count(XLSTM_2, m)
    finally:
        close_clients_world()
    if counts and args.rank == 0:
        results["counts"] = counts
    states = {n: r.pop("state") for n, r in results.items() if "state" in r}
    if states:
        with open(os.path.join(args.out, "states.pkl"), "wb") as f:
            pickle.dump(states, f)
    with open(os.path.join(args.out, f"rank{args.rank}.json"), "w") as f:
        json.dump(results, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
