"""One rank of the placed-serving CPU world (``test_torch_placed_serve.py``):
8 ranks over gloo at ``tcp://localhost:PORT`` on the reference's ``(2, 2,
2)`` ``("pod", "data", "model")`` host mesh, and a second mesh of the same
world, ``(2, 1, 4)``, for an xlstm whose 2 heads are narrower than its
model axis.

    python tests/_torch_placed_serve_world.py --rank R --port P --out DIR

Each case of :data:`CASES` is a reduced config (``--set``-style overrides
of the smoke config) and a batch, chosen so that one placement of the
serving cache (``launch.sharding.cache_spec``) really occurs.  Every rank
draws the params from seed 0 and the prompts with ``launch.serve.prompts``
(seed 0), runs the mesh-less ``launch.serve.generate`` (prefill of S = 16
positions, then 3 decode steps), then the same on the replica placed over
its pod's submesh (``launch.sharding.place_params``), its pod's rows of the
requests placed by ``launch.steps.place_batch`` (where the batch divides
the pods and "data"), under ``sharding.use_mesh``.  Each rank writes
``DIR/rank{R}.json``, for each case:

* ``tokens``: whether the placed greedy tokens equal the mesh-less ones
  of the pod's rows;
* ``logits``: the largest difference of the placed logits from the
  mesh-less ones, over the largest mesh-less magnitude;
* ``cache``: for each cache leaf, the largest difference of the placed
  cache (gathered whole over the submesh) from the pod's rows of the
  mesh-less one, over the leaf's largest magnitude;
* ``placements``: each cache leaf's DTensor placements, by mesh dim;
* ``collectives`` (for the cases of :data:`COUNTED`): the bytes and counts
  of each collective kind the rank issues in one more decode step
  (``_torch_pod_world.CountingMode``), and the rows of the requests and
  the cache length the dry-run's rules need;
* ``port``: rank 0 of the (2, 2, 2) mesh writes the placed greedy tokens
  and logits of the cases of :data:`REFERENCE` (``DIR/port.pkl``) for the
  test to hold to the reference's host-mesh serve step.

Torch runs one intra-op thread.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import pickle
import sys

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
sys.path.insert(0, os.path.join(os.path.dirname(HERE), "src"))

WORLD = 8
MESH = ((2, 2, 2), ("pod", "data", "model"))
WIDE = ((2, 1, 4), ("pod", "data", "model"))
S, NEW = 16, 4  # prompt positions; new tokens (the first from the prefill)
# name -> (arch, overrides of its smoke config, batch, mesh)
CASES = {
    # 2 kv heads on a model axis of 2: the cache's kv heads on "model".
    "kv_heads": ("codeqwen1.5-7b", {}, 4, MESH),
    # 1 kv head: head_dim on "model", q's 4 heads there too; FSDP on.
    "head_dim": ("glm4-9b", {"n_kv_heads": 1, "fsdp": True}, 4, MESH),
    # A batch of 1: the positions on "data" (10 a rank), head_dim on
    # "model"; layer 0's window of 8 reads keys on both ranks, then on
    # rank 1's alone.
    "seq": ("gemma3-12b", {"n_kv_heads": 1, "sliding_window": 8,
                           "fsdp": True}, 1, MESH),
    "mla_moe": ("deepseek-v3-671b", {}, 4, MESH),
    "dbrx": ("dbrx-132b", {}, 4, MESH),
    # 8 image embeddings before the prompt, in the cache too.
    "vlm": ("llava-next-mistral-7b", {}, 4, MESH),
    # The SSM state's channels on "model", 8 meta tokens in the cache.
    "hymba": ("hymba-1.5b", {}, 4, MESH),
    # hymba's batch of 1: its 28 positions (meta tokens first) on "data".
    "hymba_seq": ("hymba-1.5b", {}, 1, MESH),
    # 4 heads on 2: the recurrent state's heads on "model".
    "xlstm": ("xlstm-350m", {}, 4, MESH),
    # 2 heads on 4: the state whole on every rank of "model".
    "xlstm_wide": ("xlstm-350m", {"n_heads": 2, "n_kv_heads": 2}, 4, WIDE),
}
COUNTED = ("kv_heads", "head_dim", "seq", "mla_moe", "hymba_seq",
           "xlstm_wide")
REFERENCE = ("head_dim", "seq")


def config(name):
    from repro_torch.configs.registry import get_config

    arch, over, _, _ = CASES[name]
    return dataclasses.replace(get_config(arch, smoke=True), **over)


def _pod_rows(x, mesh, b):
    """The rows of ``x`` (dim 0) the rank's pod serves: its block where the
    batch divides the pods and "data" (the placement puts it on ``("pod",
    "data")``), else all of them."""
    pods, data = mesh.size(0), mesh.size(1)
    if b % (pods * data):
        return x
    n = b // pods
    p = mesh.get_local_rank(0)
    return x.narrow(0, p * n, n)


def case(name, mesh, rank):
    from _torch_pod_world import CountingMode, _rel, _walk
    from repro_torch.launch import dryrun, serve
    from repro_torch.launch import sharding as shlib
    from repro_torch.launch.mesh import AbstractMesh
    from repro_torch.launch.steps import make_serve_step, place_batch
    from repro_torch.models.registry import get_model_api

    cfg = config(name)
    b = CASES[name][2]
    api = get_model_api(cfg)
    params = api.init(torch.Generator().manual_seed(0), "cpu")
    batch = serve.prompts(cfg, b, S, 0, "cpu")
    whole = serve.generate(api, params, batch, NEW)
    placed = shlib.place_params(params, api.param_defs(), mesh, cfg.fsdp,
                                model_axes=shlib.model_axes_for(cfg))
    pbatch = place_batch({k: _pod_rows(x, mesh, b) for k, x in batch.items()},
                         mesh, 0)
    with shlib.use_mesh(mesh, fsdp=cfg.fsdp):
        rec = serve.generate(api, placed, pbatch, NEW)
    out = {"tokens": bool(torch.equal(rec["tokens"], _pod_rows(
               whole["tokens"], mesh, b))),
           "logits": _rel(rec["logits"], _pod_rows(whole["logits"], mesh, b)),
           "cache": {}, "placements": {}}
    ref_cache = dict(_walk(whole["cache"]))
    defs = dict(_walk(api.cache_defs(b, 1)))
    for path, leaf in _walk(rec["cache"]):
        key = "/".join(path)
        out["placements"][key] = [str(p) for p in leaf.placements]
        bdim = defs[path].axes.index("batch")
        want = _pod_rows(ref_cache[path].movedim(bdim, 0), mesh, b)
        out["cache"][key] = _rel(shlib.full_tensor(leaf),
                                 want.movedim(0, bdim))
    if name in COUNTED:
        n_prefix = rec["n_prefix"]
        toks = pbatch["tokens"][:, -1]
        step = make_serve_step(api)
        from torch.distributed.tensor.experimental import implicit_replication

        mode = CountingMode()
        with shlib.use_mesh(mesh, fsdp=cfg.fsdp), implicit_replication(), \
                mode, torch.no_grad():
            step(placed, rec["cache"], toks, n_prefix + S + NEW - 1)
        shape, axes = (MESH if mesh.size(2) == 2 else WIDE)
        amesh = AbstractMesh(axes, dict(zip(axes, shape)))
        length = S + NEW + n_prefix
        rules = dryrun.collectives(
            api, amesh, "decode", toks.to_local().shape[0], 1, 1,
            cache=dryrun._abstract_cache(api, amesh, b, length))
        out["collectives"] = {"got": {"bytes": mode.bytes,
                                      "count": mode.count},
                              "rules": {"bytes": rules.bytes_by_kind,
                                        "count": rules.count_by_kind}}
    port = None
    if name in REFERENCE and rank == 0:
        port = {"tokens": rec["tokens"].numpy(),
                "logits": rec["logits"].numpy()}
    return out, port


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--port", type=int, required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--only", default="", help="comma-separated cases")
    args = ap.parse_args(argv)
    torch.set_num_threads(1)
    from repro_torch.launch.mesh import (
        close_clients_world,
        init_world,
        make_host_mesh,
    )

    names = args.only.split(",") if args.only else list(CASES)
    mesh = init_world(args.rank, WORLD, args.port, "cpu", *MESH)
    results, ports = {}, {}
    try:
        wide = make_host_mesh(*WIDE, device="cpu")
        for name in names:
            m = wide if CASES[name][3] == WIDE else mesh
            results[name], port = case(name, m, args.rank)
            if port is not None:
                ports[name] = port
    finally:
        close_clients_world()
    if ports:
        with open(os.path.join(args.out, "port.pkl"), "wb") as f:
            pickle.dump(ports, f)
    with open(os.path.join(args.out, f"rank{args.rank}.json"), "w") as f:
        json.dump(results, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
