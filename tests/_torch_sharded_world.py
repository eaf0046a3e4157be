"""One rank of the row-sharded bank's CPU world (``test_torch_sharded.py``):
n = 64 clients, 8 rows a rank, gloo over ``tcp://localhost:PORT``.

    python tests/_torch_sharded_world.py --rank R --world 8 --port P \
        --out DIR --reference FILE

Every rank runs the unsharded port program and the sharded one on the same
seed, gathers the sharded state (``RoundProgram.whole_state``) and compares
the two; rank 0 writes what it measured to ``DIR/results.json``:

* ``mix``: each executor on one random bank and operator per family (ring,
  exponential, kout, the two-tier inter list, each with a third of its
  slots at weight 0), the rank's rows against the unsharded mix: the
  all-gather and halo executors bit for bit, the dense row panel within
  the f32 tolerance;
* ``equivalence``: ring, kout dense, kout sparse, two_tier (8 pods, one a
  rank, and 4 pods, each over two ranks) and top-k EF with delayed links,
  3 rounds: bank, w, loss, accuracy and mass;
* ``halo``: halo against all-gather against unsharded under drops, delays
  and churn, 4 rounds, the mass every round;
* ``reference``: the ``REFERENCE`` configurations under the all-gather and
  the halo executor, each of ``REFERENCE_ROUNDS`` rounds restarted from the
  reference's state and fed its draws (``FILE``, which
  ``test_torch_sharded.py`` records with the JAX reference: the world
  itself imports no JAX), against the reference's round;
* ``checkpoint``: a sharded save after 2 rounds, an unsharded and a sharded
  restore, one more round each.

The data are made from a seed with numpy; torch runs one intra-op thread.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(os.path.dirname(HERE), "src"))

N = 64
WORLD = 8

# The world's configurations as plain fields, (topology, (algorithm, its
# fields), link model, churn model), which each package builds with its own
# classes: the world with the port's, ``test_torch_sharded.py`` with the
# reference's.
SGP = ("sgp", dict(batch_size=4))
EF = ("dfedsgpsm", dict(local_steps=1, batch_size=4, compressor="topk_ef",
                        topk_ratio=0.25))
RING = dict(kind="ring", n_clients=N, k_out=1)
KOUT = dict(kind="kout", n_clients=N, k_out=10)
CONFIGS = {
    "ring": (RING, SGP, None, None),
    "kout": (KOUT, SGP, None, None),
    # 8 pods, one a rank.
    "two_tier": (dict(kind="two_tier", n_clients=N, k_out=10, n_pods=WORLD),
                 SGP, None, None),
    # Pods of 16 rows span two ranks: the intra term from the gathered bank.
    "two_tier-4pods": (dict(kind="two_tier", n_clients=N, k_out=10,
                            n_pods=4), SGP, None, None),
    "topk_ef+delay": (KOUT, EF, dict(delay=1), None),
    "ring+topk_ef+delay": (RING, EF, dict(delay=1), None),
    "ring+drop": (RING, SGP, dict(drop=0.3), None),
    "kout+churn": (KOUT, SGP, None, dict(fail_prob=0.15, recover_prob=0.3)),
    "kout+drop+delay": (KOUT, SGP, dict(drop=0.2, delay=2), None),
    "two_tier+topk_ef": (dict(kind="two_tier", n_clients=N, k_out=10,
                              n_pods=WORLD), EF, None, None),
}
# case: (configuration, gossip of the unsharded program)
EQUIVALENCE = {"ring": ("ring", "sparse"), "kout-dense": ("kout", "dense"),
               "kout-sparse": ("kout", "sparse"),
               "two_tier": ("two_tier", "sparse"),
               "two_tier-4pods": ("two_tier-4pods", "sparse"),
               "topk_ef+delay": ("topk_ef+delay", "sparse")}
HALO = ["ring", "ring+topk_ef+delay", "ring+drop", "kout+churn",
        "kout+drop+delay", "two_tier+topk_ef"]
# Held against the reference's rounds on its draws, under both executors.
# The others are held against it unsharded: "kout" dense and sparse by
# test_torch_round_dense.py / test_torch_round_sparse.py (sgp), "two_tier"
# by test_torch_two_tier.py's round parity.
REFERENCE = ["ring", "ring+drop", "ring+topk_ef+delay", "kout+churn",
             "kout+drop+delay", "topk_ef+delay", "two_tier-4pods",
             "two_tier+topk_ef"]
REFERENCE_ROUNDS = 2


def world_data() -> dict:
    rng = np.random.default_rng(3)
    return {"x": rng.standard_normal((N, 20, 8)).astype(np.float32),
            "y": rng.integers(0, 2, (N, 20)).astype(np.int64)}


def setting():
    from repro_torch.models.small import tiny_mlp

    return tiny_mlp(in_dim=8, hidden=6, n_classes=2), world_data()


def build(name: str):
    """The port's (topology, algorithm, link, churn) of a configuration."""
    from repro_torch.core import ChurnModel, LinkModel, TopologyConfig, make_algo

    topo, (algo, akw), link, churn = CONFIGS[name]
    return (TopologyConfig(**topo), make_algo(algo, **akw),
            None if link is None else LinkModel(**link),
            None if churn is None else ChurnModel(**churn))


def programs(mesh, model, data, algo, topo, gossip, **kw):
    from repro_torch.core import make_program

    ref = make_program(model.loss, model.init, data, algo, topo,
                       gossip="sparse" if gossip in ("xla", "halo") else gossip,
                       device="cpu", **kw)
    sh = make_program(model.loss, model.init, data, algo, topo, gossip=gossip,
                      mesh=mesh, device="cpu", **kw)
    return ref, sh


def err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def mass(state) -> float:
    m = float(state.w.double().sum())
    if state.link and not isinstance(state.link.bufw, tuple):
        m += float(state.link.bufw.double().sum())
    return m


def compare(ref_state, whole, ref_m, sh_m) -> dict:
    out = {"params": err(ref_state.params, whole.params),
           "w": err(ref_state.w, whole.w),
           "scale": float(ref_state.params.abs().max()),
           "mass": mass(whole),
           "params_equal": bool(torch.equal(ref_state.params, whole.params))}
    for k in ("loss", "acc", "w_mass"):
        if k in ref_m:
            out[k] = abs(float(ref_m[k]) - float(sh_m[k]))
    if not isinstance(whole.comp, tuple):
        out["comp"] = err(ref_state.comp, whole.comp)
    if whole.link and not isinstance(whole.link.bufx, tuple):
        out["bufx"] = err(ref_state.link.bufx, whole.link.bufx)
    return out


def case_mix(mesh, shard) -> dict:
    from repro_torch.comm.plan import CommPlan
    from repro_torch.core import TopologyConfig, topology
    from repro_torch.kernels import gossip_gather as gg
    from repro_torch.kernels import ops

    gen = torch.Generator().manual_seed(11)
    X = torch.randn(N, 5, generator=gen)
    rows = shard.rows(X)
    out = {}
    fams = {
        "ring": (TopologyConfig(kind="ring", n_clients=N, k_out=1),
                 topology.neighbors_ring(N)),
        "exponential": (TopologyConfig(kind="exponential", n_clients=N,
                                       k_out=1),
                        topology.neighbors_exponential(N, 3)),
        "kout": (TopologyConfig(kind="kout", n_clients=N, k_out=10),
                 topology.sample_kout_neighbors(gen, N, 10)),
        "two_tier": (TopologyConfig(kind="two_tier", n_clients=N, k_out=10,
                                    n_pods=WORLD),
                     topology.sample_two_tier(gen, N, WORLD, 10).inter),
    }
    for name, (topo, nl) in fams.items():
        keep = torch.rand(nl.idx.shape, generator=gen) >= 1 / 3
        keep[:, 0] = True
        wgt = torch.where(keep, nl.wgt, torch.zeros(()))
        want = gg.gossip_gather(nl.idx, wgt, X)[shard.lo:shard.hi]
        plan = CommPlan.build(topo, WORLD)
        got_x = gg.gossip_gather_xla(nl.idx, wgt, rows, shard)
        got_h = gg.gossip_gather_halo(nl.idx, wgt, rows, shard=shard,
                                      plan=plan)
        P = topology.dense_from_neighbors(topology.NeighborList(nl.idx, wgt),
                                          N)
        dense = ops.gossip_mix(P, rows, shard)
        out[name] = {
            "allgather_equal": bool(torch.equal(got_x, want)),
            "halo_equal": bool(torch.equal(got_h, want)),
            "static": plan.static,
            "dense": err(dense, (P @ X)[shard.lo:shard.hi]),
            "dense_scale": float(X.abs().max()),
        }
    return out


def case_equivalence(mesh) -> dict:
    model, data = setting()
    out = {}
    for name, (config, gossip) in EQUIVALENCE.items():
        topo, algo, link, churn = build(config)
        ref, sh = programs(mesh, model, data, algo, topo, gossip, link=link,
                           churn=churn)
        s0 = ref.init(torch.Generator().manual_seed(0))
        s1 = sh.init(torch.Generator().manual_seed(0))
        rounds = []
        for _ in range(3):
            s0, m0 = ref.step(s0)
            s1, m1 = sh.step(s1)
            rounds.append(compare(s0, sh.whole_state(s1), m0, m1))
        out[name] = {"rounds": rounds, "rows": int(s1.params.shape[0])}
    return out


def case_halo(mesh) -> dict:
    from repro_torch.core import make_program

    model, data = setting()
    out = {}
    for name in HALO:
        topo, algo, link, ch = build(name)
        progs = [make_program(model.loss, model.init, data, algo, topo,
                              gossip=g, link=link, churn=ch, mesh=m,
                              device="cpu")
                 for g, m in (("sparse", None), ("xla", mesh),
                              ("halo", mesh))]
        states = [p.init(torch.Generator().manual_seed(0)) for p in progs]
        rounds = []
        for _ in range(4):
            stepped = [p.step(s) for p, s in zip(progs, states)]
            states = [s for s, _ in stepped]
            ref, sx, sh = states
            wx, wh = progs[1].whole_state(sx), progs[2].whole_state(sh)
            rounds.append({
                "halo_vs_unsharded": err(ref.params, wh.params),
                "halo_vs_allgather": err(wx.params, wh.params),
                "halo_equals_allgather": bool(torch.equal(wx.params,
                                                          wh.params)),
                "w": err(ref.w, wh.w),
                "mass": mass(wh),
                "w_mass": float(stepped[2][1].get("w_mass", float("nan"))),
                "scale": float(ref.params.abs().max()),
            })
        out[name] = {"rounds": rounds,
                     "backend": type(progs[2].mixer.backend).__name__}
    return out


def dense_operator(P) -> torch.Tensor:
    from repro_torch.core import topology

    if isinstance(P, topology.TwoTierOp):
        return topology.dense_from_two_tier(P)
    if isinstance(P, topology.NeighborList):
        return topology.dense_from_neighbors(P, N)
    return torch.as_tensor(P).float()


def flip_steps(plain, whole, draws) -> torch.Tensor:
    """What one top-k flip can move each sender's transmitted coordinate by
    (the k-th largest magnitude of ``X + residual`` from the round's local
    steps), as ``test_torch_round_compress.py`` bounds it; 0 without the
    top-k residual."""
    if not torch.is_tensor(whole.comp):
        return torch.zeros(N)
    idx = torch.as_tensor(draws["batch_idx"]).long()
    X, *_ = plain.solver.update(plain.loss_fn, plain.spec, whole.params,
                                whole.w, idx, plain.data,
                                plain.round_lr(whole.round))
    y = X.float() + whole.comp
    k = max(int(plain.compressor.ratio * y.shape[1]), 1)
    return torch.topk(y.abs(), k, dim=1).values[:, -1]


def reference_errors(plain, whole, rec, got, metrics) -> dict:
    """One restarted round of the sharded program against the reference's
    round from the same state on the same draws.  Under top-k EF a bank
    coordinate may also differ by what the senders that swapped it (kept
    by one package, dropped by the other: their residual is 0 in exactly
    one) moved it, ``sum_{j != i} P[i, j] step_j`` over those senders;
    ``*_excess`` is the largest error beyond 1e-5 of the bank's magnitude
    plus that."""
    post = rec["post"]
    want = torch.from_numpy(post["params"])
    scale = float(want.abs().max())
    step = flip_steps(plain, whole, rec["draws"])
    P = dense_operator(rec["draws"]["P"])
    flip = torch.zeros_like(want)
    if post["comp"] is not None:
        swapped = (got.comp == 0) != (torch.from_numpy(post["comp"]) == 0)
        flip = (P * (1.0 - torch.eye(N))) @ (step[:, None] * swapped)
    out = {
        "params": err(got.params, want),
        "params_excess": float(((got.params.float() - want).abs()
                                - 1e-5 * scale - flip).max()),
        "flip": float(flip.max()),
        "scale": scale,
        "w": err(got.w, torch.from_numpy(post["w"])),
        "mom": err(got.mom, torch.from_numpy(post["mom"])),
        "mom_scale": float(abs(post["mom"]).max()),
        "step": float(step.max()),
        "mass": mass(got),
        "metrics": {k: (abs(float(metrics[k]) - v) if k in metrics
                        else float("inf"))
                    for k, v in rec["metrics"].items()},
    }
    if post["comp"] is not None:
        out["comp"] = err(got.comp, torch.from_numpy(post["comp"]))
    if post.get("link") is not None:
        if post["link"]["bufx"] is not None:
            bufx = torch.from_numpy(post["link"]["bufx"])
            out["bufx_excess"] = float(((got.link.bufx.float() - bufx).abs()
                                        - 1e-5 * scale - flip).max())
        if post["link"]["bufw"] is not None:
            out["bufw"] = err(got.link.bufw,
                              torch.from_numpy(post["link"]["bufw"]))
    if post.get("churn") is not None:
        out["live_equal"] = bool(torch.equal(
            got.churn.live, torch.from_numpy(post["churn"]["live"]).to(
                torch.int8)))
    return out


def case_reference(mesh, path) -> dict:
    """The ``REFERENCE`` configurations under the all-gather and the halo
    executor, each round restarted from the reference's state and fed its
    draws (``path``: the rounds ``test_torch_sharded.py`` recorded)."""
    import pickle

    from repro_torch.core import make_program
    from repro_torch.interop import state_from_numpy

    with open(path, "rb") as f:
        recorded = pickle.load(f)
    model, data = setting()
    out = {}
    for name, rounds in recorded.items():
        topo, algo, link, churn = build(name)
        plain = make_program(model.loss, model.init, data, algo, topo,
                             gossip="sparse", link=link, churn=churn,
                             device="cpu")
        for gossip in ("xla", "halo"):
            prog = make_program(model.loss, model.init, data, algo, topo,
                                gossip=gossip, link=link, churn=churn,
                                mesh=mesh, device="cpu")
            res = []
            for rec in rounds:
                keys = [torch.Generator().manual_seed(0) for _ in range(3)]
                whole = state_from_numpy(rec["pre"], keys[0],
                                         link_key=keys[1], churn_key=keys[2])
                st, metrics = prog.step(prog.shard_state(whole),
                                        rec["draws"])
                res.append(reference_errors(plain, whole, rec,
                                            prog.whole_state(st), metrics))
            out[f"{name}/{gossip}"] = {
                "rounds": res, "backend": type(prog.mixer.backend).__name__}
    return out


def case_checkpoint(mesh, shard, out_dir) -> dict:
    from repro_torch.core import FLTrainer, TopologyConfig, make_algo

    model, data = setting()
    algo = make_algo("dfedsgpsm", local_steps=1, batch_size=4)
    topo = TopologyConfig(kind="two_tier", n_clients=N, k_out=10,
                          n_pods=WORLD)

    def trainer(m):
        return FLTrainer(model.loss, model.init, data, algo, topo, seed=0,
                         gossip="sparse", mesh=m, device="cpu")

    a = trainer(mesh)
    a.run_round()
    a.run_round()
    path = a.save(os.path.join(out_dir, "ckpt"), step=2)
    saved = a.program.whole_state(a.state)
    ma = a.run_round()
    whole_a = a.program.whole_state(a.state)
    b = trainer(None)  # unsharded restore
    b.restore(path)
    restored_equal = all(
        torch.equal(x, y) for x, y in ((b.state.params, saved.params),
                                       (b.state.mom, saved.mom),
                                       (b.state.w, saved.w),
                                       (b.state.losses, saved.losses)))
    mb = b.run_round()
    c = trainer(mesh)  # sharded restore
    c.restore(path)
    rows_c = int(c.state.params.shape[0])
    round_c = int(c.state.round)
    mc = c.run_round()
    whole_c = c.program.whole_state(c.state)
    return {
        "path": path,
        "restored_equal": restored_equal,
        "rows_after_restore": rows_c,
        "round_after_restore": round_c,
        "unsharded_params": err(whole_a.params, b.state.params),
        "unsharded_equal": bool(torch.equal(whole_a.params, b.state.params)),
        "unsharded_loss": abs(float(ma["loss"]) - float(mb["loss"])),
        "sharded_equal": bool(torch.equal(whole_a.params, whole_c.params)
                              and torch.equal(whole_a.w, whole_c.w)),
        "sharded_loss": abs(float(ma["loss"]) - float(mc["loss"])),
        "scale": float(whole_a.params.abs().max()),
        "saved_round": 2,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--world", type=int, default=WORLD)
    ap.add_argument("--port", type=int, required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--reference", required=True,
                    help="the reference's recorded rounds (a pickle)")
    args = ap.parse_args(argv)
    torch.set_num_threads(1)
    from repro_torch.launch.mesh import close_clients_world, init_clients_world
    from repro_torch.launch.sharding import bank_row_pins

    mesh = init_clients_world(args.rank, args.world, args.port, device="cpu")
    try:
        shard = bank_row_pins(mesh, "clients", N)
        results = {"world": shard.world, "m": shard.m,
                   "mix": case_mix(mesh, shard),
                   "equivalence": case_equivalence(mesh),
                   "halo": case_halo(mesh),
                   "reference": case_reference(mesh, args.reference),
                   "checkpoint": case_checkpoint(mesh, shard, args.out)}
        if args.rank == 0:
            with open(os.path.join(args.out, "results.json"), "w") as f:
                json.dump(results, f, indent=1)
    finally:
        close_clients_world()
    return 0


if __name__ == "__main__":
    sys.exit(main())
