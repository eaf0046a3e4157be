"""Production training launcher: pods-as-clients DFedSGPSM — the port of
``repro.launch.train``.

Every pod holds a full replica, runs K local SAM-momentum steps on its own
token stream and exchanges parameters by directed push-sum gossip (one
``launch.steps.make_round_step`` a round).  Both of the reference's meshes
have a pod axis of 2 (the host mesh (2, 2, 2) and the multi-pod production
mesh), so the port runs 2 pods.  Without ``--host-mesh`` their replicas are
stacked on one device.  ``--host-mesh`` runs the reference's (2, 2, 2)
``("pod", "data", "model")`` mesh over a running 8-rank world started by
``torch.distributed.run`` (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR`` and
``MASTER_PORT`` from its environment): each pod's replica is placed over
its (data, model) submesh (``launch.steps.place_pods``; every family, a
mixture's experts on "model"), rank 0 logs and writes the checkpoints,
gathered whole, and ``--resume`` places them again.  The default arch,
xlstm-350m, as the reference's own test runs it:

  python -m torch.distributed.run --nproc-per-node 8 \
      -m repro_torch.launch.train --host-mesh --smoke --device cpu \
      --rounds 2 --batch 4 --seq 32

Like the reference's, the launcher feeds token batches: it trains the lm
task's archs (the dense decoders, dbrx-132b, deepseek-v3-671b, xlstm-350m,
hymba-1.5b); the vlm and masked_lm archs train through
``launch.steps.make_round_step`` with their tasks' batches.

``--superstep N`` runs N rounds between host boundaries, which
log and checkpoint; ``--resume`` restarts from the latest round-state
checkpoint in ``--ckpt-dir`` (the reference's file tree: ``params``,
``v``, ``w``, ``round``, and ``comp`` / ``link`` when present).

Runs on the card (``--device cuda``, the default) unless asked for the CPU
(``--device cpu``, where every kernel takes its plain PyTorch version).
Parameters are drawn on the device from a ``torch.Generator`` seeded 0;
tokens come from ``data.synthetic.make_lm_stream``, the reference's token
for token.

  PYTHONPATH=src python -m repro_torch.launch.train --arch glm4-9b \\
      --smoke --rounds 6 --superstep 3 --device cpu

``--paged`` switches to the virtual-client-population driver instead: a
population of ``--n-clients`` synthetic clients lives in a disk-backed
store under ``--store-dir`` and each round pages in only the
``--k-active`` sampled clients plus their in-neighbors.  The checkpoint is
the store itself; ``--resume`` reopens it.

  PYTHONPATH=src python -m repro_torch.launch.train --paged \\
      --n-clients 4096 --k-active 256 --rounds 3 --store-dir /tmp/pop

:func:`main` parses the arguments and calls :func:`run` with the
architecture's config, which callers may also call with a config of their
own (e.g. with its depth cut).
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

__all__ = ["build_parser", "main", "run", "N_PODS", "HOST_MESH"]

# The pod axis of both of the reference's meshes.
N_PODS = 2
# The reference's host mesh: (shape, axis names).
HOST_MESH = ((2, 2, 2), ("pod", "data", "model"))
# What ``--host-mesh`` reads from the launcher's environment.
_WORLD_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


def _paged_main(args):
    """Virtual-client-population driver: disk-backed store, paged rounds."""
    from repro_torch.core.engine import FLTrainer, make_algo
    from repro_torch.core.topology import TopologyConfig
    from repro_torch.data.dirichlet import dirichlet_partition, stack_client_data
    from repro_torch.data.synthetic import DatasetSpec, make_dataset
    from repro_torch.models.small import tiny_mlp
    from repro_torch.store import ClientStore

    if not args.store_dir:
        raise SystemExit("--paged requires --store-dir")
    if ClientStore.exists(args.store_dir) and not args.resume:
        raise SystemExit(
            f"{args.store_dir} already holds a client store; pass --resume "
            "to continue it or point --store-dir somewhere fresh"
        )
    n = args.n_clients
    spec = DatasetSpec("toy", (32,), 10, margin=3.0)
    train, _ = make_dataset(spec, n * 8, 256, seed=0)
    parts = dirichlet_partition(train["y"], n, alpha=0.3, seed=0)
    cdata = stack_client_data(train, parts, pad_to=16)
    model = tiny_mlp(in_dim=32, n_classes=10)
    topo_kw = dict(kind=args.topology, n_clients=n, k_out=args.k_out)
    if args.topology == "two_tier":
        topo_kw["n_pods"] = max(n // 8, 2)
    elif args.topology in ("ring", "exponential"):
        topo_kw["k_out"] = 1
    topo = TopologyConfig(**topo_kw)
    algo = make_algo(
        "dfedsgpsm", local_steps=args.local_steps, batch_size=args.batch,
        lr=args.lr, alpha=args.alpha, rho=args.rho,
        compressor=args.compress, topk_ratio=args.topk_ratio,
    )
    churn = None
    if args.churn_fail > 0:
        from repro_torch.core.topology import ChurnModel

        churn = ChurnModel(
            fail_prob=args.churn_fail, recover_prob=args.churn_recover,
            permanent_frac=args.churn_permanent,
            resurrect=args.churn_resurrect,
        )
    faults = None
    if args.io_eio > 0 or args.io_corrupt > 0 or args.io_torn > 0:
        from repro_torch.store import FaultInjector

        faults = FaultInjector(
            seed=args.io_seed, eio_prob=args.io_eio,
            torn_write_prob=args.io_torn, corrupt_prob=args.io_corrupt,
        )
    trainer = FLTrainer(
        model.loss, model.init, cdata, algo, topo,
        paged=True, store_dir=args.store_dir, k_active=args.k_active,
        churn=churn, faults=faults, device=args.device,
    )
    runner = trainer.runner
    print(f"[train] paged population n={n} k_active={args.k_active} "
          f"topology={args.topology} resident<={runner.resident_rows} rows "
          f"(round {runner.round_index})")
    r0 = runner.round_index
    for i in range(args.rounds):
        t0 = time.time()
        m = trainer.run_round()
        live = (f" live={m['live_frac']:.2f}" if "live_frac" in m else "")
        print(f"[train] round {r0 + i:4d} loss={m['loss']:.4f} "
              f"acc={m['acc']:.4f} resident={int(m['rows_resident'])} "
              f"mass_err={m['w_mass_closure_err']:.2e}{live} "
              f"dt={time.time() - t0:.2f}s", flush=True)
    path = trainer.save()  # the checkpoint IS the store manifest
    stats = runner.stats.as_dict()
    mass = runner.total_mass()
    heal = ""
    if faults is not None:
        heal = (f" io_retries={stats['io_retries']} "
                f"corrupt_chunks={stats['corrupt_chunks']} "
                f"rebuilt_rows={stats['rebuilt_rows']}")
    print(f"[train] committed {path} at round {runner.round_index} | "
          f"total_mass={mass:.4f} "
          f"prefetch_hit_rate={stats['prefetch_hit_rate']:.3f} "
          f"rows_faulted/round={stats['rows_faulted_per_round']:.1f}{heal}")
    runner.close()
    if abs(mass - n) >= 1e-3 * n:
        raise RuntimeError(f"push-sum mass {mass} is not n = {n}")
    return {"trainer": trainer, "mass": mass, "path": path}


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="xlstm-350m")
    ap.add_argument("--rounds", type=int, default=10)
    ap.add_argument("--local-steps", type=int, default=2)
    ap.add_argument("--batch", type=int, default=8, help="per-pod batch")
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=0.05)
    ap.add_argument("--alpha", type=float, default=0.9)
    ap.add_argument("--rho", type=float, default=0.05)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--superstep", type=int, default=1,
                    help="rounds between host boundaries: the host logs and "
                         "checkpoints only there; 1 = per-round")
    ap.add_argument("--compress", default="identity",
                    help="pod gossip compressor stage name (e.g. int8_rows, "
                         "topk_ef — stateful stages carry their residual "
                         "bank through the round and checkpoints)")
    ap.add_argument("--topk-ratio", type=float, default=0.05,
                    help="kept fraction per row for --compress topk_ef")
    ap.add_argument("--link-drop", type=float, default=0.0,
                    help="per-round i.i.d. failure probability of each "
                         "directed pod link; drops renormalize the graph "
                         "before the send, so no push-sum mass leaks")
    ap.add_argument("--link-delay", type=int, default=0,
                    help="staleness bound B: each surviving link delivers "
                         "0..B rounds late; in-flight payloads ride the "
                         "round state (and checkpoints)")
    ap.add_argument("--event-threshold", type=float, default=0.0,
                    help="event-triggered gossip: a pod retransmits only "
                         "after drifting this far (L2) from its last "
                         "broadcast (comm_fraction is logged)")
    ap.add_argument("--smoke", action="store_true", help="reduced config")
    ap.add_argument("--host-mesh", action="store_true",
                    help="the reference's (2, 2, 2) (pod, data, model) mesh "
                         "over the 8-rank world of torch.distributed.run: "
                         "each pod's replica placed over its (data, model) "
                         "submesh")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--resume", action="store_true",
                    help="warm-restart from the latest checkpoint in "
                         "--ckpt-dir (params + momentum + w + round); with "
                         "--paged, reopen the store in --store-dir")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (their plain versions)")
    ap.add_argument("--paged", action="store_true",
                    help="virtual client population: the (n, D) bank lives "
                         "in a disk-backed store and each round pages in "
                         "only the sampled clients + their in-neighbors")
    ap.add_argument("--n-clients", type=int, default=4096,
                    help="population size (--paged)")
    ap.add_argument("--k-active", type=int, default=256,
                    help="sampled clients per round (--paged)")
    ap.add_argument("--store-dir", default=None,
                    help="client-store directory (--paged; required)")
    ap.add_argument("--topology", default="kout",
                    choices=["ring", "exponential", "kout", "two_tier"],
                    help="graph family of the paged population")
    ap.add_argument("--k-out", type=int, default=2,
                    help="out-degree for kout/two_tier (--paged)")
    ap.add_argument("--churn-fail", type=float, default=0.0,
                    help="per-round node failure probability (--paged)")
    ap.add_argument("--churn-recover", type=float, default=0.0,
                    help="per-round resurrection probability of a "
                         "transiently-dead client")
    ap.add_argument("--churn-permanent", type=float, default=0.0,
                    help="fraction of failures that are permanent")
    ap.add_argument("--churn-resurrect", default="warm",
                    choices=["warm", "cold"],
                    help="warm = resume the stored row; cold = restart "
                         "from the init template")
    ap.add_argument("--io-eio", type=float, default=0.0,
                    help="injected transient read-fault probability")
    ap.add_argument("--io-torn", type=float, default=0.0,
                    help="injected torn-write probability (--paged)")
    ap.add_argument("--io-corrupt", type=float, default=0.0,
                    help="injected post-write bit-flip probability")
    ap.add_argument("--io-seed", type=int, default=0,
                    help="fault-injector PRNG seed")
    return ap


def _mass(w, link):
    """Total push-sum mass: node weights + any in-flight shares."""
    inflight = (link.bufw.sum()
                if link != () and not isinstance(link.bufw, tuple) else 0.0)
    return w.sum() + inflight


def _rows_of(x, fn, lead: int = 0):
    """``fn(x, lead)`` on a bank-row carry, or an empty carry (``()``) as
    it is."""
    return x if isinstance(x, tuple) else fn(x, lead)


def _link_rows(link, fn):
    """``fn`` on the bank rows of a link carry: the in-flight payloads'
    rows (dim 1) and the last broadcast's (dim 0)."""
    if link == ():
        return link
    return link._replace(bufx=_rows_of(link.bufx, fn, 1),
                         bufw=_rows_of(link.bufw, fn, 1),
                         last=_rows_of(link.last, fn))


def _dist_rank() -> int:
    """This process's rank in the running world (0 without one)."""
    import torch.distributed as dist

    return dist.get_rank() if dist.is_initialized() else 0


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _host_mesh(device: torch.device):
    """The reference's (2, 2, 2) host mesh over the world that
    ``torch.distributed.run`` started (its environment gives the rank, the
    world size and the store's address); refuses without that
    environment."""
    import os

    from repro_torch.launch.mesh import init_world

    missing = [k for k in _WORLD_ENV if k not in os.environ]
    if missing:
        raise SystemExit(
            f"--host-mesh runs in a world of 8 ranks started by "
            f"torch.distributed.run (python -m torch.distributed.run "
            f"--nproc-per-node 8 -m repro_torch.launch.train --host-mesh "
            f"...); {', '.join(missing)} not set")
    return init_world(int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"]),
                      None, device, *HOST_MESH)


def run(cfg, args, on_round=None) -> dict:
    """Train ``cfg`` with the pod runtime as ``args`` (from
    :func:`build_parser`) says.  ``on_round(r, metrics)`` is called after
    each round once its metrics are on the host.  Returns the run's record:
    the per-round ``history`` (round, loss, acc, w_mass, dt), the final
    ``params``, ``v``, ``w``, ``comp``, ``link`` (under ``--host-mesh`` this
    rank's pods, placed), and what a caller needs to run one more round
    (``api``, ``round_step``, ``tokens``, ``P_pod``, ``mesh``)."""
    if not getattr(args, "host_mesh", False):
        return _run(cfg, args, on_round, None)
    from repro_torch.launch.mesh import close_clients_world

    mesh = _host_mesh(torch.device(args.device))
    try:
        return _run(cfg, args, on_round, mesh)
    finally:
        close_clients_world()


def _run(cfg, args, on_round, mesh) -> dict:
    import contextlib

    from repro_torch.launch import sharding as shlib
    from repro_torch import checkpoint
    from repro_torch.core.flat import tree_map
    from repro_torch.data.synthetic import make_lm_stream
    from repro_torch.kernels import ops as kops
    from repro_torch.launch.steps import (
        StepConfig,
        init_pod_comp_state,
        gather_pods,
        init_pod_link_state,
        make_round_step,
        place_batch,
        place_pods,
        pod_mixing_matrix,
        pod_mixing_neighbors,
        pod_rows,
        resolve_compressor,
        resolve_pod_link,
        resolve_pod_mixer,
    )
    from repro_torch.models.registry import get_model_api

    device = torch.device(args.device)
    n_pods = N_PODS
    api = get_model_api(cfg)
    rows = pod_rows(mesh, n_pods)
    lead = _dist_rank() == 0
    say = print if lead else (lambda *a, **k: None)
    step_cfg = StepConfig(lr=args.lr, alpha=args.alpha, rho=args.rho,
                          local_steps=args.local_steps,
                          microbatches=args.microbatches,
                          compressor=args.compress,
                          topk_ratio=args.topk_ratio,
                          link_drop=args.link_drop,
                          link_delay=args.link_delay,
                          event_threshold=args.event_threshold)
    compressor = resolve_compressor(step_cfg)
    link_model = resolve_pod_link(step_cfg)
    mixer = resolve_pod_mixer(step_cfg, link_model)
    round_step = make_round_step(api, step_cfg, mixer=mixer,
                                 compressor=compressor, link_model=link_model)

    gen = torch.Generator(device=device).manual_seed(0)
    params = api.init(gen, device)
    params = tree_map(
        lambda x: x.unsqueeze(0).expand((n_pods,) + x.shape).contiguous(),
        params)
    v = tree_map(torch.zeros_like, params)
    w = torch.ones((n_pods,), dtype=torch.float32, device=device)
    comp = init_pod_comp_state(compressor, params)
    link = init_pod_link_state(mixer, link_model, params)

    def place(params, v, w, comp, link):
        """This rank's pods of the whole state, placed (as it is without a
        mesh)."""
        if rows is None:
            return params, v, w, comp, link
        return (place_pods(api, params, mesh), place_pods(api, v, mesh),
                rows.rows(w), _rows_of(comp, rows.rows),
                _link_rows(link, rows.rows))

    def whole(params, v, w, comp, link):
        """The whole state from every rank's pods (on every rank)."""
        if rows is None:
            return params, v, w, comp, link
        return (gather_pods(params, mesh, n_pods),
                gather_pods(v, mesh, n_pods), rows.all_gather(w),
                _rows_of(comp, rows.all_gather),
                _link_rows(link, rows.all_gather))
    # Directed pod ring, k_max = 2: neighbor-list form once the pod count
    # clears the device's density rule, dense below it.
    P_pod = (pod_mixing_neighbors(n_pods, device)
             if kops.use_sparse_gossip(n_pods, 2, device)
             else pod_mixing_matrix(n_pods, device))
    toks = make_lm_stream(
        cfg.vocab_size, args.seq,
        args.rounds * n_pods * args.local_steps * args.batch)
    toks = toks.reshape(args.rounds, n_pods, args.local_steps, args.batch,
                        args.seq)

    start = 0
    if args.resume and args.ckpt_dir:
        path = checkpoint.latest_checkpoint(args.ckpt_dir)
        if path is not None:
            like = {"params": params, "v": v, "w": w,
                    "round": np.zeros((), np.int32)}
            if compressor.stateful:
                like["comp"] = comp
            if link != ():
                like["link"] = link
            restored = checkpoint.restore(path, like=like)
            params, v, w = restored["params"], restored["v"], restored["w"]
            comp = restored.get("comp", comp)
            link = restored.get("link", link)
            start = int(restored["round"]) + 1
            say(f"[train] resumed {path} at round {start} "
                f"(momentum bank restored)")
    params, v, w, comp, link = place(params, v, w, comp, link)

    where = (f"on {device}" if mesh is None else
             f"x {dict(zip(mesh.mesh_dim_names, mesh.shape))} on {device}")
    say(f"[train] {cfg.name} | {n_pods} pods {where} | "
        f"K={args.local_steps} rho={args.rho} alpha={args.alpha} "
        f"superstep={args.superstep}")

    def on_mesh():
        return (shlib.use_mesh(mesh, fsdp=cfg.fsdp) if mesh is not None
                else contextlib.nullcontext())

    def mass(w, link):
        if rows is None:
            return _mass(w, link)
        inflight = (rows.all_gather(link.bufw, 1).sum()
                    if link != () and not isinstance(link.bufw, tuple)
                    else 0.0)
        return rows.all_gather(w).sum() + inflight
    history = []
    r = start
    while r < args.rounds:
        length = min(max(args.superstep, 1), args.rounds - r)
        t0 = time.time()
        ms = []
        for i in range(length):
            batch = {"tokens": toks[r + i].to(device)}
            if rows is not None:  # this rank's blocks of its pods' rows
                batch = place_batch({k: rows.rows(x)
                                     for k, x in batch.items()}, mesh, 2)
            with on_mesh():
                params, v, w, comp, link, m = round_step(
                    params, v, w, comp, link, batch, P_pod)
            ms.append((m, mass(w, link)))
            if args.superstep <= 1:
                _sync(device)
        _sync(device)
        dt = (time.time() - t0) / length
        for i, (m, wm) in enumerate(ms):
            rec = {"round": r + i, "loss": float(m["loss"]),
                   "acc": float(m["acc"]), "w_mass": float(wm), "dt": dt}
            comm = (f" comm={float(m['comm_fraction']):.2f}"
                    if "comm_fraction" in m else "")
            say(f"[train] round {r + i:4d} loss={rec['loss']:.4f} "
                f"acc={rec['acc']:.4f} w_mass={rec['w_mass']:.4f}{comm} "
                f"dt={dt:.2f}s", flush=True)
            history.append(rec)
            if on_round is not None:
                on_round(r + i, rec)
        ckpt_due = (args.ckpt_dir is not None if args.superstep > 1
                    else args.ckpt_dir and (r + 1) % 5 == 0)
        r += length
        if ckpt_due:
            # Full round state: momentum, round index, and any compressor
            # residual or link carry, so restarts stay warm; gathered whole
            # under a mesh (every rank takes part), written by rank 0.
            wp, wv, ww, wc, wl = whole(params, v, w, comp, link)
            tree = {"params": wp, "v": wv, "w": ww,
                    "round": np.int32(r - 1)}
            if compressor.stateful:
                tree["comp"] = wc
            if link != ():
                tree["link"] = wl
            if lead:
                checkpoint.save(args.ckpt_dir, r - 1, tree)
            del wp, wv, tree
    # Exact mass conservation, in-flight shares included.
    total = float(mass(w, link))
    if abs(total - n_pods) >= 1e-3:
        raise RuntimeError(f"push-sum mass {total} is not {n_pods}")
    return {"history": history, "params": params, "v": v, "w": w,
            "comp": comp, "link": link, "api": api,
            "round_step": round_step, "tokens": toks, "P_pod": P_pod,
            "mesh": mesh}


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.paged:
        return _paged_main(args)
    from repro_torch.configs.registry import get_config

    return run(get_config(args.arch, smoke=args.smoke), args)


if __name__ == "__main__":
    main()
