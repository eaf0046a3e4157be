"""Step functions of the launchers — the port of ``repro.launch.steps``.

  train_step  — one paper-faithful DFedSGPSM inner iteration (de-bias by the
                push-sum weight, SAM two-pass gradient, local momentum,
                descent) for a single client (= pod).
  round_step  — multi-pod: every pod runs its K local steps on its own
                replica, then the directed column-stochastic push-sum gossip
                mixes replicas and weights across pods (one
                ``stages.comm_phase``, as the flat-bank round program).
  serve_step  — one-token decode against the KV cache, and the personalized
                serving step over the client bank.  On a placed replica
                and cache (``launch.sharding.place_params``,
                ``place_cache``; the requests by :func:`place_batch`)
                under ``sharding.use_mesh`` it reads and writes each rank's
                blocks of the cache.

The reference shards each replica over its pod's (data, model) submesh and
vmaps the local steps over a "pod" mesh axis.  Here the pods' replicas are
stacked on a leading axis of every leaf, and a loop runs a rank's pods one
after another.  Without a mesh every pod is on the one device.  Under the
pod runtime's mesh (``launch.sharding.use_mesh`` of a ``("pod", "data",
"model")`` mesh, ``launch.mesh.make_host_mesh``) each rank holds the rows
of its pod-axis coordinate (``launch.sharding.RowShard`` over "pod"), each
replica placed over the pod's (data, model) submesh as DTensors
(:func:`place_pods`), and the gossip crosses the pod axis.  The gradients
are taken with ``torch.autograd``
(:func:`repro_torch.core.sam.sam_gradient_autograd`): the decoders' flash
attention has a hand-written CUDA backward, which ``torch.func`` cannot
call.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, NamedTuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.comm.plan import HaloBackend
from repro_torch.core import topology
from repro_torch.core.flat import (
    BoundDeltaSpec,
    make_spec,
    tree_flatten,
    tree_map,
)
from repro_torch.core.sam import (
    apply_update,
    momentum_update,
    sam_gradient_autograd,
)
from repro_torch.launch import sharding as shlib
from repro_torch.models.registry import ModelApi

__all__ = ["StepConfig", "make_train_step", "make_round_step",
           "make_serve_step", "PersonalizedServe",
           "make_personalized_serve_step", "pod_mixing_matrix",
           "pod_mixing_neighbors", "pod_comm_plan", "resolve_compressor",
           "init_pod_comp_state", "resolve_pod_link", "resolve_pod_mixer",
           "init_pod_link_state", "place_pods", "place_batch", "gather_pods",
           "pod_rows"]


@dataclasses.dataclass(frozen=True)
class StepConfig:
    """Local-optimizer hyperparameters for the pod runtime (Algorithm 1)."""

    lr: float = 1e-2
    alpha: float = 0.9  # local momentum
    rho: float = 0.05  # SAM radius (0 disables the second grad pass)
    local_steps: int = 1  # K inner iterations per communication round
    # Gradient-accumulation microbatches per step: the loss is evaluated
    # chunk by chunk, each chunk under torch.utils.checkpoint, so the live
    # activation set is one chunk.
    microbatches: int = 1
    # Communication stage for the pod gossip — a ``repro_torch.core.stages``
    # COMPRESSORS name.  Stateful stages (topk_ef) carry their residual bank
    # through the round as the ``comp`` carry, as ``FLState.comp`` does.
    compressor: str = "identity"
    topk_ratio: float = 0.05  # kept fraction per row (topk_ef)
    # Unreliable pod interconnect (``repro_torch.core.topology.LinkModel``):
    # per-round link drops on the pod graph, bounded delivery delays
    # (in-flight buffers ride the ``link`` carry), or event-triggered
    # transmission.  All zero = perfect links.
    link_drop: float = 0.0
    link_delay: int = 0
    event_threshold: float = 0.0


def _microbatched_loss(loss_fn, n_micro: int):
    """Evaluate ``loss_fn`` over ``n_micro`` equal batch chunks, each under
    ``torch.utils.checkpoint`` (the reference's checkpointed scan).  The
    ``(ce, acc)`` aux is summed alongside the loss, so microbatched runs
    report the whole batch's metrics (equal chunks make the mean of chunk
    means the batch mean)."""

    def loss(params, batch):
        chunks = {k: x.reshape((n_micro, x.shape[0] // n_micro) + x.shape[1:])
                  for k, x in batch.items()}
        dev = next(iter(batch.values())).device
        total = ce = acc = torch.zeros((), dtype=torch.float32, device=dev)
        for i in range(n_micro):
            chunk = {k: x[i] for k, x in chunks.items()}
            l, (c, a) = checkpoint(loss_fn, params, chunk, use_reentrant=False)
            total, ce, acc = total + l, ce + c, acc + a
        return total / n_micro, (ce / n_micro, acc / n_micro)

    return loss


def pod_mixing_matrix(n_pods: int, device=None) -> torch.Tensor:
    """Directed-ring column-stochastic mixing over pods: each pod sends to
    its successor and keeps a self-loop (out-degree 2 -> weights 1/2)."""
    eye = torch.eye(n_pods, dtype=torch.float32, device=device)
    ring = torch.roll(eye, 1, dims=0)
    return 0.5 * (eye + ring) if n_pods > 1 else eye


def pod_mixing_neighbors(n_pods: int, device=None) -> topology.NeighborList:
    """:func:`pod_mixing_matrix` in neighbor-list form — the O(n_pods * D)
    representation for rings wide enough to clear the density rule
    (``repro_torch.kernels.ops.use_sparse_gossip``); ``round_step`` accepts
    either for ``P_pod``."""
    if n_pods == 1:
        return topology.NeighborList(
            torch.zeros((1, 1), dtype=torch.int32, device=device),
            torch.ones((1, 1), dtype=torch.float32, device=device))
    return topology.neighbors_ring(n_pods, device=device)


def resolve_compressor(step_cfg: StepConfig):
    """``step_cfg.compressor`` -> the ``repro_torch.core.stages`` stage."""
    from repro_torch.core.stages import COMPRESSORS

    try:
        return COMPRESSORS[step_cfg.compressor](step_cfg)
    except KeyError:
        raise ValueError(
            f"unknown compressor stage {step_cfg.compressor!r}; "
            f"choose from {sorted(COMPRESSORS)}"
        ) from None


def _n_pods(params) -> int:
    return tree_flatten(params)[1][0].shape[0]


def _row_spec(params):
    """The bank spec of one pod's replica (leaf dtypes promoted, as the
    reference's ``make_spec``: bf16 weights with f32 norms give an f32
    bank)."""
    return make_spec(tree_map(lambda x: x[0], params))


def init_pod_comp_state(compressor, params):
    """Initial compressor carry for the pod round: the ``(n_pods, D)``
    residual bank for stateful stages, ``()`` for stateless ones."""
    if not compressor.stateful:
        return ()
    device = tree_flatten(params)[1][0].device
    return compressor.init_state(_n_pods(params), _row_spec(params).dim,
                                 device)


def resolve_pod_link(step_cfg: StepConfig):
    """``step_cfg``'s link fields -> a ``topology.LinkModel`` or ``None``
    (perfect links)."""
    model = topology.LinkModel(drop=step_cfg.link_drop,
                               delay=step_cfg.link_delay,
                               event_threshold=step_cfg.event_threshold)
    return model if model.active else None


def resolve_pod_mixer(step_cfg: StepConfig, link_model=None):
    """The pod mixer for a link scenario: delayed / event-triggered
    push-sum when the model asks for it, plain push-sum otherwise."""
    from repro_torch.core.stages import (
        DelayedPushSumMixer,
        EventTriggeredMixer,
        PushSumMixer,
    )

    if link_model is None:
        link_model = resolve_pod_link(step_cfg)
    if link_model is not None and link_model.delay:
        return DelayedPushSumMixer(delay=link_model.delay)
    if link_model is not None and link_model.event_threshold:
        return EventTriggeredMixer(threshold=link_model.event_threshold)
    return PushSumMixer()


def init_pod_link_state(mixer, link_model, params, seed: int = 0):
    """Initial unreliable-link carry for the pod round (as ``program.init``
    makes it): ``()`` on perfect links, otherwise a ``stages.LinkState``
    with its own generator (seeded from ``seed`` and the link tag, on the
    params' device) and the mixer's payload buffers sized from the
    ``(n_pods, D)`` replica bank."""
    if link_model is None and not getattr(mixer, "link_stateful", False):
        return ()
    from repro_torch.core.program import LINK_STREAM, _fold_generator
    from repro_torch.core.stages import LinkState

    params = tree_map(shlib.full_tensor, params)
    device = tree_flatten(params)[1][0].device
    gen = torch.Generator(device=device).manual_seed(seed)
    bank = _row_spec(params).ravel_stacked(params)
    return LinkState(key=_fold_generator(gen, LINK_STREAM),
                     **mixer.link_buffers(bank))


def make_train_step(api: ModelApi, step_cfg: StepConfig) -> Callable:
    """Single-client local step: (params, v, w, batch) -> (params, v,
    metrics), with ``w`` the pod's push-sum weight (a number or 0-d
    tensor)."""

    loss_fn = (api.loss if step_cfg.microbatches <= 1
               else _microbatched_loss(api.loss, step_cfg.microbatches))

    def train_step(params, v, w, batch):
        z = tree_map(lambda p: (p / w).to(p.dtype), params)  # de-bias
        g, (loss, (_, acc)) = sam_gradient_autograd(loss_fn, z, batch,
                                                    step_cfg.rho)
        del z
        v = momentum_update(v, g, step_cfg.alpha)
        params = apply_update(params, v, step_cfg.lr)
        return params, v, {"loss": loss, "acc": acc}

    return train_step


def pod_comm_plan(n_pods: int, n_shards: int):
    """The pod runtime's :class:`~repro_torch.comm.plan.CommPlan`: the pod
    graph is the directed ring of :func:`pod_mixing_matrix`, so the plan is
    the ring family's static shift plan over the pods."""
    from repro_torch.comm.plan import CommPlan

    return CommPlan.build(
        topology.TopologyConfig(kind="ring", n_clients=n_pods, k_out=1),
        n_shards=n_shards,
    )


def pod_rows(mesh, n_pods: int):
    """The :class:`~repro_torch.launch.sharding.RowShard` of this rank's
    pods on ``mesh``'s "pod" axis (``n_pods`` a multiple of its size: the
    rest are stacked on the rank), or ``None`` without a mesh or without
    that axis."""
    return shlib.bank_row_pins(mesh, "pod", n_pods)


def place_pods(api: ModelApi, stacked, mesh, model_axes: tuple = None):
    """The pod runtime's placement (the reference's ``train.py``): this
    rank's pods of the whole pod-stacked tree ``stacked`` (leading dim
    n_pods, the same on every rank), each replica placed over the pod's
    ("data", "model") submesh by ``spec_for`` (with ``model_axes``) as
    DTensors, every family alike (a mixture's experts on "model")."""
    rows = pod_rows(mesh, _n_pods(stacked))
    local = tree_map(rows.rows, stacked)
    return shlib.place_params(local, api.param_defs(), mesh,
                              fsdp=api.cfg.fsdp, lead=1,
                              model_axes=model_axes)


def gather_pods(tree, mesh, n_pods: int):
    """The whole pod-stacked tree (plain tensors, on every rank) from each
    rank's placed pods: each replica gathered over its submesh, then the
    pods over the pod axis (the inverse of :func:`place_pods`)."""
    rows = pod_rows(mesh, n_pods)
    return tree_map(lambda x: rows.all_gather(shlib.full_tensor(x)), tree)


def _pod_mixer(mixer, gossip: str, mesh, pods, P_pod):
    """The mixer of the round's gossip over the pod axis — the reference's
    dispatch: "halo" on a pod axis above 1 with more than one pod runs the
    pod ring's halo exchange (the neighbor-list ``P_pod`` only), every other
    case the all-gather form over the pod axis.  Without a pod axis, or on
    one of a single rank (``pods`` None: its all-gather form is the bank
    at hand), the mixer as it is."""
    if pods is None:
        return mixer
    backend = "xla" if gossip == "xla" else None
    if gossip == "halo" and pods.n > 1 and pods.world > 1:
        if not isinstance(P_pod, topology.NeighborList):
            raise ValueError(
                "gossip='halo' needs the neighbor-list pod ring "
                "(pod_mixing_neighbors), not a dense P_pod")
        backend = HaloBackend(mesh, "pod", pod_comm_plan(pods.n, pods.world))
    elif gossip == "halo":
        backend = "xla"
    return dataclasses.replace(mixer, backend=backend, shard=pods)


def place_batch(batch: dict, mesh, dim: int = 1) -> dict:
    """Batches over a pod's submesh: the rows (dim ``dim``; a pod's
    (K, B, ...) batches by default, this rank's pods' (m, K, B, ...) with
    2) on "data" where they divide (the reference's ``"batch"`` rule),
    replicated on "model".  A batch placed already (``launch.train``
    places each round's before the round) is taken as it is."""
    from torch.distributed.tensor import Replicate, Shard

    sub = shlib.submesh(mesh)
    out = {}
    for key, x in batch.items():
        if shlib.is_dtensor(x):
            out[key] = x
            continue
        pl = [Shard(dim) if name == "data" and sub.size(i) > 1
              and x.shape[dim] % sub.size(i) == 0 else Replicate()
              for i, name in enumerate(sub.mesh_dim_names)]
        out[key] = shlib.place_tensor(x, sub, pl)
    return out


def make_round_step(
    api: ModelApi,
    step_cfg: StepConfig,
    flat_mix: bool = True,
    mixer=None,
    compressor=None,
    link_model=None,
    gossip: str = "auto",
) -> Callable:
    """Multi-pod DFL round: (stacked params, stacked v, w (n_pods,), comp,
    link, batch (n_pods, K, ...), P_pod, draws=None) -> (params, v, w, comp,
    link, metrics) with the mean loss and accuracy over pods and steps.

    Every leaf carries a leading pod axis.  The round **updates ``params``
    and ``v`` in place** and returns them (the reference donates both): pod
    i runs its K local steps on its own slices, which are written back, and
    the mixed replicas are written back into the same leaves, so a
    full-width replica pair is never held twice.

    The communication step is the same Compressor / Mixer stage pair the
    simulation engine composes (``repro_torch.core.stages``): with
    ``flat_mix`` (default) the replicas are ravelled into an ``(n_pods,
    D)`` bank (the spec's promoted dtype), run through one
    ``stages.comm_phase`` — compression, this round's link drops, then
    ``mixer.mix_round``: the dense mix kernel for a matrix ``P_pod``, the
    gather kernel for a ``NeighborList`` — and unravelled.  ``comp`` is the
    compressor carry (``init_pod_comp_state``), ``link`` the unreliable-link
    carry (``init_pod_link_state``), ``()`` where unused.  ``draws`` may
    inject this round's link uniforms and delays (``{"drop": ..., "delay":
    ...}``), as ``RoundProgram.step`` takes them; otherwise they are drawn
    from ``link.key``.  Without ``flat_mix`` every leaf is mixed by an f32
    product with ``P_pod``.

    Under the pod runtime's mesh (a ``"pod"`` axis in the active mesh,
    ``launch.sharding.use_mesh``), ``params``, ``v``, ``w``, ``comp``,
    ``link`` and ``batch`` are this rank's pods (``pod_rows(mesh,
    n_pods).rows`` of the whole leaves; the replicas placed by
    :func:`place_pods`, the batch here or by :func:`place_batch`), ``P_pod`` is the whole pod graph, and the metrics
    are the means over every pod.  Each replica runs its local steps as
    DTensors over its pod's submesh; the mix gathers each replica's columns
    to full rows (the reference's ``bank_row_pins``: rows on "pod", columns
    gathered), mixes the ``(n_pods, D)`` bank over the pod axis and writes
    each rank's blocks back into its shards.

    ``gossip`` is the executor knob of the reference over the pod axis:
    ``"auto"`` and ``"xla"`` take the all-gather form; ``"halo"`` ships the
    pod ring's halo exchange (``pod_comm_plan`` over the pod axis's process
    group; the neighbor-list ``P_pod`` only, a dense one raises) when the
    pod axis and the pod count are above 1, else the all-gather form.
    Without a mesh the mixer's own kernel runs on the stacked bank, and
    ``"halo"`` runs as ``"auto"``, as the reference's does.
    """
    from repro_torch.core.stages import IdentityCompressor, comm_phase

    local = make_train_step(api, step_cfg)
    if link_model is None:
        link_model = resolve_pod_link(step_cfg)
    mixer = mixer if mixer is not None else resolve_pod_mixer(
        step_cfg, link_model)
    if compressor is None:
        compressor = resolve_compressor(step_cfg)
    linked = link_model is not None or getattr(mixer, "link_stateful", False)
    if gossip not in ("auto", "xla", "halo"):
        raise ValueError(
            f"pod gossip must be auto|xla|halo, got {gossip!r}"
        )
    if gossip == "halo" and mixer.kind != "directed":
        raise ValueError(
            "the pod halo executor ships the directed ring plan; "
            f"mixer kind {mixer.kind!r} has no pod halo form"
        )
    if gossip == "halo" and not flat_mix:
        raise ValueError("gossip='halo' requires flat_mix=True (bank layout)")
    if not flat_mix and not isinstance(compressor, IdentityCompressor):
        raise ValueError("compression requires flat_mix=True (bank layout)")
    if not flat_mix and linked:
        raise ValueError("link scenarios require flat_mix=True (bank layout)")
    if (link_model is not None and mixer.kind != "directed"
            and (link_model.delay or link_model.event_threshold)):
        raise ValueError(
            "delayed / event-triggered mixing is push-sum (directed) only; "
            f"the configured mixer is {mixer.kind!r}"
        )

    def one_pod(params, v, i, w_i, batches):
        """Pod i's K local steps on its slices of the stacked leaves,
        written back in place; -> (mean loss, mean acc)."""
        p = tree_map(lambda x: x[i], params)
        vv = tree_map(lambda x: x[i], v)
        losses, accs = [], []
        for k in range(batches[next(iter(batches))].shape[0]):
            p, vv, m = local(p, vv, w_i, {key: b[k]
                                          for key, b in batches.items()})
            losses.append(shlib.full_tensor(m["loss"]))
            accs.append(shlib.full_tensor(m["acc"]))
        tree_map(lambda x, y: x[i].copy_(y), params, p)
        tree_map(lambda x, y: x[i].copy_(y), v, vv)
        return torch.stack(losses).mean(), torch.stack(accs).mean()

    def mix_flat(params, w, comp, link, P_pod, draws, mesh, mx):
        leaves = tree_flatten(params)[1]
        # Rows on "pod", columns gathered: each replica's whole row.
        full = tree_map(shlib.full_tensor, params)
        spec = _row_spec(full)
        bank = spec.ravel_stacked(full)
        del full
        with (shlib.manual_region(mesh) if isinstance(mx.backend, HaloBackend)
              else contextlib.nullcontext()):
            bank, w, comp, link, extras = comm_phase(
                compressor, mx, P_pod, bank, w, comp, link,
                linked=linked, link_model=link_model,
                symmetric=mixer.kind == "symmetric", draws=draws,
            )
        for o, sz, leaf in zip(spec.offsets, spec.sizes, leaves):
            rows = bank[:, o:o + sz].reshape(leaf.shape)
            if shlib.is_dtensor(leaf):  # back into this rank's blocks
                rows = shlib.place_tensor(rows.to(leaf.dtype), leaf.device_mesh,
                                    leaf.placements).to_local()
                leaf = leaf.to_local()
            leaf.copy_(rows)
        return w, comp, link, extras

    def mix_leafwise(params, w, comp, link, P_pod, draws, mesh, mx):
        if isinstance(P_pod, topology.NeighborList):
            raise ValueError(
                "neighbor-list P_pod requires flat_mix=True (bank layout)")
        Pf = P_pod.float()
        for x in tree_flatten(params)[1]:
            x.copy_((Pf @ x.float().reshape(x.shape[0], -1))
                    .reshape(x.shape).to(x.dtype))
        return mixer.mix_weights(P_pod, w), comp, link, {}

    @torch.no_grad()
    def round_step(params, v, w, comp, link, batch, P_pod, draws=None):
        mesh = shlib.active_mesh()
        n_pods = (P_pod.idx if isinstance(P_pod, topology.NeighborList)
                  else P_pod).shape[0]
        pods = pod_rows(mesh, n_pods)
        if pods is not None and not flat_mix:
            raise ValueError("the pod runtime mixes the flat bank: "
                             "flat_mix=True under a mesh")
        if pods is not None and pods.m != w.shape[0]:
            raise ValueError(
                f"this rank holds {pods.m} of the {n_pods} pods on the pod "
                f"axis; got {w.shape[0]} rows of w")
        # A pod axis of one rank has nothing to exchange: its pods' rows
        # are the whole bank.
        across = pods if pods is not None and pods.world > 1 else None
        mx = _pod_mixer(mixer, gossip, mesh, across, P_pod)
        placed = any(shlib.is_dtensor(x) for x in tree_flatten(params)[1])
        if placed:
            from torch.distributed.tensor.experimental import (
                implicit_replication,
            )

            ctx = implicit_replication()
        else:
            ctx = contextlib.nullcontext()
        stats = []
        with ctx:
            for i in range(w.shape[0]):
                b = {k: x[i] for k, x in batch.items()}
                if placed:
                    b = place_batch(b, mesh)
                stats.append(one_pod(params, v, i, w[i], b))
        loss = torch.stack([s[0] for s in stats])
        acc = torch.stack([s[1] for s in stats])
        if across is not None:  # the means over every pod
            loss, acc = across.all_gather(loss), across.all_gather(acc)
        w, comp, link, extras = (mix_flat if flat_mix else mix_leafwise)(
            params, w, comp, link, P_pod, draws, mesh, mx)
        return params, v, w, comp, link, {
            "loss": loss.mean(), "acc": acc.mean(), **extras}

    return round_step


def make_serve_step(api: ModelApi) -> Callable:
    """(params, cache, tokens (B,), pos) -> (logits, cache); the cache is
    updated in place."""

    def serve_step(params, cache, tokens, pos):
        return api.decode_step(params, cache, tokens, pos)

    return serve_step


class PersonalizedServe(NamedTuple):
    """Batched many-model serving over the client bank (see
    :func:`make_personalized_serve_step`)."""

    expand: Callable       # (bank, w, ids) -> lane-stacked params
    prefill: Callable      # (params_stacked, batch, cache_len) -> (logits, cache)
    decode_step: Callable  # (params_stacked, cache, tokens (B,), pos) -> ...


def make_personalized_serve_step(api: ModelApi, spec) -> PersonalizedServe:
    """Serve many *different* clients' models in one batched decode.

    The bank is a personalization store: request lane ``b`` serves client
    ``ids[b]``, whose model is its bank row de-biased onto the shared
    weights.  ``spec`` is the program's bank spec — a
    :class:`~repro_torch.core.flat.BoundDeltaSpec` expands ``base + (A @
    B) / w`` per leaf over its frozen base, and only the narrow ``(B,
    d_delta)`` rows are gathered per batch; a dense
    :class:`~repro_torch.core.flat.BankSpec` expands ``row / w``.

    ``expand`` runs once per batch and returns the lanes' weights stacked on
    a leading lane axis.  ``prefill`` and ``decode_step`` run the model
    zoo's prefill and decode on those stacked weights with one request per
    lane: one pass over the layers per token serves every lane, the
    projections and the MLP as batched matmuls over the lanes and the
    attention core as the flash kernel's batch.
    """

    def expand(bank, w, ids):
        ids = torch.as_tensor(ids, device=bank.device).long()
        rows = bank[ids]
        wv = (torch.ones(ids.shape, dtype=torch.float32, device=bank.device)
              if w is None else w[ids].float())
        if isinstance(spec, BoundDeltaSpec):
            return spec.debias_stacked(rows, wv)
        stacked = spec.unravel_stacked(rows)
        return tree_map(
            lambda p: p / wv.reshape((-1,) + (1,) * (p.dim() - 1)), stacked)

    def prefill(params_stacked, batch, cache_len):
        return api.prefill(params_stacked, batch, cache_len)

    def decode_step(params_stacked, cache, tokens, pos):
        return api.decode_step(params_stacked, cache, tokens, pos)

    return PersonalizedServe(expand, prefill, decode_step)
