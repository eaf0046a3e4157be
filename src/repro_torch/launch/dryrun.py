"""Dry-run: the cost of every (arch x input shape x mesh), counted on the meta
device — the port of ``repro.launch.dryrun``.

  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh card,single,multi
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma3-12b \\
      --shape train_4k --mesh card
  PYTHONPATH=src python -m repro_torch.launch.dryrun \\
      --arch xlstm-350m,glm4-9b --shape train_4k,prefill_32k \\
      --mesh single,multi --set n_layers=2

The reference lowers and compiles each step for the TPU production mesh on
``ShapeDtypeStruct`` stand-ins.  Here the stand-ins are meta tensors (shapes
and dtypes, no memory), and the port's own step functions run on them once
under ``repro_torch.roofline.cost.CostMode``, which counts every operator
and every hand-written kernel's record: the train step
(``launch.steps.make_train_step``), the pods-as-clients round step over the
``pod`` axis (``make_round_step``, the ``multi`` mesh's train record),
``forward`` (prefill) and the serve step (decode).  The port runs eagerly
and counts every layer, so it traces once: the reference's second lowering
and its extrapolation over the layer loop's trip count are not needed.
``compile_s`` is a trace's time.

Meshes:

- ``card``: one H100, nothing placed; the whole step's cost
  (``"per_device": "whole step"``; ``chip_smoke.py`` phase 19 checks it
  on the card).
- ``single`` and ``multi``: the reference's production meshes (16 x 16 and
  2 x 16 x 16, ``launch.mesh.make_production_mesh``).  Every record is
  rank 0's own step, as the reference counts one device's sharded program
  (``"per_device": "rank 0"``, :func:`trace_placed`): a
  ``launch.mesh.fake_world`` of 256 or 512 ranks is started in this
  process, the pod runtime's own placement code places the step's
  arguments over it (:func:`placed_step_args`: the replica over the pod's
  ``(data, model)`` submesh by ``place_params`` / ``place_pods`` with
  ``launch.sharding.model_axes_for``, the experts on "model", the batch
  by ``place_batch``, its rows on ``("pod", "data")`` as
  ``launch.sharding.pod_spec`` puts them, a serving cache by
  ``launch.sharding.place_cache``), and the step runs on meta under
  ``CostMode``: its FLOPs, bytes, temporaries, peak and the collectives
  DTensor and the pod gossip run are that rank's, the work the runtime
  replicates included (kv heads and heads that do not divide "model",
  norms, the mLSTM's and the SSM's gathered up-projections, the tokens
  around the experts, the gathered logits).  A
  ``decode`` record is the serve step on rank 0's blocks of the cache
  (``launch.sharding.cache_spec``: kv heads, else head_dim, or an SSM
  state's channels on "model"; the batch on "data", else, as
  ``long_500k``'s batch of 1, the positions), its attention summing
  partial scores over "model" and combining the softmax over "data"
  (``models.attention``).  The world is destroyed after the trace; one
  that fails to start, or a step that raises, is an error record.  The
  argument bytes a device holds, from ``launch.sharding.spec_for`` of
  every parameter, cache and batch leaf, are exact, and a rank-0 trace
  must hold exactly those (the serve step's ``pos`` aside, a host int).
  :func:`collectives` (the rules of ``roofline.analysis``) is held equal
  to the rank-0 traces' by the tests.

Traces are cached by (arch, shape, step, mesh), the mesh ``None`` for the
``card``'s whole step.

Records take the reference's keys, against the H100's constants
(``launch.mesh.HARDWARE``); those that cannot run are marked ``skip`` as in
the reference, and a trace that raises is written with ``status: "error"``
and its traceback (the CLI then exits non-zero).  No card is needed.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import json
import math
import os
import sys
import time
import traceback

import torch

from repro_torch.configs.base import INPUT_SHAPES, InputShape
from repro_torch.configs.registry import (
    ARCH_IDS,
    get_config,
    input_specs,
    make_batch,
)
from repro_torch.launch import sharding as shlib
from repro_torch.launch.mesh import HARDWARE, make_production_mesh
from repro_torch.launch.steps import (
    StepConfig,
    make_round_step,
    make_serve_step,
    make_train_step,
    pod_comm_plan,
    pod_mixing_matrix,
)
from repro_torch.models.pdefs import (
    _map_sorted,
    abstract_tree,
    init_tree,
    tree_num_params,
)
from repro_torch.models.registry import get_model_api
from repro_torch.roofline.analysis import (
    CollectiveStats,
    data_parallel_collectives,
    decode_attention_collectives,
    expert_collectives,
    fsdp_collectives,
    head_dim_collectives,
    mlstm_collectives,
    model_flops,
    pod_collectives,
    prefix_collectives,
    projector_collectives,
    replicated_block_collectives,
    roofline_terms,
    slstm_collectives,
    ssm_collectives,
    step_scalar_collectives,
    tensor_parallel_collectives,
    vocab_parallel_collectives,
)
from repro_torch.roofline.cost import CostMode

__all__ = ["MESHES", "collectives", "param_counts", "placed_step_args",
           "run_one", "step_args", "step_model_flops", "trace",
           "trace_placed", "main"]

DEFAULT_OUT = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                           "experiments", "dryrun_torch")
MESHES = ("card", "single", "multi")
N_PODS = make_production_mesh(multi_pod=True).shape["pod"]  # the round's pods


def _skip_reason(cfg, shape) -> str | None:
    if shape.kind == "decode":
        if not cfg.supports_decode():
            return "encoder-only architecture: no autoregressive decode"
        if shape.name == "long_500k" and not cfg.supports_long_context():
            return "pure full-attention arch: long_500k needs sub-quadratic decode"
    return None


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], prefix + (k,))
    else:
        yield prefix, tree


# -- placement on a production mesh -------------------------------------------
# Each returns {path: (shape, dtype, spec)} for one argument of the step, as
# the reference places it.

def _abstract_params(api, mesh, multi_pod: bool, replicate_pods: bool) -> dict:
    n_pods = mesh.shape.get("pod", 1)
    maxes = shlib.model_axes_for(api.cfg)
    out = {}
    for path, d in _leaves(api.param_defs()):
        spec = shlib.spec_for(d, mesh, fsdp=api.cfg.fsdp, model_axes=maxes)
        if multi_pod and not replicate_pods:  # a leading replica axis
            out[path] = ((n_pods,) + d.shape, d.dtype, ("pod",) + spec)
        else:
            out[path] = (d.shape, d.dtype, spec)
    return out


def _abstract_batch(cfg, shape, mesh, multi_pod: bool, stacked: bool) -> dict:
    """The train / prefill batch; for the multi-pod round stacked as
    (n_pods, K=1, local_batch, ...)."""
    n_pods = mesh.shape.get("pod", 1)
    out = {}
    for name, t in input_specs(cfg, shape).items():
        sh = tuple(t.shape)
        spec = ("data" if sh[0] % 16 == 0 else None,) + (None,) * (len(sh) - 1)
        if multi_pod and stacked:
            local = (sh[0] // n_pods,) + sh[1:]
            out[(name,)] = ((n_pods, 1) + local, t.dtype,
                            ("pod", None, "data" if local[0] % 16 == 0
                             else None) + (None,) * (len(sh) - 1))
        elif multi_pod:
            out[(name,)] = (sh, t.dtype,
                            shlib.pod_spec(spec, (0,), sh, n_pods))
        else:
            out[(name,)] = (sh, t.dtype, spec)
    return out


def _abstract_cache(api, mesh, batch: int, length: int) -> dict:
    """The serving cache, each leaf by ``launch.sharding.cache_spec`` (the
    batch widened over the pods where ``mesh`` has them): the placement the
    pod runtime's ``place_cache`` and prefill give it."""
    return {path: (d.shape, d.dtype, shlib.cache_spec(d, mesh, api.cfg))
            for path, d in _leaves(api.cache_defs(batch, length))}


def _placed_args(api, shape, mesh, multi: bool) -> list:
    """Every argument of the step the reference lowers for this
    combination, each as {path: (shape, dtype, spec)}."""
    cfg = api.cfg
    f32 = torch.float32
    if shape.kind == "train" and multi:
        n_pods = mesh.shape["pod"]
        params = _abstract_params(api, mesh, True, replicate_pods=False)
        return [params, params, {(): ((n_pods,), f32, ("pod",))},
                _abstract_batch(cfg, shape, mesh, True, stacked=True),
                {(): ((n_pods, n_pods), f32, ())}]
    if shape.kind == "train":
        params = _abstract_params(api, mesh, False, False)
        return [params, params, {(): ((), f32, ())},
                _abstract_batch(cfg, shape, mesh, False, stacked=False)]
    params = _abstract_params(api, mesh, multi, replicate_pods=True)
    if shape.kind == "prefill":
        return [params, _abstract_batch(cfg, shape, mesh, multi,
                                        stacked=False)]
    b = shape.global_batch
    toks = shlib.pod_spec(("data" if b % 16 == 0 else None,), (0,), (b,),
                          mesh.shape.get("pod", 1))
    return [params, _abstract_cache(api, mesh, b, shape.seq_len),
            {(): ((b,), torch.int32, toks)}, {(): ((), torch.int32, ())}]


def _device_bytes(args: list, mesh) -> int:
    """Bytes one device holds of the placed arguments."""
    return sum(math.prod(shlib.shard_shape(sh, spec, mesh))
               * torch.empty((), dtype=dt).element_size()
               for arg in args for sh, dt, spec in arg.values())


# -- the collectives of a placement -------------------------------------------

def _blocks(defs: dict) -> list:
    """The layers' sub-blocks, as (path prefix, layer count): the children
    of a layer-stacked ``layers`` tree (attention, MLP or experts, hymba's
    SSM), else the top-level trees of layer-stacked leaves (xlstm's mLSTM
    and sLSTM blocks)."""
    root, base = (defs["layers"], ("layers",)) if "layers" in defs else (
        defs, ())
    out = []
    for name in sorted(root):
        if not isinstance(root[name], dict):
            continue
        d = next(leaf for _, leaf in _leaves(root[name]))
        n = math.prod(s for s, a in zip(d.shape, d.axes) if a == "layers")
        if "layers" in d.axes:
            out.append((base + (name,), n))
    return out


def collectives(api, mesh, kind: str, local_batch: int, seq: int,
                passes: int, steps: int = 1, n_pods: int = 0,
                batch_on_data: bool = True,
                gossip: str = "auto", cache: dict = None) -> CollectiveStats:
    """The collectives one device of ``mesh`` issues (``roofline.analysis``'s
    rules) in a step of ``kind`` with ``local_batch`` rows of ``seq``
    positions on the device: ``train`` runs ``steps`` local steps of
    ``passes`` gradient passes (SAM: 2) for each pod the device holds, and
    with ``n_pods`` (the multi-pod round over the mesh's ``"pod"`` axis) the
    round's gossip under ``gossip``; other kinds one forward.
    ``batch_on_data``: the batch rows are split on ``"data"`` (then the
    gradients and metrics are partial sums there).  A ``decode`` step (one
    token a row, ``seq`` 1) reads its attention's placement from ``cache``
    (the placed cache, ``_abstract_cache``'s {path: (shape, dtype,
    spec)})."""
    cfg = api.cfg
    stats = CollectiveStats()
    params = _abstract_params(api, mesh, False, False)  # one replica
    defs = dict(_leaves(api.param_defs()))
    data_n = mesh.shape.get("data", 1)
    model_n = mesh.shape.get("model", 1)
    pod_n = mesh.shape.get("pod", 1)
    local_pods = n_pods // pod_n if n_pods else 1
    train = kind == "train"
    grad_passes = passes * steps * local_pods if train else 1
    itemsize = torch.empty((), dtype=cfg.dtype).element_size()

    def block(sh, dt, spec):
        return (math.prod(shlib.shard_shape(sh, spec, mesh))
                * torch.empty((), dtype=dt).element_size())

    # FSDP: every leaf placed on "data", a layer's slice at a time
    blocks = []
    for path, (sh, dt, spec) in params.items():
        if "data" in spec:
            n = math.prod(s for s, a in zip(sh, defs[path].axes)
                          if a == "layers")
            uses = 2 if path == ("embed",) and cfg.tie_embeddings else 1
            blocks += [block(sh, dt, spec) // n] * (n * uses)
    fsdp_collectives(stats, blocks, data_n, kind, grad_passes)
    # The device's positions: the layers run hymba's meta tokens before the
    # text; the vlm's text follows its image rows (both are in a decode
    # step's cache, not in its one position).
    decode = kind == "decode"
    prefix = cfg.n_meta_tokens if cfg.block_kind == "hymba" and not decode \
        else 0
    text = (seq - min(cfg.n_frontend_tokens, max(seq // 2, 1))
            if cfg.task == "vlm" and not decode else seq)
    # the device's activations: local batch x positions x d_model
    row_bytes = local_batch * cfg.d_model * itemsize
    act = (seq + prefix) * row_bytes
    on_model = [(path, n) for path, n in _blocks(api.param_defs())
                if any("model" in spec for p, (_, _, spec) in params.items()
                       if p[:len(path)] == path)]
    tensor_parallel_collectives(stats, sum(n for _, n in on_model), act,
                                kind, grad_passes)

    def vocab_on_model(path):
        return path in params and "model" in params[path][2]

    vocab_parallel_collectives(
        stats, vocab_on_model(("embed",)),
        vocab_on_model(("embed",) if cfg.tie_embeddings else ("lm_head",)),
        text * row_bytes, local_batch * seq * cfg.padded_vocab * itemsize,
        kind, grad_passes)
    prefix_collectives(stats, prefix * row_bytes, model_n, kind, grad_passes)
    # The parameters whose gradient arrives whole on "model" (made whole at
    # the prefix's join or the projector's hidden, or computed alike by
    # every device).
    whole = {("meta_tokens",)} if prefix else set()
    # GQA heads that do not divide "model": q, or k and v, gathered there.
    for path, n in on_model:
        wq, wk = defs.get(path + ("wq",)), defs.get(path + ("wk",))
        if wq is None or wk is None or "head_dim" not in wq.axes:
            continue

        def gathered(name):
            d = defs[path + (name,)]
            if params[path + (name,)][2][d.axes.index("head_dim")] != "model":
                return 0
            return ((seq + prefix) * local_batch * math.prod(d.shape[-2:])
                    * itemsize)

        q_bytes = gathered("wq")
        head_dim_collectives(stats, n, q_bytes, gathered("wk"), model_n,
                             kind, grad_passes)
        if q_bytes:  # every device runs every head: whole qk-norm grads
            whole |= {path + ("q_norm",), path + ("k_norm",)}
    if decode:
        _decode_attention(stats, api, mesh, params, cache, local_batch,
                          itemsize)
    if (cfg.task == "vlm" and not decode
            and vocab_on_model(("projector", "w2"))):
        projector_collectives(stats, (seq - text) * row_bytes, kind,
                              grad_passes)
        whole.add(("projector", "w1"))
    split = batch_on_data and data_n > 1
    expert_collectives(stats, cfg.n_layers if cfg.n_experts else 0,
                       cfg.n_experts, kind, grad_passes, split)
    if cfg.block_kind == "xlstm":
        if cfg.n_heads % model_n:  # every sLSTM rank runs every head
            whole |= {("slstm", "r"), ("slstm", "b")}
        blocks = dict(_blocks(api.param_defs()))
        inner = 2 * cfg.d_model  # the mLSTM's up-projection factor 2
        mlstm_collectives(stats, blocks.get(("mlstm",), 0), local_batch * seq,
                          inner, cfg.n_heads, model_n, itemsize, kind,
                          grad_passes)
        slstm_collectives(stats, blocks.get(("slstm",), 0),
                          local_batch * seq, cfg.d_model, cfg.n_heads,
                          model_n, itemsize, kind, grad_passes)
    if cfg.block_kind == "hymba":
        ssm_collectives(stats, cfg.n_layers, local_batch * (seq + prefix),
                        cfg.ssm_expand * cfg.d_model, cfg.ssm_state, model_n,
                        itemsize, kind, grad_passes)
    # A layer's attention with nothing on "model" (MLA's 4 heads on 16)
    # beside sub-blocks that are: every device runs it alike, and its
    # output's gradient arrives as a partial sum over "model".
    off_model = [(path, n) for path, n in _blocks(api.param_defs())
                 if path[-1] == "attn" and on_model
                 and (path, n) not in on_model]
    for path, n in off_model:
        wo = defs[path + ("wo",)]
        replicated_block_collectives(
            stats, n, (seq + prefix) * local_batch
            * math.prod(wo.shape[-3:-1]) * itemsize, kind, grad_passes)
        # its weights' gradients are whole there but the output
        # projection's, and so is its input norm's
        whole |= {p for p in params if p[:len(path)] == path
                  and p[-1] != "wo"} | {path[:-1] + ("ln1",)}
    if not train:
        return stats
    data_parallel_collectives(
        stats,
        [block(*v) for v in params.values() if split and "data" not in v[2]],
        [block(*v) for path, v in params.items()
         if model_n > 1 and on_model and "model" not in v[2]
         and path not in whole],
        grad_passes)
    axes = sum(1 for n in (data_n, model_n) if n > 1)
    step_scalar_collectives(stats, steps * local_pods,
                            axes if passes > 1 else 0, 1 if split else 0,
                            grad_passes if cfg.task == "masked_lm" else 0)
    if n_pods:
        # each replica's columns gathered (the model axis first), then the
        # bank's mix in the promoted dtype (launch.steps._row_spec)
        gathers = []
        for sh, dt, spec in params.values():
            out = local_pods * block(sh, dt, spec)
            for axis, size in (("model", model_n), ("data", data_n)):
                if axis in spec:
                    out *= size
                    gathers.append(out)
        dt = functools.reduce(torch.promote_types,
                              (d.dtype for d in defs.values()))
        pod_collectives(stats, pod_comm_plan(n_pods, pod_n),
                        tree_num_params(api.param_defs()),
                        torch.empty((), dtype=dt).element_size(), gathers,
                        halo=gossip == "halo")
    return stats


def _decode_attention(stats, api, mesh, params: dict, cache: dict,
                      rows: int, itemsize: int) -> None:
    """:func:`decode_attention_collectives` of one decode step from the
    placement of its cache (``cache``) and of its query projection
    (``params``): ``rows`` requests on the device."""
    cfg = api.cfg
    data_n = mesh.shape.get("data", 1)
    model_n = mesh.shape.get("model", 1)
    key = ("ckv",) if cfg.attn_type == "mla" else ("k",)
    if key not in cache:  # xlstm: a recurrent state, no attention
        return
    shape, _, spec = cache[key]  # (layers, batch, positions, ...)
    length = shape[2]
    spec = tuple(spec[1:]) + (None,) * (len(shape) - len(spec))
    h = cfg.n_heads
    seq_split = spec[1] == "data"
    s_loc = length // data_n if seq_split else length
    if cfg.attn_type == "mla":
        wq = params[("layers", "attn", "wq_b")][2]
        h_loc = h // model_n if wq[2] == "model" else h
        width = cfg.v_head_dim
        score = q_bytes = 0
    else:
        hd = cfg.resolved_head_dim
        hd_split, kv_split = spec[3] == "model", spec[2] == "model"
        wq = params[("layers", "attn", "wq")][2]
        q_heads = wq[2] == "model"
        h_loc = h // model_n if kv_split or (q_heads and not hd_split) else h
        width = hd // model_n if hd_split else hd
        score = rows * h * s_loc * 4 if hd_split else 0
        q_bytes = rows * h * hd * itemsize if hd_split and q_heads else 0
    combine = ((rows * h_loc * 4, rows * h_loc * (width + 1) * 4)
               if seq_split else (0, 0))
    decode_attention_collectives(stats, cfg.n_layers, score, q_bytes,
                                 combine)


def _collectives(api, shape, mesh, multi: bool, placed: list,
                 passes: int) -> CollectiveStats:
    """:func:`collectives` for the step whose arguments ``_placed_args``
    placed (``placed``): its local batch, local steps (the round's batch is
    (n_pods, K, local batch, ...)) and batch placement read from there."""
    kind = shape.kind
    if kind == "decode":  # the tokens are the third argument
        sh, _, spec = placed[2][()]
        local, seq, lead = shlib.shard_shape(sh, spec, mesh)[0], 1, 0
    else:
        sh, _, spec = next(iter(placed[3 if kind == "train" else 1].values()))
        lead = 2 if kind == "train" and multi else 0
        local, seq = shlib.shard_shape(sh, spec, mesh)[lead], shape.seq_len
    multi_round = kind == "train" and multi
    return collectives(api, mesh, kind, local, seq, passes,
                       steps=sh[1] if multi_round else 1,
                       n_pods=mesh.shape["pod"] if multi_round else 0,
                       batch_on_data=spec[lead] in ("data", ("pod", "data")),
                       cache=placed[1] if kind == "decode" else None)


# -- the trace ------------------------------------------------------------------

def _step_name(shape, multi: bool) -> str:
    if shape.kind == "train":
        return "round_step" if multi else "train_step"
    return "forward" if shape.kind == "prefill" else "serve_step"


def trace(api, shape, step: str, step_cfg=None) -> dict:
    """Run one step of ``api``'s model at ``shape`` on meta tensors (no
    memory) under a ``CostMode`` (see :func:`step_args`), and return its
    ``result()`` with the trace's time (``compile_s``)."""
    args, run = step_args(api, shape, step, step_cfg)
    t0 = time.perf_counter()
    with CostMode(args) as mode:
        out = run(*args)
    rec = mode.result(out)
    rec["compile_s"] = round(time.perf_counter() - t0, 1)
    return rec


def step_args(api, shape, step: str, step_cfg=None, device="meta",
              seed: int | None = None):
    """(arguments, function) of one step of ``api``'s model at ``shape``:
    ``"train_step"`` (params, momentum, the push-sum weight and the
    batch), ``"round_step"`` (``N_PODS`` replicas stacked on a leading
    axis, the batch split among them into ``step_cfg.local_steps``
    batches each, the pod ring's dense ``P_pod``),
    ``"forward"`` (params and batch) or ``"serve_step"`` (one token a
    request against a cache of ``shape.seq_len`` positions, at the last).
    Without ``seed`` the arguments are empty tensors on ``device``; with
    one, parameters drawn from it (``init_tree``), batches from
    ``make_batch``, zero momentum and caches, unit weights: what the card
    runs."""
    cfg = api.cfg
    step_cfg = step_cfg or StepConfig()
    defs = api.param_defs()
    real = seed is not None
    gen = torch.Generator(device=device).manual_seed(seed) if real else None

    def tree(d, lead=()):
        if lead:
            d = _map_sorted(lambda p: p._replace(shape=lead + p.shape,
                                          axes=(None,) * len(lead) + p.axes,
                                          fan_in=p.fan_in or (
                                              p.shape[-2] if len(p.shape) > 1
                                              else p.shape[-1])), d)
        return init_tree(gen, d, device) if real else abstract_tree(d, device)

    def zeros(t):
        return _map_sorted(torch.zeros_like if real else (lambda x: x), t)

    def batch_of(b, s):
        if real:
            return make_batch(cfg, b, s, seed=seed, device=device)
        return input_specs(cfg, InputShape(shape.name, s, b, shape.kind),
                           device)

    empty = torch.ones if real else torch.empty
    if step == "round_step":
        n_pods, k = N_PODS, step_cfg.local_steps
        params = tree(defs, (n_pods,))
        v = zeros(tree(defs, (n_pods,)))
        w = empty((n_pods,), device=device)
        batch = {key: x.reshape((n_pods, k, x.shape[0] // (n_pods * k))
                                + tuple(x.shape[1:]))
                 for key, x in batch_of(shape.global_batch,
                                        shape.seq_len).items()}
        P = pod_mixing_matrix(n_pods, device=device)
        fn = make_round_step(api, step_cfg)
        return (params, v, w, (), (), batch, P), fn
    params = tree(defs)
    if step == "train_step":
        v = zeros(tree(defs))
        w = empty((), device=device)
        batch = batch_of(shape.global_batch, shape.seq_len)
        return (params, v, w, batch), make_train_step(api, step_cfg)
    if step == "forward":
        return (params, batch_of(shape.global_batch, shape.seq_len)), api.forward
    b = shape.global_batch
    cache = zeros(tree(api.cache_defs(b, shape.seq_len)))
    toks = (make_batch(cfg, b, 1, seed=seed, device=device)["tokens"][:, 0]
            .contiguous() if real
            else torch.empty((b,), dtype=torch.int32, device=device))
    serve = make_serve_step(api)
    return (params, cache, toks), lambda p, c, t: serve(p, c, t,
                                                        shape.seq_len - 1)


# -- one rank's own step, placed as the pod runtime places it -----------------

def placed_step_args(api, shape, step: str, mesh, step_cfg=None,
                     device="meta", seed: int | None = None):
    """(arguments, function) of this rank's own step on the live pod-runtime
    mesh ``mesh`` (``("data", "model")`` or ``("pod", "data", "model")``;
    a :func:`launch.mesh.fake_world`'s, or a real one's): :func:`step_args`'
    whole arguments placed by the pod runtime's own code.

    - ``"train_step"``: ``make_train_step`` on the replica placed over the
      submesh (``launch.sharding.place_params`` with
      ``launch.sharding.model_axes_for``, the experts on "model"), the
      batch's rows on "data" (``launch.steps.place_batch``);
    - ``"round_step"``: ``make_round_step`` over the "pod" axis on this
      rank's pods of ``N_PODS`` (``launch.steps.place_pods``), their
      batches (``step_cfg.local_steps`` a pod) placed as ``launch.train``
      places them, and the dense pod ring ``P_pod``;
    - ``"forward"``: ``forward`` on the replica over the submesh (every pod
      holds it whole) and this rank's pod's rows of the batch (on
      ``("pod", "data")`` where they divide,
      ``launch.sharding.pod_spec``), placed as the train step's;
    - ``"serve_step"``: the serve step on the replica placed as
      ``"forward"``'s, the cache placed by ``launch.sharding.place_cache``
      (``cache_spec``: kv heads, head_dim or an SSM state's channels on
      "model", the batch on "data", else a long cache's positions; the
      pod's rows where the batch is on ``("pod", "data")``), the tokens as
      the forward's batch, ``pos`` a plain int.

    Without ``seed`` the arguments are empty tensors on ``device`` (on meta
    the whole ones cost nothing); with one, drawn as :func:`step_args`
    draws them, and the whole tensors freed once placed."""
    from repro_torch.launch.steps import place_batch, place_pods, pod_rows

    cfg = api.cfg
    step_cfg = step_cfg or StepConfig()
    maxes = shlib.model_axes_for(cfg)
    args, fn = step_args(api, shape, step, step_cfg, device, seed)
    if step == "round_step":
        p, v, w, comp, link, batch, P = args
        rows = pod_rows(mesh, N_PODS)
        w = rows.rows(w)
        batch = place_batch({k: rows.rows(x) for k, x in batch.items()},
                            mesh, 2)
        p, v = (place_pods(api, t, mesh, maxes) for t in (p, v))
        return (p, v, w, comp, link, batch, P), _on_mesh(fn, mesh, cfg.fsdp,
                                                         implicit=False)
    size = dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))
    pod_n, b = size.get("pod", 1), shape.global_batch
    pods = (pod_rows(mesh, pod_n)
            if pod_n > 1 and b % (size.get("data", 1) * pod_n) == 0 else None)

    def pod_batch(x):  # this pod's rows
        if pods is None:
            return x
        return pods.rows(x.reshape((pod_n, -1) + tuple(x.shape[1:])))[0]

    def place(t):
        return shlib.place_params(t, api.param_defs(), mesh, cfg.fsdp,
                                  model_axes=maxes)

    if step == "serve_step":
        p, cache, toks = args
        toks = place_batch({"tokens": pod_batch(toks)}, mesh, 0)["tokens"]
        return ((place(p), shlib.place_cache(cache, api.cache_defs(
            shape.global_batch, shape.seq_len), mesh, cfg), toks),
            _on_mesh(fn, mesh, cfg.fsdp))
    batch = place_batch({k: pod_batch(x) for k, x in args[-1].items()}, mesh,
                        0)
    if step == "forward":
        return (place(args[0]), batch), _on_mesh(fn, mesh, cfg.fsdp)
    p, v, w, _ = args

    def train(*a):  # the metrics made whole, as the round's pods do
        new_p, new_v, metrics = fn(*a)
        return new_p, new_v, {k: shlib.full_tensor(x)
                              for k, x in metrics.items()}

    return (place(p), place(v), w, batch), _on_mesh(train, mesh, cfg.fsdp)


def _on_mesh(fn, mesh, fsdp: bool, implicit: bool = True):
    """``fn`` under the pod runtime's ``mesh``; a pod's step takes its plain
    tensors (the push-sum weight, positions) as replicated, as the round
    runs it."""
    from torch.distributed.tensor.experimental import implicit_replication

    def run(*args):
        with shlib.use_mesh(mesh, fsdp=fsdp), (
                implicit_replication() if implicit
                else contextlib.nullcontext()):
            return fn(*args)

    return run


def trace_placed(api, shape, step: str, mesh, step_cfg=None) -> dict:
    """:func:`trace` of rank 0's own step on ``mesh`` (an
    :class:`~repro_torch.launch.mesh.AbstractMesh`): a
    :func:`launch.mesh.fake_world` of the mesh's size is started, the step
    placed on it by :func:`placed_step_args` on meta and counted under a
    ``CostMode`` — rank 0's FLOPs, bytes, memory, kernel records and
    collectives — and the world destroyed."""
    from repro_torch.launch.mesh import fake_world

    dims = tuple(mesh.shape[a] for a in mesh.axis_names)
    with fake_world(dims, mesh.axis_names, "meta") as dmesh:
        args, run = placed_step_args(api, shape, step, dmesh, step_cfg)
        t0 = time.perf_counter()
        with CostMode(args) as mode:
            out = run(*args)
        rec = mode.result(out)
        del args, out
    rec["compile_s"] = round(time.perf_counter() - t0, 1)
    return rec


def param_counts(api) -> tuple[int, int]:
    """(parameters, parameters active a token): a MoE layer's inactive
    experts (``n_experts - top_k`` of ``3 d_model d_ff`` each) left out."""
    cfg = api.cfg
    n_params = tree_num_params(api.param_defs())
    if cfg.n_experts:
        per_layer = 3 * cfg.d_model * cfg.d_ff
        return n_params, n_params - cfg.n_layers * (
            cfg.n_experts - cfg.top_k) * per_layer
    return n_params, n_params


def step_model_flops(active: int, shape) -> float:
    """6ND for a train shape, 2ND for a forward or decode step, over the
    shape's tokens (one a request for decode)."""
    tokens = shape.global_batch * (1 if shape.kind == "decode" else shape.seq_len)
    return model_flops(active, tokens,
                       "train" if shape.kind == "train" else "fwd")


def run_one(arch: str, shape, mesh_kind: str, step_cfg=None,
            overrides: dict = None, smoke: bool = False,
            traces: dict = None) -> dict:
    """One record: ``arch`` (reduced with ``smoke``) at ``shape`` (an
    ``INPUT_SHAPES`` name or an ``InputShape``) on ``mesh_kind`` (``card``,
    ``single`` or ``multi``).  Every record on a production mesh is rank 0's
    own step (:func:`trace_placed`, ``"per_device": "rank 0"``), its
    argument bytes held to the placement's (``pos`` aside: the port's serve
    step takes it as a host int); the ``card`` record is the whole step.
    ``traces`` caches the traces by (arch, shape, step, mesh: ``None`` for
    the card's whole step) across calls."""
    base_cfg = get_config(arch, smoke=smoke)
    if overrides:
        base_cfg = dataclasses.replace(base_cfg, **overrides)
    shape = INPUT_SHAPES[shape] if isinstance(shape, str) else shape
    rec = {"arch": arch, "shape": shape.name, "mesh": mesh_kind,
           "kind": shape.kind, "status": "ok"}
    reason = _skip_reason(base_cfg, shape)
    if reason:
        rec.update(status="skip", reason=reason)
        return rec
    if mesh_kind not in MESHES:
        raise ValueError(f"unknown mesh {mesh_kind!r}; choose from {MESHES}")
    step_cfg = step_cfg or StepConfig()
    cfg = base_cfg
    api = get_model_api(cfg)
    multi = mesh_kind == "multi"
    step = _step_name(shape, multi)
    traces = {} if traces is None else traces
    key = (arch, shape, step, None if mesh_kind == "card" else mesh_kind)
    if mesh_kind == "card":
        n_chips = 1
    else:
        mesh = make_production_mesh(multi_pod=multi)
        n_chips = mesh.size
        placed = _placed_args(api, shape, mesh, multi)
    if key not in traces:
        traces[key] = (trace(api, shape, step, step_cfg) if mesh_kind == "card"
                       else trace_placed(api, shape, step, mesh, step_cfg))
    cost = traces[key]
    mem = dict(cost["memory"])
    if mesh_kind == "card":
        coll = CollectiveStats()
    else:
        coll = CollectiveStats(dict(cost["collectives"]["bytes"]),
                               dict(cost["collectives"]["count"]))
        # The port's serve step takes pos as a host int, not a device scalar.
        want = _device_bytes(placed, mesh) - (4 if shape.kind == "decode"
                                              else 0)
        if mem["argument"] != want:
            raise RuntimeError(
                f"rank 0 holds {mem['argument']} bytes of arguments; their "
                f"placement gives {want}")
    terms = roofline_terms({"flops": cost["flops"],
                            "bytes accessed": cost["bytes accessed"]}, coll)

    n_params, active = param_counts(api)
    mf = step_model_flops(active, shape)
    total = terms["flops_per_device"] * n_chips
    rec.update(
        compile_s=cost["compile_s"],
        step=step,
        n_chips=n_chips,
        n_params=n_params,
        n_params_active=active,
        bytes_per_device=mem,
        per_device="whole step" if mesh_kind == "card" else "rank 0",
        roofline=terms,
        collectives={"bytes": coll.bytes_by_kind, "count": coll.count_by_kind},
        model_flops=mf,
        useful_flops_ratio=(mf / total) if total else None,
        cost={k: cost[k] for k in ("flops", "bytes accessed", "aten_flops",
                                   "aten_bytes", "aten_ops")},
        kernels=cost["kernels"],
        hbm_bytes=HARDWARE["hbm_bytes"],
    )
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, help="arch id or comma list")
    ap.add_argument("--shape", default=None, help="shape name or comma list")
    ap.add_argument("--mesh", default="single,multi")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=os.environ.get("DRYRUN_OUT", DEFAULT_OUT))
    ap.add_argument("--set", default=None, dest="overrides",
                    help="cfg overrides for perf variants, e.g. "
                         "attn_fallback=replicate,fsdp=false")
    ap.add_argument("--tag", default=None, help="suffix for variant records")
    args = ap.parse_args(argv)

    overrides = {}
    step_overrides = {}
    if args.overrides:
        for kv in args.overrides.split(","):
            k, v = kv.split("=")
            if v.lower() in ("true", "false"):
                v = v.lower() == "true"
            elif v.replace(".", "", 1).isdigit():
                v = float(v) if "." in v else int(v)
            if k in ("microbatches", "lr", "alpha", "rho", "local_steps"):
                step_overrides[k] = v
            else:
                overrides[k] = v
    step_cfg = StepConfig(**step_overrides) if step_overrides else None

    archs = list(ARCH_IDS) if (args.all or not args.arch) else args.arch.split(",")
    shapes = (list(INPUT_SHAPES) if (args.all or not args.shape)
              else args.shape.split(","))
    meshes = args.mesh.split(",")
    os.makedirs(args.out, exist_ok=True)

    errors = 0
    for arch in archs:
        for shape in shapes:
            traces = {}  # the meshes of one (arch, shape) share its traces
            for mesh_kind in meshes:
                tag = f"{arch}__{shape}__{mesh_kind}"
                if args.tag:
                    tag += f"__{args.tag}"
                path = os.path.join(args.out, tag + ".json")
                if os.path.exists(path):
                    print(f"[dryrun] {tag}: cached", flush=True)
                    continue
                print(f"[dryrun] {tag}: tracing...", flush=True)
                try:
                    rec = run_one(arch, shape, mesh_kind, step_cfg=step_cfg,
                                  overrides=overrides or None, traces=traces)
                except Exception as e:  # record failures — they are bugs
                    rec = {"arch": arch, "shape": shape, "mesh": mesh_kind,
                           "variant": args.tag,
                           "status": "error", "error": f"{type(e).__name__}: {e}",
                           "traceback": traceback.format_exc()[-2000:]}
                if args.tag:
                    rec["variant"] = args.tag
                    rec["overrides"] = {**overrides, **step_overrides}
                with open(path, "w") as f:
                    json.dump(rec, f, indent=1)
                status = rec["status"]
                extra = ""
                if status == "ok":
                    r = rec["roofline"]
                    extra = (f" bottleneck={r['bottleneck']}"
                             f" tc={r['t_compute_s']:.3e}"
                             f" tm={r['t_memory_s']:.3e}"
                             f" tx={r['t_collective_s']:.3e}"
                             f" trace={rec['compile_s']}s")
                elif status == "error":
                    errors += 1
                    extra = " " + rec["error"][:160]
                print(f"[dryrun] {tag}: {status}{extra}", flush=True)
    return 1 if errors else 0


if __name__ == "__main__":
    sys.exit(main())
