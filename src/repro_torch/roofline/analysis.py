"""Roofline terms of the dry-run's records — the port of
``repro.roofline.analysis``.

Three terms per (arch x shape x mesh), all in seconds:

  compute    = FLOPs_per_device / peak_FLOP/s (bf16, the tensor cores)
  memory     = bytes_per_device / HBM_bw
  collective = collective_bytes_per_device / link_bw

against ``repro_torch.launch.mesh.HARDWARE`` (the H100 SXM).  The FLOPs and
bytes come from the step's counted cost (``repro_torch.roofline.cost``).

The port has no HLO to parse, so :class:`CollectiveStats` (the reference's
class: bytes and counts by kind, all-reduce weighted 2x) is derived from
the placement and the port's own plan by the rules below, each a function:
:func:`fsdp_collectives`, :func:`tensor_parallel_collectives`,
:func:`vocab_parallel_collectives`, :func:`head_dim_collectives`,
:func:`replicated_block_collectives`, :func:`data_parallel_collectives`,
:func:`step_scalar_collectives`, :func:`expert_collectives`,
:func:`mlstm_collectives`, :func:`slstm_collectives`,
:func:`ssm_collectives`, :func:`prefix_collectives`,
:func:`projector_collectives`, :func:`decode_attention_collectives` and
:func:`pod_collectives`.  They are the traffic of the pod runtime
(``launch.steps.make_round_step`` over DTensors, ``launch.sharding``), and
``tests/test_torch_pod_runtime.py`` (a dense GQA decoder) and
``tests/test_torch_pod_families.py`` (xlstm, hymba and the MoE's expert
rule) hold them to the bytes and counts that runtime issues in an 8-rank
world, and ``tests/test_torch_dryrun_placed.py`` to rank 0's trace on the
production meshes (``launch.dryrun.trace_placed``) for every arch.  Bytes
are per device and, as the reference's parser counts them, the size of
each collective's output on one device (the
gathered block of an all-gather, the kept shard of a reduce-scatter, the
operand of an all-reduce or all-to-all, the sent block of a permute).
"""
from __future__ import annotations

from dataclasses import dataclass, field

from repro_torch.launch.mesh import HARDWARE

__all__ = ["CollectiveStats", "roofline_terms", "model_flops",
           "fsdp_collectives", "tensor_parallel_collectives",
           "vocab_parallel_collectives", "head_dim_collectives",
           "replicated_block_collectives", "data_parallel_collectives",
           "step_scalar_collectives", "expert_collectives",
           "decode_attention_collectives", "pod_collectives"]


@dataclass
class CollectiveStats:
    bytes_by_kind: dict = field(default_factory=dict)
    count_by_kind: dict = field(default_factory=dict)

    @property
    def total_bytes(self) -> int:
        return sum(self.bytes_by_kind.values())

    @property
    def weighted_bytes(self) -> int:
        """all-reduce moves ~2x its operand bytes on a ring."""
        return sum(
            b * (2 if k == "all-reduce" else 1)
            for k, b in self.bytes_by_kind.items()
        )

    def add(self, kind: str, n_bytes: int, count: int = 1) -> None:
        if count:
            self.bytes_by_kind[kind] = self.bytes_by_kind.get(kind, 0) + n_bytes
            self.count_by_kind[kind] = self.count_by_kind.get(kind, 0) + count


def fsdp_collectives(stats: CollectiveStats, blocks: list, data_n: int,
                     kind: str, passes: int) -> None:
    """FSDP.  ``blocks`` holds one device's block (bytes) of each parameter
    that the placement puts on the ``data`` axis (size ``data_n``), a
    layer's slice of a layer-stacked leaf counted as its own (the runtime
    gathers a layer at a time; a tied embedding table twice: the lookup and
    the head).  Each is all-gathered once in every forward (the gathered
    block is ``data_n`` times the device's, and the backward reuses it); in
    ``train`` its gradient, a partial sum over the batch shards, is
    reduce-scattered back to the block in every gradient pass.  ``passes``
    counts the gradient passes (forward-only kinds run one forward)."""
    for block in blocks:
        if kind == "train":
            stats.add("all-gather", passes * data_n * block, passes)
            stats.add("reduce-scatter", passes * block, passes)
        else:
            stats.add("all-gather", data_n * block)


def tensor_parallel_collectives(stats: CollectiveStats, layers: int,
                                act_bytes: int, kind: str,
                                passes: int) -> None:
    """Tensor parallelism.  ``layers`` counts the (layer, sub-block) pairs
    whose leaves sit on the ``model`` axis (a layer's attention, its MLP
    or experts, hymba's SSM branch, xlstm's blocks); each ends in one
    all-reduce of its output, the device's activations (local batch x S x
    d_model, ``act_bytes``).  In ``train`` every gradient pass runs it
    forward and backward (twice as many): the activation constraint holds
    for the gradient, whose partial sum is reduced there."""
    n = layers * (2 * passes if kind == "train" else 1)
    stats.add("all-reduce", n * act_bytes, n)


def vocab_parallel_collectives(stats: CollectiveStats, embed_on_model: bool,
                               head_on_model: bool, act_bytes: int,
                               logits_bytes: int, kind: str,
                               passes: int) -> None:
    """The vocabulary on the ``model`` axis.  A table placed there is looked
    up vocab-parallel: each device's rows, then one all-reduce of the
    looked-up activations (``act_bytes``) in every forward; in ``train``
    the gradient arriving there, a partial sum over ``model`` (the head's
    and the column-parallel projections' input gradients, summed on the way
    down by the sub-blocks' all-reduces), is all-reduced once more in every
    gradient pass.  A head placed there leaves the logits split by
    vocabulary; in ``train`` the loss gathers them (one all-gather,
    ``logits_bytes`` the gathered logits: local batch x S x padded
    vocabulary) in every gradient pass."""
    n = passes if kind == "train" else 1
    if embed_on_model:
        stats.add("all-reduce", n * act_bytes, n)
        if kind == "train":
            stats.add("all-reduce", passes * act_bytes, passes)
    if head_on_model and kind == "train":
        stats.add("all-gather", passes * logits_bytes, passes)


def head_dim_collectives(stats: CollectiveStats, layers: int, q_bytes: int,
                         kv_bytes: int, model_n: int, kind: str,
                         passes: int) -> None:
    """GQA attention whose heads do not divide the ``model`` axis (size
    ``model_n``), placed on its head_dim instead (``models.attention``).
    Where the query heads do not divide it (``q_bytes``, the device's
    whole q: local batch x positions x heads x head_dim, model dtype; 0
    where they divide), q, k and v are gathered there (``kv_bytes`` each
    of k and v) in every forward, every device runs every head, and the
    output projection takes the device's head_dim block of the output; in
    ``train`` the output's gradient is gathered back (one all-gather of
    ``q_bytes``) in every gradient pass, and q, k and v's come back as
    slices.  Where only the kv heads do not divide it, k and v are
    gathered in every forward, and in ``train`` their gradients, partial
    sums over the devices' query heads, are reduce-scattered back in
    every gradient pass.  ``layers`` counts the attention layers."""
    n = layers * (passes if kind == "train" else 1)
    if q_bytes:
        stats.add("all-gather", n * (q_bytes + 2 * kv_bytes), 3 * n)
        if kind == "train":
            stats.add("all-gather", n * q_bytes, n)
    elif kv_bytes:
        stats.add("all-gather", n * 2 * kv_bytes, 2 * n)
        if kind == "train":
            stats.add("reduce-scatter", n * 2 * kv_bytes // model_n, 2 * n)


def replicated_block_collectives(stats: CollectiveStats, layers: int,
                                 core_bytes: int, kind: str,
                                 passes: int) -> None:
    """A layer's sub-block with nothing on the ``model`` axis in a stack
    whose other sub-blocks are there (MLA whose heads do not divide it):
    every device runs it alike, so it adds no collective to the forward.
    In ``train`` its output's gradient arrives as a partial sum over
    ``model`` (the column-parallel input gradients of the layers above):
    the output projection's weight gradient is then partial too (the
    data-parallel rule's ``model_blocks``), and the gradient entering its
    core (``core_bytes``: local batch x positions x heads x value width)
    is all-reduced once in every gradient pass, whole from there down."""
    if kind == "train":
        stats.add("all-reduce", layers * passes * core_bytes,
                  layers * passes)


def data_parallel_collectives(stats: CollectiveStats, data_blocks: list,
                              model_blocks: list, passes: int) -> None:
    """The gradients of parameters that the shards read whole, in every
    gradient pass.  With the batch split on ``data``, each parameter
    replicated there (``data_blocks``: its device block, bytes) has its
    gradient, a partial sum over the batch shards, all-reduced over
    ``data``; each parameter replicated on ``model`` while the activations
    it scales are split there (a norm scale: ``model_blocks``) is
    all-reduced over ``model`` too."""
    for block in list(data_blocks) + list(model_blocks):
        stats.add("all-reduce", passes * block, passes)


def step_scalar_collectives(stats: CollectiveStats, steps: int,
                            norm_axes: int, metric_axes: int,
                            masked_passes: int = 0) -> None:
    """Per local step, 4-byte all-reduces: SAM's gradient norm, summed over
    every shard of the replica (one over each of ``norm_axes``, the
    submesh's axes above 1; 0 without SAM), and the step's loss and
    accuracy, means over the batch shards (one each over each of
    ``metric_axes``); and, in each of ``masked_passes`` gradient passes of
    a masked loss, the count of its masked positions over the batch shards
    (one over each of ``metric_axes``)."""
    n = steps * (norm_axes + 2 * metric_axes) + masked_passes * metric_axes
    stats.add("all-reduce", 4 * n, n)


def expert_collectives(stats: CollectiveStats, moe_layers: int,
                       n_experts: int, kind: str, passes: int,
                       split: bool) -> None:
    """Expert parallelism.  The tokens are replicated on ``model`` (the batch
    rows are on ``data``), so each device routes all of its tokens, fills
    its own experts' slots and combines their outputs: a partial sum over
    the experts, summed by the sub-block's tensor-parallel all-reduce
    (:func:`tensor_parallel_collectives`) — no all-to-all.  The aux
    load-balance loss is a mean over the whole batch: where the batch is
    split on ``data`` (``split``), each MoE layer averages its devices' 2 x
    ``n_experts`` f32 means (routed fractions, mean probabilities) with one
    all-reduce in every forward (every gradient pass in ``train``; the
    backward needs none)."""
    n = moe_layers * (passes if kind == "train" else 1) if split else 0
    stats.add("all-reduce", n * 2 * n_experts * 4, n)


def mlstm_collectives(stats: CollectiveStats, blocks: int, rows: int,
                      inner: int, heads: int, model_n: int, itemsize: int,
                      kind: str, passes: int) -> None:
    """xLSTM's mLSTM blocks with their columns on ``model`` (``model_n``
    above 1).  Each gathers its up-projection's ``rows x 2 inner`` columns
    (model dtype) so that every device holds its heads' q, k and v inputs
    and z, and all-reduces its input and forget gates (``rows x 2 heads``
    f32, a partial sum over the row-split ``w_if``) in every forward; in
    ``train`` the backward all-reduces the gates' gradient and
    reduce-scatters the up-projection's (``rows x 2 inner / model_n``) in
    every gradient pass.  Where the ``heads`` do not divide ``model_n``, a
    device's columns are part of a head: ``wq``, ``wk`` and ``wv`` (``inner
    x inner`` each) are gathered too in every forward, and in ``train``
    their gradients, partial sums over the devices that share a head, are
    reduce-scattered back in every gradient pass.  A ``decode`` step (one
    token a row, the recurrent state whole on every device of ``model``)
    gathers the token's q, k and v instead (``3 x rows x inner``, one
    all-gather).  The block's output all-reduce is the tensor-parallel
    rule's."""
    if model_n == 1:
        return
    n = passes if kind == "train" else 1
    stats.add("all-gather", n * blocks * rows * 2 * inner * itemsize,
              n * blocks)
    stats.add("all-reduce", n * blocks * rows * 2 * heads * 4, n * blocks)
    if heads % model_n and kind == "decode":
        stats.add("all-gather", blocks * 3 * rows * inner * itemsize, blocks)
    elif heads % model_n:
        stats.add("all-gather", n * blocks * 3 * inner * inner * itemsize,
                  3 * n * blocks)
    if kind == "train":
        stats.add("all-reduce", n * blocks * rows * 2 * heads * 4, n * blocks)
        stats.add("reduce-scatter",
                  n * blocks * rows * 2 * inner // model_n * itemsize,
                  n * blocks)
        if heads % model_n:
            stats.add("reduce-scatter",
                      n * blocks * 3 * inner * inner // model_n * itemsize,
                      3 * n * blocks)


def slstm_collectives(stats: CollectiveStats, blocks: int, rows: int,
                      d_model: int, heads: int, model_n: int, itemsize: int,
                      kind: str, passes: int) -> None:
    """xLSTM's sLSTM blocks (``rows`` positions of ``d_model`` a device) with
    their input projection's columns on ``model``.  Where the ``heads``
    divide ``model_n``, each device runs its heads' recurrence and the
    heads' outputs are gathered before the residual (one all-gather of the
    activations, model dtype) in every forward; in ``train`` their
    gradient is reduce-scattered back in every gradient pass.  Where they
    do not, a head's recurrence would need a collective every position:
    the input projection (``rows x 4 d_model``, f32) is gathered and every
    device runs every head in every forward, and in ``train`` the heads'
    output gradient, a partial sum over ``model`` (``rows x d_model``,
    f32), is all-reduced in every gradient pass.  The post-FFN's
    all-reduce is the tensor-parallel rule's."""
    if model_n == 1:
        return
    n = passes if kind == "train" else 1
    if heads % model_n:
        stats.add("all-gather", n * blocks * rows * 4 * d_model * 4,
                  n * blocks)
        if kind == "train":
            stats.add("all-reduce", n * blocks * rows * d_model * 4,
                      n * blocks)
        return
    act_bytes = rows * d_model * itemsize
    stats.add("all-gather", n * blocks * act_bytes, n * blocks)
    if kind == "train":
        stats.add("reduce-scatter", n * blocks * act_bytes // model_n,
                  n * blocks)


def ssm_collectives(stats: CollectiveStats, layers: int, rows: int,
                    inner: int, state: int, model_n: int, itemsize: int,
                    kind: str, passes: int) -> None:
    """hymba's SSM branch with its ``inner`` channels on ``model``.  In every
    forward a layer gathers its up-projection's ``rows x 2 inner`` columns
    (model dtype), reduce-scatters dt (``rows x inner`` f32 partial sums to
    each device's channels) and all-reduces B and C (``rows x 2 state``
    f32); in ``train`` the backward all-reduces B and C's gradient,
    gathers dt's (``rows x inner`` f32) and reduce-scatters the
    up-projection's (``rows x 2 inner / model_n``) in every gradient pass.
    The branch's output all-reduce is the tensor-parallel rule's."""
    if model_n == 1:
        return
    n = passes if kind == "train" else 1
    stats.add("all-gather", n * layers * rows * 2 * inner * itemsize,
              n * layers)
    stats.add("reduce-scatter", n * layers * rows * inner // model_n * 4,
              n * layers)
    stats.add("all-reduce", n * layers * rows * 2 * state * 4, n * layers)
    if kind == "train":
        stats.add("all-reduce", n * layers * rows * 2 * state * 4,
                  n * layers)
        stats.add("all-gather", n * layers * rows * inner * 4, n * layers)
        stats.add("reduce-scatter",
                  n * layers * rows * 2 * inner // model_n * itemsize,
                  n * layers)


def projector_collectives(stats: CollectiveStats, image_bytes: int,
                          kind: str, passes: int) -> None:
    """The vlm's projector with its second weight's columns on ``model``:
    the image rows (``image_bytes`` of activations a device) are gathered
    before they join the text in every forward; in ``train`` the backward
    all-reduces their gradient there and the projector hidden's (the same
    size), a partial sum over the second weight's columns, in every
    gradient pass."""
    n = passes if kind == "train" else 1
    stats.add("all-gather", n * image_bytes, n)
    if kind == "train":
        stats.add("all-reduce", 2 * n * image_bytes, 2 * n)


def prefix_collectives(stats: CollectiveStats, prefix_bytes: int,
                       model_n: int, kind: str, passes: int) -> None:
    """Learned rows put before the sequence (hymba's meta tokens,
    ``prefix_bytes`` of activations a device): in ``train`` their input
    gradient, a partial sum over ``model`` as the text rows' is, is
    all-reduced where they join the sequence in every gradient pass; the
    prefix's parameter, whole on every device of ``model``, then needs no
    all-reduce there."""
    if model_n > 1 and kind == "train" and prefix_bytes:
        stats.add("all-reduce", passes * prefix_bytes, passes)


def decode_attention_collectives(stats: CollectiveStats, layers: int,
                                 score_bytes: int, q_bytes: int,
                                 combine_bytes: tuple = (0, 0)) -> None:
    """One decode step's attention against a placed cache, in each of
    ``layers`` attention layers (``models.attention``'s placed decode).
    With the cache's head_dim on ``model``, each device's partial scores
    over its columns (``score_bytes``: local batch x heads x its positions,
    f32) are all-reduced there; where the query heads sit on ``model``
    besides, the token's q is gathered whole there to be cut into the
    cache's head_dim columns, and the output likewise back into heads (two
    all-gathers of ``q_bytes``: local batch x heads x head_dim, model
    dtype).  With the cache's positions on ``data`` (a
    batch that does not divide it), the softmax is combined over the
    devices: one all-reduce of the row maxima and one of the row sums with
    the P V numerators (``combine_bytes``: their f32 bytes on a device)."""
    if score_bytes:
        stats.add("all-reduce", layers * score_bytes, layers)
    if q_bytes:
        stats.add("all-gather", 2 * layers * q_bytes, 2 * layers)
    if combine_bytes[0]:
        stats.add("all-reduce", layers * sum(combine_bytes), 2 * layers)


def pod_collectives(stats: CollectiveStats, plan, d: int, itemsize: int,
                    gathers: list = (), halo: bool = False) -> None:
    """Pod gossip in the multi-pod round step.  Each replica's columns are
    gathered to whole rows first (``gathers``: the output bytes of each
    all-gather, one for each mesh axis a leaf sits on).  Then one mix of
    the ``(n_pods, D)`` replica bank over the pod ring's ``CommPlan``
    (``plan``, ``launch.steps.pod_comm_plan(n_pods, pod axis size)``): the
    all-gather form receives the whole bank (``n_pods x D x itemsize``);
    the halo form (``halo``: ``gossip="halo"`` on a pod axis above 1) ships
    ``plan.halo_bytes`` instead, one point-to-point leg a ``ShiftLeg``.
    The push-sum weights and the round's loss and accuracy are gathered
    over the pods too (three all-gathers of ``n_pods`` f32).  A pod axis
    of one rank exchanges nothing: its rows are the whole bank."""
    for out in gathers:
        stats.add("all-gather", out)
    if plan.n_shards == 1:
        return
    n_pods = plan.n_shards * plan.m
    if halo and plan.n_shards > 1:
        stats.add("collective-permute", plan.halo_bytes(d, itemsize),
                  len(plan.legs))
    else:
        stats.add("all-gather", n_pods * d * itemsize)
    stats.add("all-gather", 3 * n_pods * 4, 3)


def roofline_terms(cost: dict, coll: CollectiveStats, hw=None) -> dict:
    hw = hw or HARDWARE
    flops = float(cost.get("flops", 0.0) or 0.0)
    bytes_accessed = float(cost.get("bytes accessed", 0.0) or 0.0)
    t_compute = flops / hw["peak_flops_bf16"]
    t_memory = bytes_accessed / hw["hbm_bw"]
    t_coll = coll.weighted_bytes / hw["link_bw"]
    terms = {
        "flops_per_device": flops,
        "bytes_per_device": bytes_accessed,
        "collective_bytes_per_device": coll.weighted_bytes,
        "t_compute_s": t_compute,
        "t_memory_s": t_memory,
        "t_collective_s": t_coll,
    }
    dominant = max(
        ("compute", t_compute), ("memory", t_memory), ("collective", t_coll),
        key=lambda kv: kv[1],
    )[0]
    terms["bottleneck"] = dominant
    return terms


def model_flops(n_params_active: int, n_tokens: int, kind: str = "train") -> float:
    """6ND for training, 2ND for a forward/decode pass."""
    mult = 6.0 if kind == "train" else 2.0
    return mult * n_params_active * n_tokens
