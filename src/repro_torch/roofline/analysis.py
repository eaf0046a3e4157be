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
the placement and the port's own plan by four rules, each a function below:
:func:`fsdp_collectives`, :func:`tensor_parallel_collectives`,
:func:`expert_collectives` and :func:`pod_collectives`.  Bytes are per
device and, as the reference's parser counts them, the size of each
collective's output on one device (the gathered block of an all-gather, the
kept shard of a reduce-scatter, the operand of an all-reduce or
all-to-all).
"""
from __future__ import annotations

from dataclasses import dataclass, field

from repro_torch.launch.mesh import HARDWARE

__all__ = ["CollectiveStats", "roofline_terms", "model_flops",
           "fsdp_collectives", "tensor_parallel_collectives",
           "expert_collectives", "pod_collectives"]


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
    leaf that the placement puts on the ``data`` axis (size ``data_n``).
    Each such leaf is all-gathered once in every forward (the gathered
    block is ``data_n`` times the device's); in ``train`` it is gathered
    again in every backward, and its gradient reduce-scattered (to the
    device's block).  ``passes`` is the step's gradient passes (2 under
    SAM); forward-only kinds run one forward."""
    for block in blocks:
        if kind == "train":
            stats.add("all-gather", 2 * passes * data_n * block, 2 * passes)
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
    forward and backward (twice as many)."""
    n = layers * (2 * passes if kind == "train" else 1)
    stats.add("all-reduce", n * act_bytes, n)


def expert_collectives(stats: CollectiveStats, moe_layers: int,
                       routed_bytes: int, kind: str, passes: int) -> None:
    """Expert dispatch over the ``model`` axis.  Each MoE layer whose
    experts are placed there sends its routed tokens (local tokens x top_k
    x d_model, ``routed_bytes``) to their experts with one all-to-all and
    brings the combined tokens back with another; ``train`` doubles them in
    every gradient pass, as above."""
    n = 2 * moe_layers * (2 * passes if kind == "train" else 1)
    stats.add("all-to-all", n * routed_bytes, n)


def pod_collectives(stats: CollectiveStats, plan, d: int,
                    itemsize: int) -> None:
    """Pod gossip in the multi-pod round step: one mix of the ``(n_pods,
    D)`` replica bank over the pod ring's ``CommPlan`` (``plan``, as
    ``launch.steps.pod_comm_plan(n_pods, n_pods)`` builds it, one pod a
    shard), whose all-gather receives ``plan.allgather_bytes`` a device.
    (The halo executor's ``plan.halo_bytes`` comes with the pod runtime,
    ROADMAP item 13.7: the port's round step refuses ``gossip="halo"``.)"""
    stats.add("all-gather", plan.allgather_bytes(d, itemsize))


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
