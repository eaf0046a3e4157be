"""``repro_torch.launch.dryrun.run_one`` at reduced size for every arch of
the zoo on the ``card``, ``single`` and ``multi`` meshes, at one short shape
of each kind: well-formed records, each device's argument bytes against a
sum from the reference's ``spec_for`` (with its ``_pod_spec`` and
``input_specs``), the collective rules against hand counts, and the CLI and
report end to end.  Exact."""
from __future__ import annotations

import json
import math

import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

from repro.configs.registry import get_config as ref_config
from repro.configs.registry import input_specs as ref_input_specs
from repro.launch import sharding as ref_sharding
from repro.models.registry import get_model_api as ref_api

from _torch_dryrun_ref import (  # noqa: F401  (one_thread is an autouse fixture)
    MESHES,
    leaves,
    one_thread,
    reference_dryrun,
)
from repro_torch.configs.base import InputShape
from repro_torch.configs.registry import ARCH_IDS
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import HARDWARE
from repro_torch.launch.sharding import sharding_for
from repro_torch.models.pdefs import PDef
from repro_torch.roofline import report

SHAPES = {"train": InputShape("train_16", 16, 32, "train"),
          "prefill": InputShape("prefill_16", 16, 32, "prefill"),
          "decode": InputShape("decode_16", 16, 32, "decode")}


@pytest.fixture(scope="module")
def records():
    out = {}
    for arch in ARCH_IDS:
        for kind, shape in SHAPES.items():
            traces = {}
            for mesh in dryrun.MESHES:
                out[arch, kind, mesh] = dryrun.run_one(
                    arch, shape, mesh, smoke=True, traces=traces)
    return out


CASES = [(a, k, m) for a in ARCH_IDS for k in SHAPES for m in dryrun.MESHES]


@pytest.mark.parametrize("arch,kind,mesh", CASES)
def test_records_are_well_formed(records, arch, kind, mesh):
    r = records[arch, kind, mesh]
    assert (r["arch"], r["shape"], r["mesh"], r["kind"]) == (
        arch, SHAPES[kind].name, mesh, kind)
    if arch == "hubert-xlarge" and kind == "decode":
        assert r["status"] == "skip" and "encoder-only" in r["reason"]
        return
    assert r["status"] == "ok"
    assert r["n_chips"] == {"card": 1, "single": 256, "multi": 512}[mesh]
    assert r["step"] == {"train": "round_step" if mesh == "multi"
                         else "train_step", "prefill": "forward",
                         "decode": "serve_step"}[kind]
    assert r["per_device"] == ("whole step" if mesh == "card" else "rank 0")
    b = r["bytes_per_device"]
    assert set(b) == {"argument", "output", "temp", "alias", "peak_estimate"}
    assert b["peak_estimate"] == b["argument"] + b["temp"] > 0
    t = r["roofline"]
    # rank 0's own counts, or the whole step's share
    n = r["n_chips"] if r["per_device"] != "rank 0" else 1
    assert t["flops_per_device"] == r["cost"]["flops"] / n > 0
    assert t["bytes_per_device"] == r["cost"]["bytes accessed"] / n > 0
    assert t["t_compute_s"] == t["flops_per_device"] / HARDWARE["peak_flops_bf16"]
    assert t["t_memory_s"] == t["bytes_per_device"] / HARDWARE["hbm_bw"]
    assert t["bottleneck"] in ("compute", "memory", "collective")
    assert (t["t_collective_s"] == 0) == (mesh == "card")
    assert r["n_params_active"] <= r["n_params"]
    assert r["useful_flops_ratio"] == r["model_flops"] / (
        r["cost"]["flops"] * r["n_chips"] / n)
    assert r["hbm_bytes"] == HARDWARE["hbm_bytes"]
    json.dumps(r)
    uses_flash = arch not in ("deepseek-v3-671b", "xlstm-350m")
    if kind != "decode":
        assert ("flash_attention" in r["kernels"]) == uses_flash
    if kind == "train":
        assert ("flash_attention_backward" in r["kernels"]) == uses_flash
        assert ("gossip_matmul" in r["kernels"]) == (mesh == "multi")


def _ref_placed(arch, shape, mesh_kind) -> list:
    """(shape, itemsize, spec) of every argument leaf of the step the
    reference's dry-run lowers, placed by the reference's ``spec_for``,
    ``_pod_spec`` and ``input_specs`` (``src/repro/launch/dryrun.py``)."""
    ref = reference_dryrun()
    cfg = ref_config(arch, smoke=True)
    api = ref_api(cfg)
    m = MESHES[mesh_kind]
    multi = mesh_kind == "multi"
    n_pods = m.shape.get("pod", 1)
    maxes = ref._model_axes(cfg)
    size = lambda dt: np.dtype(dt).itemsize  # noqa: E731

    def params(stacked):
        out = []
        for _, d in leaves(api.param_defs()):
            spec = tuple(ref_sharding.spec_for(d, m, fsdp=cfg.fsdp,
                                               model_axes=maxes))
            out.append(((n_pods,) + d.shape, size(d.dtype), ("pod",) + spec)
                       if stacked else (d.shape, size(d.dtype), spec))
        return out

    def batch(stacked):
        out = []
        for sds in ref_input_specs(cfg, shape).values():
            sh = tuple(sds.shape)
            spec = ("data" if sh[0] % 16 == 0 else None,) + (None,) * (
                len(sh) - 1)
            if multi and stacked:
                local = (sh[0] // n_pods,) + sh[1:]
                out.append(((n_pods, 1) + local, size(sds.dtype),
                            ("pod", None, "data" if local[0] % 16 == 0
                             else None) + (None,) * (len(sh) - 1)))
            elif multi:
                out.append((sh, size(sds.dtype),
                            tuple(ref._pod_spec(P(*spec), (0,), sh, n_pods))))
            else:
                out.append((sh, size(sds.dtype), spec))
        return out

    if shape.kind == "train" and multi:
        return (2 * params(True) + [((n_pods,), 4, ("pod",))] + batch(True)
                + [((n_pods, n_pods), 4, ())])
    if shape.kind == "train":
        return 2 * params(False) + [((), 4, ())] + batch(False)
    if shape.kind == "prefill":
        return params(False) + batch(False)
    cache = []
    seq_shard = cfg.serve_cache_shard == "seq"
    for _, d in leaves(api.cache_defs(shape.global_batch, shape.seq_len)):
        if seq_shard and "seq" in d.axes:
            spec = tuple("data" if a == "batch" and n % 16 == 0
                         else "model" if a == "seq" and n % 16 == 0 else None
                         for a, n in zip(d.axes, d.shape))
        else:
            spec = tuple(ref_sharding.spec_for(d, m, fsdp=False,
                                               model_axes=maxes))
        if multi:
            bdims = tuple(i for i, a in enumerate(d.axes) if a == "batch")
            spec = tuple(ref._pod_spec(P(*spec), bdims, d.shape, n_pods))
        cache.append((d.shape, size(d.dtype), spec))
    b = shape.global_batch
    toks = tuple(ref._pod_spec(P("data" if b % 16 == 0 else None), (0,), (b,),
                               n_pods))
    return params(False) + cache + [((b,), 4, toks), ((), 4, ())]


def _device_bytes(placed, mesh) -> int:
    total = 0
    for sh, itemsize, spec in placed:
        block = []
        for i, dim in enumerate(sh):
            axes = spec[i] if i < len(spec) else None
            axes = () if axes is None else (axes,) if isinstance(axes, str) \
                else axes
            block.append(dim // math.prod(mesh.shape[a] for a in axes))
        total += math.prod(block) * itemsize
    return total


@pytest.mark.parametrize("arch,kind,mesh",
                         [c for c in CASES if c[2] != "card"])
def test_argument_bytes_sum_the_references_placement(records, arch, kind,
                                                     mesh):
    r = records[arch, kind, mesh]
    if r["status"] == "skip":
        return
    placed = _ref_placed(arch, SHAPES[kind], mesh)
    pos = 4 if kind == "decode" else 0  # the port passes pos as int
    assert r["bytes_per_device"]["argument"] == _device_bytes(
        placed, MESHES[mesh]) - pos


def test_card_argument_bytes_are_every_argument(records):
    for (arch, kind, mesh), r in records.items():
        if mesh == "card" and r["status"] == "ok":
            placed = _ref_placed(arch, SHAPES[kind], "single")
            whole = [(sh, size, ()) for sh, size, _ in placed]
            pos = 4 if kind == "decode" else 0  # the port passes pos as int
            assert r["bytes_per_device"]["argument"] == _device_bytes(
                whole, MESHES["single"]) - pos, (arch, kind)


# Reduced glm4-9b (f32, 2 layers, d_model 256, 4 heads of 64 on 2 kv heads,
# d_ff 512, vocab 512) with FSDP on.  On the single mesh every weight matrix
# sits on "data" and "model" (16 x 16): FSDP gathers 1/16 of each leaf a
# device, a layer's slice at a time (embed, lm_head 32768 bytes; wq, wo
# 16384 a layer; wk, wv 8192; wi, wg, mlp's wo 32768: 360448 over 16
# gathers).  Both layers' attention and MLP sit on "model": 4 all-reduces
# of 32 / 16 x 16 positions x 256 x 4 B = 32768, and the vocab-parallel
# embedding's one.  The 4 heads do not divide "model", so the attention
# sits there by head_dim: q (2 x 16 x 4 x 64 x 4 B = 32768), k and v
# (16384 each) are gathered whole in each layer (6 gathers, 131072 B).
GLM4_PREFILL = ({"all-gather": 360448 + 131072, "all-reduce": 5 * 32768},
                {"all-gather": 16 + 6, "all-reduce": 5})
# The multi round at 32 x 16: 1 row a device (16 a pod over 16 data
# shards), K = 1, SAM's 2 gradient passes.  Each pass gathers every FSDP
# slice once (2 x 16 x 22528 B over 32) and reduce-scatters its gradient
# (2 x 22528 over 32); 4 tensor-parallel all-reduces a pass each way, the
# embedding's and the head's input gradient's (20 x 16384 B), the logits'
# gather (2 x 1 x 16 x 512 x 4 B); the norm scales' gradients (5120 B a
# pass) all-reduced over "data" and over "model" (12); SAM's norm over
# both axes and the loss and accuracy over "data" (4 x 4 B).  The pod
# round gathers each replica's 9 sharded leaves over "model" then "data"
# (5767168 / 16 + 5767168 B), receives the whole (2, D) f32 bank, D =
# 1443072, and gathers w, the loss and the accuracy (3 x 8 B).  The
# head_dim attention gathers q (16384 B), k and v (8192 each) in each layer
# of each pass, and its output's gradient (16384 B) on the way back (4 x
# 49152 B over 16 gathers).
GLM4_ROUND = ({"all-gather": (2 * 16 * 22528 + 2 * 32768 + 5767168 // 16
                              + 5767168 + 2 * 4 * 1443072 + 24
                              + 4 * 49152),
               "reduce-scatter": 2 * 22528,
               "all-reduce": 20 * 16384 + 4 * 5120 + 16},
              {"all-gather": 32 + 2 + 18 + 1 + 3 + 16, "reduce-scatter": 32,
               "all-reduce": 36})
# Reduced dbrx-132b widened to 16 experts (top 2), FSDP on: the experts sit
# on "model" by their expert axis and on "data" by embed (wi, wg, wo: 2 x 16
# x 256 x 512 x 4 B over 16 model shards, 1048576 B gathered each, a layer
# at a time), the router on "data" (32768), the rest as glm4's (163840 +
# 32768); 4 all-reduces and the vocab-parallel embedding's.  The tokens
# are replicated on "model", so the experts' combine is summed by the MLP's
# all-reduce and no all-to-all runs; each MoE layer averages its aux
# B).  The head_dim attention gathers q, k and v as glm4's (131072 B).
DBRX_PREFILL = ({"all-gather": 3342336 + 131072,
                 "all-reduce": 5 * 32768 + 2 * 128},
                {"all-gather": 18 + 6, "all-reduce": 7})


@pytest.mark.parametrize("arch,kind,mesh,overrides,want", [
    ("glm4-9b", "prefill", "single", {"fsdp": True}, GLM4_PREFILL),
    ("glm4-9b", "train", "multi", {"fsdp": True}, GLM4_ROUND),
    ("dbrx-132b", "prefill", "single", {"fsdp": True, "n_experts": 16},
     DBRX_PREFILL),
])
def test_collective_rules_against_a_hand_count(arch, kind, mesh, overrides,
                                               want):
    """The rules (``dryrun.collectives``) and the record, rank 0's trace,
    both against the hand count."""
    import dataclasses

    from repro_torch.configs.registry import get_config
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.models.registry import get_model_api

    r = dryrun.run_one(arch, SHAPES[kind], mesh, overrides=overrides,
                       smoke=True)
    assert (r["collectives"]["bytes"], r["collectives"]["count"]) == want
    api = get_model_api(dataclasses.replace(get_config(arch, smoke=True),
                                            **overrides))
    m = make_production_mesh(multi_pod=mesh == "multi")
    rules = dryrun._collectives(api, SHAPES[kind], m, mesh == "multi",
                                dryrun._placed_args(api, SHAPES[kind], m,
                                                    mesh == "multi"), 2)
    assert (rules.bytes_by_kind, rules.count_by_kind) == want
    weighted = sum(b * (2 if k == "all-reduce" else 1)
                   for k, b in want[0].items())
    assert r["roofline"]["collective_bytes_per_device"] == weighted


def test_traces_are_cached_by_arch_shape_step_and_mesh():
    """A trace is kept under (arch, shape, step, mesh), the mesh ``None``
    for the card's whole step, while each production mesh's records (the
    decode records among them) are rank 0's own."""
    traces = {}
    recs = [dryrun.run_one("glm4-9b", SHAPES["prefill"], m, smoke=True,
                           traces=traces) for m in dryrun.MESHES]
    assert sorted(k[3] or "" for k in traces) == ["", "multi", "single"]
    assert len({r["cost"]["flops"] for r in recs}) == 3
    recs = [dryrun.run_one("glm4-9b", SHAPES["decode"], m, smoke=True,
                           traces=traces) for m in dryrun.MESHES]
    assert len(traces) == 6  # the card's whole serve step and two rank 0's
    assert sorted(k[3] or "" for k in traces if k[1] == SHAPES["decode"]) \
        == ["", "multi", "single"]
    assert len({r["cost"]["flops"] for r in recs}) == 3
    recs = [dryrun.run_one("glm4-9b", SHAPES["train"], m, smoke=True,
                           traces=traces) for m in dryrun.MESHES]
    assert {k[2:] for k in traces if k[1] == SHAPES["train"]} == {
        ("train_step", None), ("train_step", "single"),
        ("round_step", "multi")}
    again = dryrun.run_one("glm4-9b", SHAPES["train"], "single", smoke=True,
                           traces=traces)
    assert len(traces) == 9 and again["cost"] == recs[1]["cost"]


def test_sharding_for_on_abstract_and_live_meshes():
    pdef = PDef((5120, 40, 128), ("embed", "heads", "head_dim"))
    # phi3: 40 heads do not divide by 16, so head_dim takes "model"
    assert sharding_for(pdef, MESHES["single"]) == (320, 40, 8)
    assert sharding_for(pdef) is None  # no active mesh

    class Live:  # a DeviceMesh's interface
        mesh_dim_names = ("data", "model")

        def size(self, i):
            return 16

    from torch.distributed.tensor import Replicate, Shard

    assert sharding_for(pdef, Live()) == (Shard(0), Shard(2))
    assert sharding_for(pdef, Live(), fsdp=False) == (Replicate(), Shard(2))
    from repro_torch.launch.sharding import active_mesh, use_mesh

    with use_mesh(MESHES["single"], fsdp=False):
        assert active_mesh() is MESHES["single"]
        assert sharding_for(pdef) == (5120, 40, 8)
    assert active_mesh() is None


def test_cli_writes_every_record_and_the_report_renders(tmp_path, capsys):
    argv = ["--arch", "glm4-9b,hubert-xlarge", "--shape",
            "prefill_32k,decode_32k", "--mesh", "card,single,multi",
            "--out", str(tmp_path), "--set", "n_layers=1"]
    assert dryrun.main(argv) == 0
    recs = report.load_records(str(tmp_path))
    assert len(recs) == 12
    assert sum(r["status"] == "skip" for r in recs) == 3  # hubert's decode
    assert all(r["status"] in ("ok", "skip") for r in recs)
    assert dryrun.main(argv) == 0  # cached
    assert "cached" in capsys.readouterr().out
    import sys

    prev = sys.argv
    sys.argv = ["report", "--dir", str(tmp_path)]
    try:
        report.main()
    finally:
        sys.argv = prev
    out = capsys.readouterr().out
    assert "## Roofline (one H100)" in out and "| glm4-9b | prefill_32k |" in out
    bad = ["--arch", "glm4-9b", "--shape", "decode_32k", "--mesh", "card",
           "--out", str(tmp_path / "bad"), "--set", "n_kv_heads=3"]
    assert dryrun.main(bad) == 1  # a trace that raises is an error record
    (rec,) = report.load_records(str(tmp_path / "bad"))
    assert rec["status"] == "error" and rec["traceback"]
