"""The dry-run's inputs, placement and accounting held to the reference's
(``repro.launch.dryrun``, ``repro.launch.sharding``, ``repro.roofline``):
``input_specs``, ``_skip_reason``, ``spec_for`` and ``_pod_spec`` over
every parameter and cache leaf of the zoo on both production meshes, the
parameter counts and model FLOPs, ``roofline_terms`` and the report's
tables.  All exact."""
from __future__ import annotations

import dataclasses

import pytest
from jax.sharding import PartitionSpec as P

from repro.configs.registry import get_config as ref_config
from repro.configs.registry import input_specs as ref_input_specs
from repro.launch import sharding as ref_sharding
from repro.models.pdefs import tree_num_params as ref_num_params
from repro.models.registry import get_model_api as ref_api
from repro.roofline import analysis as ref_analysis
from repro.roofline import report as ref_report

from _torch_dryrun_ref import (  # noqa: F401  (one_thread is an autouse fixture)
    MESHES,
    dtype_name,
    leaves,
    one_thread,
    reference_dryrun,
)
from repro_torch.configs.registry import (
    ARCH_IDS,
    INPUT_SHAPES,
    get_config,
    input_specs,
)
from repro_torch.launch import dryrun, sharding
from repro_torch.models.registry import get_model_api
from repro_torch.roofline import analysis, report

COMBOS = [(a, s) for a in ARCH_IDS for s in INPUT_SHAPES]


@pytest.mark.parametrize("arch,shape", COMBOS)
def test_input_specs_match_the_reference(arch, shape):
    ref = ref_input_specs(ref_config(arch), shape)
    got = input_specs(get_config(arch), shape)
    assert list(got) == list(ref)
    for name, sds in ref.items():
        assert tuple(got[name].shape) == tuple(sds.shape), name
        assert dtype_name(got[name].dtype) == dtype_name(sds.dtype), name
        assert got[name].device.type == "meta"


@pytest.mark.parametrize("arch,shape", COMBOS)
def test_skip_reason_matches_the_reference(arch, shape):
    ref = reference_dryrun()._skip_reason(ref_config(arch), INPUT_SHAPES[shape])
    got = dryrun._skip_reason(get_config(arch), INPUT_SHAPES[shape])
    assert got == ref


def _tree_pairs(ref_tree, port_tree):
    ref_leaves = list(leaves(ref_tree))
    port_leaves = list(leaves(port_tree))
    assert [p for p, _ in ref_leaves] == [p for p, _ in port_leaves]
    for (path, r), (_, g) in zip(ref_leaves, port_leaves):
        assert tuple(g.shape) == tuple(r.shape) and tuple(g.axes) == tuple(
            r.axes), path
        yield path, r, g


@pytest.mark.parametrize("fallback", ["head_dim", "replicate"])
@pytest.mark.parametrize("fsdp", [True, False])
@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_spec_for_places_every_leaf_as_the_reference(arch, mesh, fsdp,
                                                     fallback):
    """Every parameter leaf, and every cache leaf at ``decode_32k`` (also
    widened by ``_pod_spec`` over its batch dims), on both production
    meshes, with FSDP on and off and with heads replicated or not."""
    m = MESHES[mesh]
    ref_cfg = dataclasses.replace(ref_config(arch), attn_fallback=fallback)
    cfg = dataclasses.replace(get_config(arch), attn_fallback=fallback)
    ref_axes = reference_dryrun()._model_axes(ref_cfg)
    axes = sharding.model_axes_for(cfg)
    assert axes == ref_axes
    shape = INPUT_SHAPES["decode_32k"]
    ra, ga = ref_api(ref_cfg), get_model_api(cfg)
    for path, r, g in _tree_pairs(ra.param_defs(), ga.param_defs()):
        want = ref_sharding.spec_for(r, m, fsdp=fsdp, model_axes=ref_axes)
        assert sharding.spec_for(g, m, fsdp=fsdp, model_axes=axes) == tuple(
            want), path
    caches = _tree_pairs(ra.cache_defs(shape.global_batch, shape.seq_len),
                         ga.cache_defs(shape.global_batch, shape.seq_len))
    for path, r, g in caches:
        want = ref_sharding.spec_for(r, m, fsdp=False, model_axes=ref_axes)
        spec = sharding.spec_for(g, m, fsdp=False, model_axes=axes)
        assert spec == tuple(want), path
        bdims = tuple(i for i, a in enumerate(r.axes) if a == "batch")
        n_pods = m.shape.get("pod", 1)
        assert sharding.pod_spec(spec, bdims, g.shape, n_pods) == tuple(
            reference_dryrun()._pod_spec(want, bdims, r.shape, n_pods)), path


@pytest.mark.parametrize("n_pods", [1, 2, 4])
@pytest.mark.parametrize("rows", [1, 16, 32, 128])
def test_pod_spec_widens_the_batch_as_the_reference(rows, n_pods):
    spec = ("data" if rows % 16 == 0 else None, None)
    want = reference_dryrun()._pod_spec(P(*spec), (0,), (rows, 8), n_pods)
    assert sharding.pod_spec(spec, (0,), (rows, 8), n_pods) == tuple(want)


@pytest.mark.parametrize("arch,shape", COMBOS)
def test_params_and_model_flops_match_the_reference(arch, shape):
    cfg, api = ref_config(arch), ref_api(ref_config(arch))
    n_params = ref_num_params(api.param_defs())
    if cfg.n_experts:  # the reference's dry-run, src/repro/launch/dryrun.py
        per_layer = 3 * cfg.d_model * cfg.d_ff
        active = n_params - cfg.n_layers * (cfg.n_experts - cfg.top_k) * per_layer
    else:
        active = n_params
    sh = INPUT_SHAPES[shape]
    tokens = sh.global_batch * (1 if sh.kind == "decode" else sh.seq_len)
    mf = ref_analysis.model_flops(active, tokens,
                                  "train" if sh.kind == "train" else "fwd")
    got = dryrun.param_counts(get_model_api(get_config(arch)))
    assert got == (n_params, active)
    assert dryrun.step_model_flops(active, sh) == mf


@pytest.mark.parametrize("case", range(4))
def test_roofline_terms_match_the_reference(case):
    hw = {"peak_flops_bf16": 989e12, "hbm_bw": 3.35e12, "ici_bw": 450e9,
          "link_bw": 450e9}
    cost = [{"flops": 1.5e15, "bytes accessed": 2e12},
            {"flops": 3e9, "bytes accessed": 7e11},
            {"flops": 0.0},
            {"flops": 4e12, "bytes accessed": 1e9}][case]
    colls = [{}, {"all-reduce": 3 << 30},
             {"all-gather": 5 << 20, "reduce-scatter": 1 << 20},
             {"all-reduce": 1 << 40, "all-to-all": 7}][case]
    ref = ref_analysis.CollectiveStats(dict(colls), {k: 1 for k in colls})
    got = analysis.CollectiveStats(dict(colls), {k: 1 for k in colls})
    assert got.weighted_bytes == ref.weighted_bytes
    assert got.total_bytes == ref.total_bytes
    assert analysis.roofline_terms(cost, got, hw) == \
        ref_analysis.roofline_terms(cost, ref, hw)
    for kind in ("train", "fwd"):
        assert analysis.model_flops(12345, 678, kind) == \
            ref_analysis.model_flops(12345, 678, kind)


def _records():
    def ok(arch, shape, mesh, bottleneck, ratio):
        return {"arch": arch, "shape": shape, "mesh": mesh, "status": "ok",
                "kind": "train", "compile_s": 1.5, "n_params": 9.4e9,
                "bytes_per_device": {"argument": 3 << 30, "temp": 5 << 28},
                "collectives": {"count": {"all-gather": 4, "all-reduce": 2}},
                "roofline": {"t_compute_s": 1.25, "t_memory_s": 2.5e-3,
                             "t_collective_s": 3e-4, "bottleneck": bottleneck},
                "model_flops": 6.1e17, "useful_flops_ratio": ratio}

    return [
        ok("glm4-9b", "train_4k", "single", "compute", 0.71),
        ok("glm4-9b", "train_4k", "multi", "collective", 0.5),
        ok("gemma3-12b", "prefill_32k", "single", "memory", 1.02),
        {"arch": "hubert-xlarge", "shape": "decode_32k", "mesh": "single",
         "status": "skip", "reason": "encoder-only architecture: no "
                                     "autoregressive decode"},
        {"arch": "dbrx-132b", "shape": "long_500k", "mesh": "multi",
         "status": "error", "error": "ValueError: " + "x" * 100},
    ]


@pytest.mark.parametrize("table", ["dryrun", "single", "multi", "load"])
def test_report_tables_render_as_the_reference(table, tmp_path):
    recs = _records()
    if table == "load":
        import json

        for i, r in enumerate(recs):
            (tmp_path / f"{i}.json").write_text(json.dumps(r))
        assert report.load_records(str(tmp_path)) == \
            ref_report.load_records(str(tmp_path))
    elif table == "dryrun":
        assert report.dryrun_table(recs) == ref_report.dryrun_table(recs)
    else:
        assert report.roofline_table(recs, table) == \
            ref_report.roofline_table(recs, table)
