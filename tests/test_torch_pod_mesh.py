"""The pod runtime's placement, in one process: ``launch.steps.place_pods``
(``launch.sharding.place_params``) on live meshes of a fake 8-rank world
(``torch.testing``'s fake process group: every rank's mesh coordinates,
no traffic) held to the reference's ``spec_for`` and its shard-shape
arithmetic, the layer axis never split, ``make_host_mesh``'s refusals,
every family placed by ``spec_for`` (the experts on "model"), and the
reference's ``constrain`` / ``in_manual_region`` rules.  All exact.

Meshes: the reference's host mesh (2, 2, 2) and two others of 8 devices,
(2, 1, 4) (4 query heads on a 4-wide model axis, 2 kv heads that do not
divide it) and (1, 4, 2) (both pods on each rank); reduced glm4-9b and
gemma3-12b, under their own ``fsdp`` (off) and with FSDP on.
"""
from __future__ import annotations

import dataclasses
import math

import pytest
import torch
import torch.distributed as dist

from repro.configs.registry import get_config as ref_config
from repro.launch import sharding as ref_sharding
from repro.models.registry import get_model_api as ref_api

from _torch_dryrun_ref import leaves
from repro_torch.configs.registry import get_config
from repro_torch.core.flat import tree_map
from repro_torch.launch import mesh as meshlib
from repro_torch.launch import sharding, steps
from repro_torch.models.registry import get_model_api
from _torch_threads import one_thread  # noqa: F401,E402  (an autouse fixture)

AXES = ("pod", "data", "model")
SHAPES = [(2, 2, 2), (2, 1, 4), (1, 4, 2)]
RANKS = (0, 5)  # a first and a middle rank: different coordinates
N_PODS = 2
DENSE_GQA = ("glm4-9b", "gemma3-12b", "phi3-medium-14b", "codeqwen1.5-7b")
OTHERS = ("dbrx-132b", "deepseek-v3-671b", "xlstm-350m", "hymba-1.5b",
          "llava-next-mistral-7b", "hubert-xlarge")


class Duck:
    """A mesh by its axes alone, for both packages' ``spec_for``."""

    def __init__(self, shape):
        self.axis_names = AXES
        self.shape = dict(zip(AXES, shape))


@pytest.fixture
def fake_world():
    """``fake_world(rank)`` starts a fake 8-rank world as ``rank``; it is
    torn down after the test."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    def start(rank):
        if dist.is_initialized():
            dist.destroy_process_group()
        dist.init_process_group("fake", store=FakeStore(), rank=rank,
                                world_size=8)

    yield start
    if dist.is_initialized():
        dist.destroy_process_group()


def _reduced(arch, fsdp):
    ref_cfg, cfg = ref_config(arch, smoke=True), get_config(arch, smoke=True)
    if fsdp:
        ref_cfg = dataclasses.replace(ref_cfg, fsdp=True)
        cfg = dataclasses.replace(cfg, fsdp=True)
    return ref_cfg, cfg


def _zeros(defs):
    if isinstance(defs, dict):
        return {k: _zeros(v) for k, v in defs.items()}
    return torch.zeros((N_PODS,) + tuple(defs.shape), dtype=defs.dtype)


@pytest.mark.parametrize("fsdp", [False, True], ids=["own-fsdp", "fsdp"])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("arch", ["glm4-9b", "gemma3-12b"])
def test_local_shards_match_the_reference(fake_world, arch, shape, fsdp):
    """Each rank's local block of every placed leaf is the reference's
    ``spec_for`` block on the duck-typed mesh: a dim on an axis divided by
    its size, the pods split over the pod axis."""
    ref_cfg, cfg = _reduced(arch, fsdp)
    ref_defs = dict(leaves(ref_api(ref_cfg).param_defs()))
    api = get_model_api(cfg)
    duck = Duck(shape)
    for rank in RANKS:
        fake_world(rank)
        mesh = meshlib.make_host_mesh(shape, AXES, device="cpu")
        placed = steps.place_pods(api, _zeros(api.param_defs()), mesh)
        local_pods = N_PODS // shape[0]
        for path, x in leaves(placed):
            d = ref_defs[path]
            spec = tuple(ref_sharding.spec_for(d, duck, fsdp=ref_cfg.fsdp))
            spec += (None,) * (len(d.shape) - len(spec))
            want = (local_pods,) + tuple(
                n // (duck.shape[a] if a else 1) for n, a in zip(d.shape, spec))
            local = x.to_local() if sharding.is_dtensor(x) else x
            assert tuple(local.shape) == want, (path, rank, spec)
            # the port's own spec_for is the reference's
            assert sharding.spec_for(api_def(api, path), mesh,
                                     fsdp=cfg.fsdp) == spec, path


def api_def(api, path):
    return dict(leaves(api.param_defs()))[path]


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("arch", DENSE_GQA)
def test_the_layer_axis_is_never_split(fake_world, arch, shape):
    """``transformer._layer`` indexes each stacked leaf per layer: no
    placement may shard the layer axis, at any width of the zoo's dense
    GQA decoders (full-width configs, FSDP on)."""
    from torch.distributed.tensor import Shard

    cfg = get_config(arch)
    fake_world(0)
    mesh = meshlib.make_host_mesh(shape, AXES, device="cpu")
    sub = sharding.submesh(mesh)
    for path, d in leaves(get_model_api(cfg).param_defs()):
        if "layers" not in d.axes:
            continue
        for fsdp in (False, True):
            spec = sharding.spec_for(d, mesh, fsdp=fsdp)
            assert spec[d.axes.index("layers")] is None, (path, spec)
            pl = sharding.placements_for(spec, sub, lead=1)
            assert Shard(1 + d.axes.index("layers")) not in pl, (path, pl)


def test_make_host_mesh_refuses_without_a_world_or_a_wrong_size(fake_world):
    if dist.is_initialized():
        dist.destroy_process_group()
    with pytest.raises(RuntimeError, match="running process group"):
        meshlib.make_host_mesh((2, 2, 2), AXES, device="cpu")
    fake_world(0)
    for shape in ((2, 2), (2, 2, 4), (1, 1, 1)):
        with pytest.raises(ValueError, match="world of as many ranks"):
            meshlib.make_host_mesh(shape, AXES[-len(shape):], device="cpu")
    mesh = meshlib.make_host_mesh((2, 2, 2), AXES, device="cpu")
    assert mesh.mesh_dim_names == AXES and tuple(mesh.shape) == (2, 2, 2)
    with pytest.raises(ValueError, match="differ in rank"):
        meshlib.make_host_mesh((2, 4), AXES, device="cpu")


@pytest.mark.parametrize("arch", OTHERS + DENSE_GQA)
def test_every_family_is_placed_by_spec_for(fake_world, arch):
    """Every family's replica runs as DTensors over its pod's submesh: on
    (2, 2, 2) each rank's local block of every leaf is the reference's
    ``spec_for`` block (a mixture's experts on "model"); on a pod-only mesh
    the replica is whole on its pod's rank, as DTensors all the same."""
    ref_cfg, cfg = _reduced(arch, False)
    ref_defs = dict(leaves(ref_api(ref_cfg).param_defs()))
    api = get_model_api(cfg)
    duck = Duck((2, 2, 2))
    fake_world(3)
    mesh = meshlib.make_host_mesh((2, 2, 2), AXES, device="cpu")
    placed = steps.place_pods(api, _zeros(api.param_defs()), mesh)
    for path, x in leaves(placed):
        d = ref_defs[path]
        spec = tuple(ref_sharding.spec_for(d, duck, fsdp=ref_cfg.fsdp))
        spec += (None,) * (len(d.shape) - len(spec))
        assert sharding.is_dtensor(x), path
        assert tuple(x.to_local().shape) == (1,) + tuple(
            n // (duck.shape[a] if a else 1) for n, a in zip(d.shape, spec))
        if "expert" in d.axes:
            assert spec[d.axes.index("expert")] == "model", path
    mesh = meshlib.make_host_mesh((8, 1, 1), AXES, device="cpu")
    stacked = tree_map(lambda d: torch.zeros((8,) + tuple(d.shape[1:]),
                                             dtype=d.dtype),
                       _zeros(api.param_defs()))
    for _, x in leaves(steps.place_pods(api, stacked, mesh)):
        assert sharding.is_dtensor(x) and x.device_mesh.size() == 1
        assert x.to_local().shape == x.shape and x.shape[0] == 1


def _act(mesh, shape=(4, 8, 4, 64)):
    from torch.distributed.tensor import DTensor, Replicate

    sub = sharding.submesh(mesh)
    return DTensor.from_local(torch.zeros(shape), sub,
                              [Replicate()] * sub.ndim, run_check=False)


def test_constrain_places_activations_as_the_reference(fake_world):
    """Outside a manual region ``constrain`` redistributes a DTensor to
    the placements its logical names resolve to (batch on "data", heads on
    "model"); without an active mesh it is the identity."""
    from torch.distributed.tensor import Replicate, Shard

    fake_world(6)
    mesh = meshlib.make_host_mesh((2, 2, 2), AXES, device="cpu")
    x = _act(mesh)
    assert sharding.constrain(x, ("batch", "seq", "heads", None)) is x
    with sharding.use_mesh(mesh):
        y = sharding.constrain(x, ("batch", "seq", "heads", None))
        assert tuple(y.placements) == (Shard(0), Shard(2))
        assert tuple(y.to_local().shape) == (2, 8, 2, 64)
        # seq and embed stay replicated; a dim that does not divide too
        z = sharding.constrain(_act(mesh, (3, 8, 4, 64)),
                               ("batch", "seq", "embed", None))
        assert tuple(z.placements) == (Replicate(), Replicate())
        # a plain tensor (a replica whole on its rank) passes through
        p = torch.zeros(4, 8, 4, 64)
        assert sharding.constrain(p, ("batch", "seq", "heads", None)) is p


def test_constrain_is_the_identity_in_a_manual_region(fake_world):
    fake_world(1)
    mesh = meshlib.make_host_mesh((2, 2, 2), AXES, device="cpu")
    x = _act(mesh)
    assert not sharding.in_manual_region()
    with sharding.manual_region(mesh):
        assert not sharding.in_manual_region()  # no active mesh: False
    with sharding.use_mesh(mesh):
        assert not sharding.in_manual_region()
        with sharding.manual_region(mesh):
            assert sharding.in_manual_region()
            assert sharding.in_manual_region(mesh)
            assert sharding.constrain(x, ("batch", "seq", "heads", None)) is x
            with sharding.manual_region(mesh):
                assert sharding.in_manual_region()
            assert sharding.in_manual_region()
        assert not sharding.in_manual_region()
        assert not sharding.in_manual_region(Duck((2, 2, 2)))


@pytest.mark.parametrize("inside", [False, True], ids=["outside", "inside"])
@pytest.mark.parametrize("logical", [("batch", "seq", "nope", None),
                                     ("batch", "seq", "heads"),
                                     ("batch", "seq", "heads", None, None)],
                         ids=["unknown-axis", "too-few", "too-many"])
def test_a_malformed_constraint_raises(fake_world, inside, logical):
    fake_world(2)
    mesh = meshlib.make_host_mesh((2, 2, 2), AXES, device="cpu")
    x = _act(mesh)
    with sharding.use_mesh(mesh):
        with (sharding.manual_region(mesh) if inside
              else _nothing()):
            with pytest.raises(ValueError):
                sharding.constrain(x, logical)
            with pytest.raises(ValueError):
                sharding.constrain(torch.zeros(4, 8, 4, 64), logical)


class _nothing:
    def __enter__(self):
        return self

    def __exit__(self, *a):
        return False


def test_the_flash_kernels_refuse_a_dtensor(fake_world):
    """The kernels read raw pointers: a DTensor's shard read as the whole
    would be wrong, so the wrappers raise (the pod runtime hands them the
    local shards)."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops

    fake_world(0)
    mesh = meshlib.make_host_mesh((2, 2, 2), AXES, device="cpu")
    q = _act(mesh, (2, 4, 16, 64))
    k = torch.zeros(2, 2, 16, 64)
    for call in (lambda: ops.flash_attention(q, k, k),
                 lambda: fa.flash_attention_with_lse(q, k, k),
                 lambda: fa.flash_attention_backward(q, k, k, q, q)):
        with pytest.raises(TypeError, match="DTensor"):
            call()


def test_pod_rows_split_the_pods_over_the_pod_axis(fake_world):
    for shape, rank, lo, m in (((2, 2, 2), 5, 1, 1), ((1, 4, 2), 7, 0, 2),
                               ((2, 1, 4), 3, 0, 1)):
        fake_world(rank)
        mesh = meshlib.make_host_mesh(shape, AXES, device="cpu")
        rows = steps.pod_rows(mesh, N_PODS)
        assert (rows.lo, rows.m, rows.world) == (lo, m, shape[0])
    assert steps.pod_rows(None, N_PODS) is None
    fake_world(0)
    mesh = meshlib.make_host_mesh((8, 1, 1), AXES, device="cpu")
    with pytest.raises(ValueError, match="divisible"):
        steps.pod_rows(mesh, 3)
    assert math.prod(mesh.shape) == 8
