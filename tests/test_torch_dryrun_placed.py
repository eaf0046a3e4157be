"""The dry-run's per-device records (``repro_torch.launch.dryrun``): the
train, prefill and decode records on the ``single`` and ``multi``
production meshes are rank 0's own step, placed by the pod runtime and
traced on meta as rank 0 of a fake world of 256 or 512 ranks
(``launch.mesh.fake_world``, ``dryrun.trace_placed``).  Two decode shapes:
a batch that divides "data" (the cache's rows split there) and a batch of
1 (its positions split there, as ``long_500k``'s; hymba with 16 meta
tokens, so that its cache of meta tokens and positions divides).  For
every arch of the zoo at reduced size (every decoding arch for decode): the
record reads ``"per_device": "rank 0"``, its FLOPs times the chips are at
least the whole step's (what the runtime replicates), its collectives equal
the rules of ``roofline.analysis`` (``dryrun.collectives``), its argument
bytes the placement's; on a mesh of one rank the trace counts the FLOPs and
kernel records of the mesh-less step; the fake world is gone after each
record.  No JAX (the file also runs on the card's machine).  Exact."""
from __future__ import annotations

import pytest
import torch

from repro_torch.configs.base import InputShape
from repro_torch.configs.registry import ARCH_IDS, get_config
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import AbstractMesh, fake_world
from repro_torch.models.registry import get_model_api

SHAPES = {"train": InputShape("train_16", 16, 32, "train"),
          "prefill": InputShape("prefill_16", 16, 32, "prefill"),
          "decode": InputShape("decode_16", 16, 32, "decode"),
          "long": InputShape("long_32", 32, 1, "decode")}
PLACED = ("single", "multi")
DECODING = tuple(a for a in ARCH_IDS if get_config(a, smoke=True)
                 .supports_decode())
CASES = [(a, k, m) for k in SHAPES for a in (
    DECODING if SHAPES[k].kind == "decode" else ARCH_IDS) for m in PLACED]


def _overrides(arch, kind):
    """hymba's long shape: 16 meta tokens (its cache of 48 positions then
    splits over "data")."""
    return ({"n_meta_tokens": 16} if kind == "long" and arch == "hymba-1.5b"
            else None)
ONE = AbstractMesh(("pod", "data", "model"), {"pod": 1, "data": 1, "model": 1})


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def records():
    """Each arch's records on the three meshes, sharing one traces dict:
    the card's whole steps and the production meshes' rank-0 steps."""
    out, traces = {}, {}
    for arch, kind, _ in CASES[::2]:
        for mesh in ("card",) + PLACED:
            out[arch, kind, mesh] = dryrun.run_one(
                arch, SHAPES[kind], mesh, smoke=True, traces=traces,
                overrides=_overrides(arch, kind))
    return out, traces


def _api(arch, kind="train"):
    import dataclasses

    return get_model_api(dataclasses.replace(get_config(arch, smoke=True),
                                             **(_overrides(arch, kind) or {})))


@pytest.mark.parametrize("arch,kind,mesh", CASES)
def test_the_record_is_rank_0_s_own_step(records, arch, kind, mesh):
    r = records[0][arch, kind, mesh]
    assert r["status"] == "ok" and r["per_device"] == "rank 0"
    t = r["roofline"]
    assert t["flops_per_device"] == r["cost"]["flops"] > 0
    assert t["bytes_per_device"] == r["cost"]["bytes accessed"] > 0
    b = r["bytes_per_device"]
    assert b["peak_estimate"] == b["argument"] + b["temp"]
    m = dryrun.make_production_mesh(multi_pod=mesh == "multi")
    api = _api(arch, kind)
    placed = dryrun._placed_args(api, SHAPES[kind], m, mesh == "multi")
    pos = 4 if SHAPES[kind].kind == "decode" else 0  # a host int
    assert b["argument"] == dryrun._device_bytes(placed, m) - pos


@pytest.mark.parametrize("arch,kind,mesh", CASES)
def test_the_chips_do_at_least_the_whole_step_s_work(records, arch, kind,
                                                     mesh):
    """Rank 0's FLOPs times the chip count against the whole step's (the
    card record's trace): the runtime's replicated work (heads that do not
    divide "model", norms, gathered up-projections, the tokens around the
    experts) makes it more, never less."""
    r = records[0][arch, kind, mesh]
    whole = records[0][arch, kind, "card"]["cost"]["flops"]
    assert r["cost"]["flops"] * r["n_chips"] >= whole


@pytest.mark.parametrize("arch,kind,mesh", CASES)
def test_the_trace_s_collectives_equal_the_rules(records, arch, kind, mesh):
    r = records[0][arch, kind, mesh]
    m = dryrun.make_production_mesh(multi_pod=mesh == "multi")
    api = _api(arch, kind)
    placed = dryrun._placed_args(api, SHAPES[kind], m, mesh == "multi")
    rules = dryrun._collectives(api, SHAPES[kind], m, mesh == "multi",
                                placed, 2)
    assert r["collectives"]["bytes"] == rules.bytes_by_kind
    assert r["collectives"]["count"] == rules.count_by_kind


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_a_mesh_of_one_rank_counts_the_meshless_step(arch):
    """On a fake world of one rank, a ``(1, 1, 1)`` mesh, every placement
    is ``Replicate``: the placed round step (its pods' forward, backward,
    update and mix) counts the FLOPs and the kernel records of the
    mesh-less round, and no collective."""
    api = _api(arch)
    got = dryrun.trace_placed(api, SHAPES["train"], "round_step", ONE)
    want = dryrun.trace(api, SHAPES["train"], "round_step")
    assert got["flops"] == want["flops"]
    assert got["kernels"] == want["kernels"]
    assert got["collectives"] == {"bytes": {}, "count": {}}


def test_the_fake_world_is_gone_after_a_record(tmp_path):
    """After a rank-0 record no process group runs, so a gloo world starts;
    and a fake world refuses to start while one runs."""
    import socket

    import torch.distributed as dist

    dryrun.run_one("glm4-9b", SHAPES["prefill"], "single", smoke=True)
    assert not dist.is_initialized()
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=1, rank=0)
    try:
        with pytest.raises(RuntimeError, match="without a process group"):
            with fake_world((2, 2), ("data", "model")):
                pass
        assert dist.get_backend() == "gloo"
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("fault", ["world", "trace"])
def test_a_failing_rank_0_trace_is_an_error_record(tmp_path, monkeypatch,
                                                   fault):
    """A fake world that fails to start, or a placed step that raises,
    writes an error record: no division of a whole step in its place, and
    no fake world left behind."""
    import contextlib
    import json

    import torch.distributed as dist

    from repro_torch.launch import mesh as mesh_lib

    def broken(*args, **kwargs):
        raise RuntimeError(f"the {fault} broke")

    if fault == "world":
        monkeypatch.setattr(mesh_lib, "fake_world",
                            contextlib.contextmanager(broken))
    else:
        monkeypatch.setattr(dryrun, "placed_step_args", broken)
    argv = ["--arch", "glm4-9b", "--shape", "prefill_32k", "--mesh",
            "single", "--out", str(tmp_path), "--set", "n_layers=1"]
    assert dryrun.main(argv) == 1
    (path,) = tmp_path.iterdir()
    rec = json.loads(path.read_text())
    assert rec["status"] == "error" and "per_device" not in rec
    assert f"the {fault} broke" in rec["error"]
    assert not dist.is_initialized()


def test_decode_records_are_rank_0_s_own_step(records):
    """Every decoding arch's decode records on both production meshes are
    rank 0's serve step on its blocks of the placed cache, its argument
    bytes exactly the placement's (``pos`` is a host int): the batch of 32
    split over "data" (and the pods on ``multi``), the batch of 1's
    positions split over "data"."""
    for arch in DECODING:
        for kind in ("decode", "long"):
            for mesh in PLACED:
                r = records[0][arch, kind, mesh]
                assert r["per_device"] == "rank 0", (arch, kind, mesh)
                m = dryrun.make_production_mesh(multi_pod=mesh == "multi")
                api = _api(arch, kind)
                placed = dryrun._placed_args(api, SHAPES[kind], m,
                                             mesh == "multi")
                assert r["bytes_per_device"]["argument"] == \
                    dryrun._device_bytes(placed, m) - 4
                key = next(iter(placed[1]))  # a cache leaf with positions
                spec = placed[1][key][2]
                if kind == "long" and arch != "xlstm-350m":
                    assert spec[2] == "data", (arch, mesh, spec)
                elif arch != "xlstm-350m":
                    assert spec[1] in ("data", ("pod", "data")), spec


def test_cost_mode_counts_a_dtensor_step_at_its_local_shapes():
    """A matmul of a DTensor split over 4 ranks of a fake world: the local
    (2, 8) x (8, 3) product, and one all-gather of its (8, 3) output."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from repro_torch.roofline.cost import CostMode

    with fake_world((4,), ("data",)) as mesh:
        x = DTensor.from_local(torch.empty(2, 8, device="meta"), mesh,
                               [Shard(0)], run_check=False, shape=(8, 8),
                               stride=(8, 1))
        w = DTensor.from_local(torch.empty(8, 3, device="meta"), mesh,
                               [Replicate()], run_check=False)
        with CostMode((x, w)) as mode:
            y = (x @ w).redistribute(mesh, [Replicate()])
        r = mode.result(y)
    assert r["aten_flops"] == 2 * 2 * 8 * 3
    assert r["memory"]["argument"] == 4 * (2 * 8 + 8 * 3)
    assert r["collectives"] == {"bytes": {"all-gather": 4 * 8 * 3},
                                "count": {"all-gather": 1}}
