"""The pod runtime for every family in an 8-rank CPU world
(``tests/_torch_pod_families_world.py``, gloo): reduced xlstm-350m,
hymba-1.5b, llava-next-mistral-7b, hubert-xlarge, dbrx-132b and
deepseek-v3-671b on the reference's ``(2, 2, 2)`` ``("pod", "data",
"model")`` host mesh, and a reduced hymba-1.5b with 5 heads on 5 kv heads
(the model axis of 2 does not divide them); 2 pods, K = 2 local steps of 4
x 16 positions (one for the 5-head hymba), one round under ``gossip``
"xla", from the same initial params and batches.  Held to: ``spec_for``'s shard
shapes on every rank (the experts on "model"); the mesh-less port round;
for xlstm-350m and dbrx-132b the reference's own ``make_round_step`` on
its (2, 2, 2) host mesh (8 forced host devices, a subprocess beside the
world, as ``test_torch_pod_runtime.py``); ``core.sam.global_norm`` over
every shard; and, for each of the six, the bytes and counts of each
collective kind one rank issues in a round against the dry-run's rules
(``launch.dryrun.collectives``), the expert rule among them.

Tolerances, as ``test_torch_pod_runtime.py`` gives them: the sharded
forward sums partial products over "model" (the row-parallel projections,
the experts' combine, the xLSTM gates, the SSM's dt, B and C) and the
gradients over "data" in other orders than the whole replica (about 1e-7
relative per sum); two SAM passes and K = 2 steps carry that into the
params (measured at most 3.3e-6 of a leaf's largest magnitude, hymba's
``A_log``, against the mesh-less round; 4.7e-6 against the reference's,
xlstm's ``mlstm/ln``).  So params are held to 1e-5 of each leaf's largest
magnitude, w to 1e-6, loss and accuracy to 1e-5, and the mass to 2 within
1e-4.  One round: a second one would add nothing of these families (the
mix and its write-back into the shards are the same code for every
family, held over 2 rounds by ``test_torch_pod_runtime.py``), and it
grows the few leaves whose gradients are sums of cancelling terms
(xlstm's ``mlstm/ln``, hymba's SSM ``b_dt`` and ``A_log``, all zeros at
the start) past 1e-5 under any change of summation order — over 2 rounds
the reference's own host-mesh round differs from the mesh-less port's by
3.75e-5 on ``mlstm/ln``, and the mesh-less round from itself on 4
intra-op threads against 1 by 1.7e-5.
"""
from __future__ import annotations

import dataclasses
import json
import os
import pickle
import socket
import subprocess
import sys

import numpy as np
import pytest

from repro.configs.registry import get_config as ref_config
from repro.data.synthetic import make_lm_stream as ref_make_lm_stream
from repro.launch import sharding as ref_sharding
from repro.models.registry import get_model_api as ref_api

from _torch_dryrun_ref import leaves
import _torch_pod_families_world as world_script
from _torch_threads import one_thread  # noqa: F401,E402  (an autouse fixture)

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(os.path.dirname(HERE), "src")
WORLD = world_script.WORLD
N_PODS, K, B, S, ROUNDS = (world_script.N_PODS, world_script.K,
                           world_script.B, world_script.S,
                           world_script.ROUNDS)
ARCHS = world_script.ARCHS
CONFIGS = ARCHS + (world_script.HYMBA_5,)
XLSTM_2 = world_script.XLSTM_2
HELD = world_script.HELD
# Each reference round's configs and host mesh.
REFERENCES = {arch: "2,2,2" for arch in HELD}
REFERENCES[XLSTM_2] = ",".join(map(str, world_script.WIDE[0]))
TIMEOUT = 600

_REFERENCE = r"""
import os, sys, pickle
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.configs.registry import get_config
from repro.launch import sharding as shlib
from repro.launch.mesh import make_host_mesh
from repro.launch.steps import StepConfig, make_round_step, pod_mixing_neighbors
from repro.models.pdefs import PDef
from repro.models.registry import get_model_api

with open(sys.argv[1], "rb") as f:
    initial = pickle.load(f)
mesh = make_host_mesh(tuple(int(n) for n in sys.argv[4].split(",")),
                      ("pod", "data", "model"))
step_cfg = StepConfig(lr=0.05, alpha=0.9, rho=0.05, local_steps=2)
nl = pod_mixing_neighbors(2)
out = {}
for arch in sys.argv[3].split(","):
    if arch == "xlstm-350m-2h":
        import dataclasses
        cfg = dataclasses.replace(get_config("xlstm-350m", smoke=True),
                                  n_heads=2, n_kv_heads=2)
    else:
        cfg = get_config(arch, smoke=True)
    api = get_model_api(cfg)
    ref = initial[arch]
    with shlib.use_mesh(mesh, fsdp=cfg.fsdp):
        def shard(x, d):
            spec = shlib.spec_for(d, mesh, fsdp=cfg.fsdp)
            return jax.device_put(jnp.asarray(x),
                                  NamedSharding(mesh, P("pod", *spec)))

        params = jax.tree.map(shard, ref["params"], api.param_defs(),
                              is_leaf=lambda x: isinstance(x, PDef))
        v = jax.tree.map(jnp.zeros_like, params)
        w = jnp.ones((2,))
        step = jax.jit(make_round_step(api, step_cfg))
        ms = []
        for tk in ref["batch"]["tokens"]:
            params, v, w, _, _, m = step(params, v, w, (), (),
                                         {"tokens": jnp.asarray(tk)}, nl)
            ms.append({"loss": float(m["loss"]), "acc": float(m["acc"])})
        out[arch] = {"params": jax.tree.map(np.asarray,
                                            jax.device_get(params)),
                     "w": np.asarray(w), "metrics": ms}
with open(sys.argv[2], "wb") as f:
    pickle.dump(out, f)
"""


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _ref_cfg(name):
    if name == world_script.HYMBA_5:
        return dataclasses.replace(ref_config("hymba-1.5b", smoke=True),
                                   n_heads=5, n_kv_heads=5)
    if name == XLSTM_2:
        return dataclasses.replace(ref_config("xlstm-350m", smoke=True),
                                   n_heads=2, n_kv_heads=2)
    return ref_config(name, smoke=True)


def _initial(path):
    """Each config's initial pod-stacked params, drawn by the port from
    seed 0 (two distinct replicas, ``[x, x / 2]``, so that the first mix
    moves them; the reference's round takes the same arrays), and its round
    batches (``rounds, pods, K, B, ...``): the reference's token stream for
    the lm task, ``make_round_batches`` (numpy draws, the same in both
    packages) for the others."""
    import torch

    from repro_torch.configs.registry import make_round_batches
    from repro_torch.core.flat import tree_map
    from repro_torch.models.registry import get_model_api

    out = {}
    for name in CONFIGS + (XLSTM_2,):
        cfg = _ref_cfg(name)
        p = get_model_api(world_script.config(name)).init(
            torch.Generator().manual_seed(0), "cpu")
        params = tree_map(lambda x: torch.stack([x, x * 0.5]).numpy(), p)
        k = world_script.local_steps(name)
        if cfg.task == "lm":
            toks = np.asarray(ref_make_lm_stream(
                cfg.vocab_size, S, ROUNDS * N_PODS * k * B))
            batch = {"tokens": toks.reshape(ROUNDS, N_PODS, k, B, S)}
        else:
            batch = {k: v.numpy() for k, v in make_round_batches(
                world_script.config(name), ROUNDS, N_PODS, k, B, S,
                seed=1).items()}
        out[name] = {"params": params, "batch": batch}
    with open(path, "wb") as f:
        pickle.dump(out, f)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    out = tmp_path_factory.mktemp("pod_families")
    initial = out / "initial.pkl"
    _initial(initial)
    env = {**os.environ, "OMP_NUM_THREADS": "1", "MKL_NUM_THREADS": "1",
           "PYTHONPATH": SRC}
    env.pop("XLA_FLAGS", None)
    reference = [subprocess.Popen(
        [sys.executable, "-c", _REFERENCE, str(initial),
         str(out / f"reference_{arch}.pkl"), arch, shape],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env={**env, "JAX_PLATFORMS": "cpu"})
        for arch, shape in REFERENCES.items()]
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(HERE, "_torch_pod_families_world.py"),
         "--rank", str(r), "--port", str(port), "--out", str(out),
         "--initial", str(initial)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env)
        for r in range(WORLD)]
    logs = []
    try:
        for p in procs + reference:
            logs.append(p.communicate(timeout=TIMEOUT)[0])
    finally:
        for p in procs + reference:
            if p.poll() is None:
                p.kill()
                p.wait()
    failed = [(r, p.returncode, log[-3000:]) for r, (p, log)
              in enumerate(zip(procs + reference, logs)) if p.returncode]
    assert not failed, failed
    results = {"ranks": []}
    for r in range(WORLD):
        with open(out / f"rank{r}.json") as f:
            results["ranks"].append(json.load(f))
    with open(out / "states.pkl", "rb") as f:
        results["states"] = pickle.load(f)
    results["reference"] = {}
    for arch in REFERENCES:
        with open(out / f"reference_{arch}.pkl", "rb") as f:
            results["reference"].update(pickle.load(f))
    return results


class Duck:
    axis_names = ("pod", "data", "model")
    shape = {"pod": 2, "data": 2, "model": 2}


@pytest.mark.parametrize("name", CONFIGS)
def test_each_rank_holds_the_reference_s_shards(world, name):
    """Every rank's local block of every placed leaf, a DTensor: its pod
    (one of 2) and the reference's ``spec_for`` block of the replica on (2,
    2, 2) — a mixture's experts split on "model", hymba's 5 heads not (its
    projections split on head_dim instead)."""
    cfg = _ref_cfg(name)
    defs = dict(leaves(ref_api(cfg).param_defs()))
    for rank in world["ranks"]:
        rec = rank[name]
        assert rec["all_dtensors"]
        assert sorted(rec["shards"]) == sorted("/".join(p) for p in defs)
        for path, d in defs.items():
            spec = tuple(ref_sharding.spec_for(d, Duck(), fsdp=cfg.fsdp))
            spec += (None,) * (len(d.shape) - len(spec))
            want = [1] + [n // (Duck.shape[a] if a else 1)
                          for n, a in zip(d.shape, spec)]
            assert rec["shards"]["/".join(path)] == want, (path, spec)
            if "expert" in d.axes:
                assert spec[d.axes.index("expert")] == "model", path
            if name == world_script.HYMBA_5 and "heads" in d.axes:
                assert spec[d.axes.index("heads")] is None, path


@pytest.mark.parametrize("name", CONFIGS)
def test_the_pod_runtime_equals_the_meshless_round(world, name):
    r = world["ranks"][0][name]["run"]
    assert r["params"] <= 1e-5, (r["worst"], r["params"])
    assert r["w"] <= 1e-6, r
    assert r["loss"] <= 1e-5 and r["acc"] <= 1e-5, r
    assert abs(r["mass"] - N_PODS) <= 1e-4, r


@pytest.mark.parametrize("name", HELD)
def test_the_pod_runtime_equals_the_reference_s_host_mesh_round(world,
                                                                 name):
    """xlstm-350m and dbrx-132b against the reference's ``make_round_step``
    on its (2, 2, 2) host mesh, under its default executor."""
    ref = world["reference"][name]
    got = world["states"][name]
    ref_params = {"/".join(p): x for p, x in leaves(ref["params"])}
    assert sorted(ref_params) == sorted(got["params"])
    for path, a in got["params"].items():
        b = ref_params[path].astype(np.float64)
        scale = np.abs(b).max()
        assert np.abs(a - b).max() <= 1e-5 * scale, path
    np.testing.assert_allclose(got["w"], ref["w"], rtol=0, atol=1e-6)
    for a, b in zip(got["metrics"], ref["metrics"]):
        assert abs(a["loss"] - b["loss"]) <= 1e-5 * abs(b["loss"])
        assert abs(a["acc"] - b["acc"]) <= 1e-5
    assert abs(float(got["w"].sum()) - N_PODS) <= 1e-4


@pytest.mark.parametrize("name", CONFIGS)
def test_global_norm_sums_every_shard_of_the_replica(world, name):
    """``core.sam.global_norm`` of a placed replica is the whole
    replica's, for every family's placement."""
    for rank in world["ranks"]:
        n = rank[name]["norm"]
        assert abs(n["placed"] - n["whole"]) <= 1e-6 * n["whole"], n


@pytest.mark.parametrize("name", ARCHS)
def test_the_dry_run_rules_equal_the_measured_collectives(world, name):
    """The bytes and counts of each collective kind that rank 0 issued in
    the round equal ``launch.dryrun.collectives`` — the rules of
    ``roofline.analysis``, the expert rule among them — for the same
    reduced config on the same (2, 2, 2) mesh, given as an abstract mesh:
    2 rows of 16 positions a device, K = 2 steps of 2 SAM passes, 2 pods,
    "xla" gossip."""
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import AbstractMesh
    from repro_torch.models.registry import get_model_api

    api = get_model_api(world_script.config(name))
    mesh = AbstractMesh(Duck.axis_names, Duck.shape)
    want = dryrun.collectives(api, mesh, "train", B // Duck.shape["data"],
                              S, 2, steps=K, n_pods=N_PODS, gossip="xla")
    got = world["ranks"][0][name]["collectives"]
    assert got["bytes"] == want.bytes_by_kind, (got, want)
    assert got["count"] == want.count_by_kind, (got, want)


# The reduced xlstm with 2 heads on the (2, 1, 4) mesh: each head's
# columns on 2 ranks of "model" (``models.xlstm._mlstm_sub_head``, and
# every sLSTM head on every rank).  Held as the six families are (the
# module docstring): params to 1e-5 of each leaf's largest magnitude.  The
# largest errors measured are on ``mlstm/ln``, the zeros-initialised leaf
# whose gradient sums cancelling terms: 3.8e-6 against the mesh-less round
# and 6.6e-6 against the reference's, beside the six families' 3.3e-6 and
# 4.7e-6 (a head's q, k and v gradients summed over 2 ranks, and 4 ranks'
# output rows, add two partial sums to the whole-heads path).
SUB_HEAD_MESHLESS = 1e-5
SUB_HEAD_REFERENCE = 1e-5


def test_xlstm_over_a_model_axis_wider_than_its_heads(world):
    """The sub-head mLSTM round against the mesh-less port round, and every
    rank's blocks: a quarter of ``wq``'s columns (half a head), the sLSTM's
    recurrent weights whole."""
    r = world["ranks"][0][XLSTM_2]["run"]
    assert r["params"] <= SUB_HEAD_MESHLESS, (r["worst"], r["params"])
    assert r["w"] <= 1e-6, r
    assert r["loss"] <= 1e-5 and r["acc"] <= 1e-5, r
    assert abs(r["mass"] - N_PODS) <= 1e-4, r
    for rank in world["ranks"]:
        shards = rank[XLSTM_2]["shards"]
        assert shards["mlstm/wq"][-1] == shards["mlstm/wq"][-2] // 4
        assert shards["slstm/r"][-3] == 2  # both heads


def test_xlstm_over_a_model_axis_wider_than_its_heads_equals_the_reference(
        world):
    """The same round against the reference's ``make_round_step`` on its
    (2, 1, 4) host mesh."""
    ref = world["reference"][XLSTM_2]
    got = world["states"][XLSTM_2]
    ref_params = {"/".join(p): x for p, x in leaves(ref["params"])}
    assert sorted(ref_params) == sorted(got["params"])
    for path, a in got["params"].items():
        b = ref_params[path].astype(np.float64)
        assert np.abs(a - b).max() <= SUB_HEAD_REFERENCE * np.abs(b).max(), \
            path
    np.testing.assert_allclose(got["w"], ref["w"], rtol=0, atol=1e-6)
    for a, b in zip(got["metrics"], ref["metrics"]):
        assert abs(a["loss"] - b["loss"]) <= 1e-5 * abs(b["loss"])
        assert abs(a["acc"] - b["acc"]) <= 1e-5


@pytest.mark.parametrize("label", list(world_script.COUNTED))
def test_a_rank_counts_what_the_fake_world_traces(world, label):
    """What ``roofline.cost.CostMode`` counts on rank 0 of the gloo world in
    one real round of the 2-head xlstm (FLOPs, bytes, kernel records and
    collectives; K = 1, 2 SAM passes) equals the dry-run's meta trace of
    rank 0 of a fake world of the same mesh
    (``launch.dryrun.trace_placed``): the same sizes, the same step
    configuration.  Exact."""
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import AbstractMesh
    from repro_torch.launch.steps import StepConfig
    from repro_torch.models.registry import get_model_api

    shape, axes = world_script.COUNTED[label]
    api = get_model_api(world_script.config(XLSTM_2))
    want = dryrun.trace_placed(api, world_script.counted_shape(),
                               "round_step",
                               AbstractMesh(axes, dict(zip(axes, shape))),
                               StepConfig(**world_script.COUNTED_STEP))
    got = world["ranks"][0]["counts"][label]
    assert got["collectives"] == want["collectives"]
    assert got["kernels"] == want["kernels"]
    assert (got["flops"], got["bytes accessed"]) == (
        want["flops"], want["bytes accessed"])
