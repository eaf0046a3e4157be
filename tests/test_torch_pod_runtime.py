"""The pod runtime in an 8-rank CPU world (``tests/_torch_pod_world.py``,
gloo): reduced glm4-9b on the reference's ``(2, 2, 2)`` ``("pod", "data",
"model")`` host mesh, 2 pods, K = 2 local steps of 4 x 16 tokens, 2 rounds,
under ``gossip`` "auto", "xla" and "halo" — held to the mesh-less port round
and to the reference's own ``make_round_step`` on its (2, 2, 2) host mesh
(8 forced host devices, a subprocess beside the world, as
``tests/test_launch.py`` runs its multi-device checks), from the same
initial params (``interop``) and token batches (``make_lm_stream``).  Also: each rank's shard shapes, the global
norm over every shard, GQA with kv heads that do not divide the model axis,
reduced xlstm-350m on a pod-only (2, 1, 1) world, and the bytes and
counts of each collective kind that a rank issues in one round ("xla",
"halo", and "xla" with FSDP on) against the dry-run's rules
(``launch.dryrun.collectives`` over ``roofline.analysis``).

Tolerances: the sharded forward sums row-parallel partial products over
the model axis and the gradients over the data axis in other orders than
the whole replica (about 1e-7 relative per sum); two SAM passes, K = 2
steps and 2 rounds carry that into the params (measured at most 1.1e-6 of
a leaf's largest magnitude against either round).  So params are held to
1e-5 of each leaf's largest magnitude, w to 1e-6, loss and accuracy to
1e-5, and the mass to 2 within 1e-4.  Halo against xla is bit for bit: both
mix the same gathered rows with the same kernel and slot order.
"""
from __future__ import annotations

import json
import os
import pickle
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs.registry import get_config as ref_config
from repro.data.synthetic import make_lm_stream as ref_make_lm_stream
from repro.launch import sharding as ref_sharding
from repro.models.registry import get_model_api as ref_api

from _torch_dryrun_ref import leaves
from _torch_threads import one_thread  # noqa: F401,E402  (an autouse fixture)

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(os.path.dirname(HERE), "src")
WORLD = 8
N_PODS, K, B, S, ROUNDS = 2, 2, 4, 16, 2
MODES = ("auto", "xla", "halo")
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
    ref = pickle.load(f)
mesh = make_host_mesh((2, 2, 2), ("pod", "data", "model"))
cfg = get_config("glm4-9b", smoke=True)
api = get_model_api(cfg)
step_cfg = StepConfig(lr=0.05, alpha=0.9, rho=0.05, local_steps=2)
nl = pod_mixing_neighbors(2)
with shlib.use_mesh(mesh, fsdp=cfg.fsdp):
    def shard(x, d):
        spec = shlib.spec_for(d, mesh, fsdp=cfg.fsdp)
        return jax.device_put(jnp.asarray(x),
                              NamedSharding(mesh, P("pod", *spec)))

    gossip = sys.argv[3]
    params = jax.tree.map(shard, ref["params"], api.param_defs(),
                          is_leaf=lambda x: isinstance(x, PDef))
    v = jax.tree.map(jnp.zeros_like, params)
    w = jnp.ones((2,))
    step = jax.jit(make_round_step(api, step_cfg, gossip=gossip))
    ms = []
    for tk in ref["tokens"]:
        params, v, w, _, _, m = step(params, v, w, (), (),
                                     {"tokens": jnp.asarray(tk)}, nl)
        ms.append({"loss": float(m["loss"]), "acc": float(m["acc"])})
    out = {"params": jax.tree.map(np.asarray, jax.device_get(params)),
           "w": np.asarray(w), "metrics": ms}
with open(sys.argv[2], "wb") as f:
    pickle.dump(out, f)
"""


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _initial(path):
    """The reference's initial pod-stacked params (two distinct replicas,
    ``[x, x / 2]``, so that the first mix moves them) and its token
    batches, as numpy."""
    api = ref_api(ref_config("glm4-9b", smoke=True))
    p = api.init(jax.random.PRNGKey(0))
    params = jax.tree.map(lambda x: np.asarray(jnp.stack([x, x * 0.5])), p)
    toks = np.asarray(ref_make_lm_stream(api.cfg.vocab_size, S,
                                         ROUNDS * N_PODS * K * B))
    with open(path, "wb") as f:
        pickle.dump({"params": params,
                     "tokens": toks.reshape(ROUNDS, N_PODS, K, B, S)}, f)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    out = tmp_path_factory.mktemp("pod_world")
    initial = out / "initial.pkl"
    _initial(initial)
    env = {**os.environ, "OMP_NUM_THREADS": "1", "MKL_NUM_THREADS": "1",
           "PYTHONPATH": SRC}
    env.pop("XLA_FLAGS", None)
    # The reference's round under its default executor, beside the world.
    reference = [subprocess.Popen(
        [sys.executable, "-c", _REFERENCE, str(initial),
         str(out / "reference.pkl"), "auto"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env={**env, "JAX_PLATFORMS": "cpu"})]
    port, port2 = _free_port(), _free_port()
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(HERE, "_torch_pod_world.py"),
         "--rank", str(r), "--port", str(port), "--port2", str(port2),
         "--out", str(out), "--reference", str(initial)],
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
    with open(out / "results.json") as f:
        results = json.load(f)
    with open(out / "states.pkl", "rb") as f:
        results["states"] = pickle.load(f)
    with open(out / "reference.pkl", "rb") as f:
        results["reference"] = pickle.load(f)
    return results


class Duck:
    axis_names = ("pod", "data", "model")
    shape = {"pod": 2, "data": 2, "model": 2}


def test_each_rank_holds_the_reference_s_shards(world):
    """Rank 0's local block of every placed leaf: its pod (one of 2) and
    the reference's ``spec_for`` block of the replica on (2, 2, 2)."""
    cfg = ref_config("glm4-9b", smoke=True)
    shards = world["glm"]["shards"]
    defs = dict(leaves(ref_api(cfg).param_defs()))
    assert sorted(shards) == sorted("/".join(p) for p in defs)
    for path, d in defs.items():
        spec = tuple(ref_sharding.spec_for(d, Duck(), fsdp=cfg.fsdp))
        spec += (None,) * (len(d.shape) - len(spec))
        want = [1] + [n // (Duck.shape[a] if a else 1)
                      for n, a in zip(d.shape, spec)]
        assert shards["/".join(path)] == want, path


@pytest.mark.parametrize("gossip", MODES + ("fsdp",))
def test_the_pod_runtime_equals_the_meshless_round(world, gossip):
    """Each gossip mode, and "xla" with FSDP on (the weights' embed dims
    on "data" too), against the mesh-less port round."""
    r = world["glm"]["runs"][gossip]
    assert r["params"] <= 1e-5, r
    assert r["v"] <= 1e-5, r
    assert r["w"] <= 1e-6, r
    assert r["loss"] <= 1e-5 and r["acc"] <= 1e-5, r
    assert abs(r["mass"] - N_PODS) <= 1e-4, r


def test_halo_equals_xla_bit_for_bit(world):
    assert world["glm"]["halo_vs_xla_equal"]


@pytest.mark.parametrize("gossip", MODES)
def test_the_pod_runtime_equals_the_reference_s_host_mesh_round(world,
                                                                 gossip):
    """Each gossip mode against the reference's ``make_round_step`` on its
    (2, 2, 2) host mesh under its default executor (its "xla" and "halo"
    rounds equal that one: ``tests/test_launch.py``)."""
    ref = world["reference"]
    got = world["states"][gossip]
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


def test_global_norm_sums_every_shard_of_the_replica(world):
    """``core.sam.global_norm`` of a placed replica is the whole
    replica's (the SAM step ``rho g / ||g||`` is the unsharded one); the
    rank's shards alone give a smaller norm, which would scale the step by
    about the square root of the shard count."""
    n = world["glm"]["norm"]
    assert abs(n["placed"] - n["whole"]) <= 1e-6 * n["whole"], n
    assert n["local"] < 0.9 * n["whole"], n


@pytest.mark.parametrize("case", ["4q-1kv", "6q-3kv"])
def test_gqa_with_kv_heads_that_do_not_divide_the_model_axis(world, case):
    """k and v stay replicated (their projections split on head_dim), each
    rank's query heads read their own kv heads, and the replicated k / v's
    gradient sums the ranks' shares."""
    r = world["glm"]["kv_replicated"][case]
    assert "Shard(dim=2)" in r["wk_placements"], r  # head_dim, not kv_heads
    assert r["y"] <= 1e-5 and r["grads"] <= 1e-5, r


def test_xlstm_on_a_pod_only_world_halo_matches_xla(world):
    """Reduced xlstm-350m on a (2, 1, 1) mesh (its replica whole on each
    rank): halo against xla with the reference's bounds
    (``tests/test_launch.py``: err < 1e-5, w rtol 1e-6, mass within
    1e-4)."""
    r = world["xlstm"]
    assert r["placed"], r  # DTensors, whole: the submesh is one device
    assert r["err"] < 1e-5, r
    assert r["w_rel"] <= 1e-6, r
    assert abs(r["mass"] - N_PODS) < 1e-4, r


@pytest.mark.parametrize("case", ["xla", "halo", "fsdp"])
def test_the_dry_run_rules_equal_the_measured_collectives(world, case):
    """The bytes and counts of each collective kind one rank issued in the
    first round (``gossip`` "xla", "halo", and "xla" with FSDP on) equal
    ``launch.dryrun.collectives`` — the rules of ``roofline.analysis`` —
    for the same reduced glm4-9b on the same (2, 2, 2) mesh, given as an
    abstract mesh: 2 rows of 16 positions a device, K = 2 steps of 2 SAM
    passes, 2 pods."""
    import dataclasses

    from repro_torch.configs.registry import get_config
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import AbstractMesh
    from repro_torch.models.registry import get_model_api

    cfg = get_config("glm4-9b", smoke=True)
    if case == "fsdp":
        cfg = dataclasses.replace(cfg, fsdp=True)
    mesh = AbstractMesh(Duck.axis_names, Duck.shape)
    want = dryrun.collectives(get_model_api(cfg), mesh, "train",
                              B // Duck.shape["data"], S, 2, steps=K,
                              n_pods=N_PODS,
                              gossip="halo" if case == "halo" else "xla")
    got = world["glm"]["collectives" + {"xla": "", "halo": "_halo",
                                        "fsdp": "_fsdp"}[case]]
    assert got["bytes"] == want.bytes_by_kind, (got, want)
    assert got["count"] == want.count_by_kind, (got, want)
