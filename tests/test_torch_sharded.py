"""The row-sharded bank (``make_program(..., mesh=)``, ``FLTrainer(mesh=)``,
the all-gather and halo executors) in an 8-rank CPU world over gloo, as the
reference's ``tests/test_sharded.py`` holds its GSPMD program on 8 forced
host devices: n = 64 clients, 8 rows a rank.

The world is spawned once for the whole file (``_torch_sharded_world.py``,
one process a rank, torch on one intra-op thread); every rank runs the
unsharded port program beside the sharded one on the same seed, and rank 0
writes what it measured.  The tests then hold it:

* each executor's mix on equal inputs, the rank's rows against the
  unsharded mix: the all-gather and halo executors bit for bit (the gather
  kernel's slot order is kept), the dense row panel within 1e-6 of the
  bank's magnitude;
* sharded against unsharded rounds (ring, kout dense and sparse, two_tier
  with 8 pods and with 4, each over two ranks, top-k EF with delayed
  links): bank within 1e-5 of its
  magnitude (the local steps run on 8 rows against 64, which may block
  differently), w within 1e-6, loss and accuracy within 1e-6, the mass n
  within 1e-3;
* halo against all-gather (bit for bit: both sharded) against unsharded
  (as above) under drops, delays and churn, the mass every round;
* the sharded rounds against the JAX reference's (``REFERENCE`` in the
  world: every configuration no unsharded test holds against it, under
  both executors), each restarted from the reference's state and fed its
  draws, which this file records before it spawns the world: the bank and
  the in-flight payload ``bufx`` within 1e-5 of the bank's magnitude plus,
  under top-k EF, the flip bound of ``test_torch_round_compress.py`` over
  the senders that swapped each coordinate (kept by one package and
  dropped by the other); w, the in-flight mass ``bufw`` within 1e-6;
  momentum within 1e-5 of its magnitude; the EF residual within 1e-5 of
  the bank's magnitude plus one flip;
  the liveness equal; the mean metrics within 1e-5 (the round-parity
  tests' bounds), the sums over the n clients (``w_mass``, ``w_inflight``,
  ``dead_mass``) within n x 1e-6, w's bound summed over the clients (the
  reference's own f32 ``w_mass`` lies up to 2.7e-5 from the exact sum of
  its w at n = 64);
* a sharded checkpoint: an unsharded restore equals the saved state bit for
  bit and its next round the sharded run's within the round tolerance, a
  sharded restore's next round the sharded run's bit for bit, and the file
  is read by the reference's ``restore_state``.
"""
import json
import os
import pickle
import socket
import subprocess
import sys

import numpy as np
import pytest

from _torch_sharded_world import (
    CONFIGS,
    EQUIVALENCE,
    HALO,
    N,
    REFERENCE,
    REFERENCE_ROUNDS,
    WORLD,
    world_data,
)
from _torch_threads import one_thread  # noqa: F401,E402  (an autouse fixture)

HERE = os.path.dirname(os.path.abspath(__file__))
TIMEOUT = 300
MASS_METRICS = ("w_mass", "w_inflight", "dead_mass")


def _reference_rounds() -> dict:
    """The JAX reference's rounds of each ``REFERENCE`` configuration,
    unsharded from its own seed: the state before and after each round,
    the round's draws (as the port takes them) and its metrics."""
    import jax.numpy as jnp

    from _torch_parity import reference_draws, scenario_state_dump
    from repro.core import ChurnModel, FLTrainer, LinkModel, TopologyConfig
    from repro.core import make_algo
    from repro.models.small import tiny_mlp

    model = tiny_mlp(in_dim=8, hidden=6, n_classes=2)
    data = world_data()
    out = {}
    for name in REFERENCE:
        topo, (algo, akw), link, churn = CONFIGS[name]
        tr = FLTrainer(model.loss, model.init,
                       {k: jnp.asarray(v) for k, v in data.items()},
                       make_algo(algo, **akw), TopologyConfig(**topo), seed=0,
                       gossip="sparse",
                       link=None if link is None else LinkModel(**link),
                       churn=None if churn is None else ChurnModel(**churn))
        rounds = []
        for _ in range(REFERENCE_ROUNDS):
            pre = scenario_state_dump(tr)
            draws = reference_draws(tr, data["x"].shape[1])
            metrics = {k: float(v) for k, v in tr.run_round().items()}
            rounds.append({"pre": pre, "draws": draws, "metrics": metrics,
                           "post": scenario_state_dump(tr)})
        out[name] = rounds
    return out


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    out = tmp_path_factory.mktemp("world")
    reference = out / "reference.pkl"
    with open(reference, "wb") as f:
        pickle.dump(_reference_rounds(), f)
    port = _free_port()
    env = {**os.environ, "OMP_NUM_THREADS": "1", "MKL_NUM_THREADS": "1",
           "PYTHONPATH": os.path.join(os.path.dirname(HERE), "src")}
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(HERE, "_torch_sharded_world.py"),
         "--rank", str(r), "--world", str(WORLD), "--port", str(port),
         "--out", str(out), "--reference", str(reference)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env)
        for r in range(WORLD)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    failed = [(r, p.returncode, log[-3000:])
              for r, (p, log) in enumerate(zip(procs, logs)) if p.returncode]
    assert not failed, failed
    with open(out / "results.json") as f:
        return json.load(f)


def test_the_world_has_eight_shards_of_eight_rows(world):
    assert (world["world"], world["m"]) == (WORLD, N // WORLD)
    for case in world["equivalence"].values():
        assert case["rows"] == N // WORLD


@pytest.mark.parametrize("family", ["ring", "exponential", "kout", "two_tier"])
def test_executors_mix_equals_the_unsharded_mix(world, family):
    r = world["mix"][family]
    assert r["static"] == (family in ("ring", "exponential"))
    assert r["allgather_equal"] and r["halo_equal"]
    assert r["dense"] <= 1e-6 * r["dense_scale"]


@pytest.mark.parametrize("case", list(EQUIVALENCE))
def test_sharded_rounds_equal_the_unsharded_port(world, case):
    for i, r in enumerate(world["equivalence"][case]["rounds"]):
        assert r["params"] <= 1e-5 * r["scale"], (case, i, r)
        assert r["w"] <= 1e-6, (case, i, r)
        for k in ("loss", "acc", "w_mass"):
            assert r.get(k, 0.0) <= 1e-6, (case, i, k, r)
        for k in ("comp", "bufx"):
            assert r.get(k, 0.0) <= 1e-5 * r["scale"], (case, i, k, r)
        assert abs(r["mass"] - N) < 1e-3, (case, i, r)


@pytest.mark.parametrize("case", HALO)
def test_halo_equals_allgather_equals_unsharded(world, case):
    res = world["halo"][case]
    assert res["backend"] == "HaloBackend"
    for i, r in enumerate(res["rounds"]):
        assert r["halo_equals_allgather"], (case, i, r)
        assert r["halo_vs_unsharded"] <= 1e-5 * r["scale"], (case, i, r)
        assert r["w"] <= 1e-6, (case, i, r)
        assert abs(r["mass"] - N) < 1e-3, (case, i, r)
        if not np.isnan(r["w_mass"]):
            assert abs(r["w_mass"] - N) < 1e-3, (case, i, r)


@pytest.mark.parametrize("gossip", ["xla", "halo"])
@pytest.mark.parametrize("case", REFERENCE)
def test_sharded_rounds_hold_parity_with_the_reference(world, case, gossip):
    res = world["reference"][f"{case}/{gossip}"]
    assert res["backend"] == ("HaloBackend" if gossip == "halo" else "str")
    assert len(res["rounds"]) == REFERENCE_ROUNDS
    for i, r in enumerate(res["rounds"]):
        assert r["params_excess"] <= 0.0, (case, gossip, i, r)
        assert r.get("bufx_excess", 0.0) <= 0.0, (case, gossip, i, r)
        assert r["w"] <= 1e-6 and r.get("bufw", 0.0) <= 1e-6, (case, i, r)
        assert r["mom"] <= 1e-5 * r["mom_scale"], (case, gossip, i, r)
        assert r.get("comp", 0.0) <= 1e-5 * r["scale"] + r["step"], (
            case, gossip, i, r)
        assert r.get("live_equal", True), (case, gossip, i, r)
        for k, v in r["metrics"].items():
            tol = N * 1e-6 if k in MASS_METRICS else 1e-5
            assert v <= tol, (case, gossip, i, k, r)
        assert abs(r["mass"] - N) < 1e-3, (case, gossip, i, r)


def test_a_sharded_checkpoint_resumes(world):
    c = world["checkpoint"]
    assert c["restored_equal"]
    assert c["rows_after_restore"] == N // WORLD
    assert c["round_after_restore"] == c["saved_round"]
    assert c["sharded_equal"] and c["sharded_loss"] == 0.0
    assert c["unsharded_params"] <= 1e-5 * c["scale"]
    assert c["unsharded_loss"] <= 1e-6


def test_a_sharded_checkpoint_is_read_by_the_reference(world):
    import jax

    from repro.checkpoint import restore_state as ref_restore_state
    from repro.core.flat import make_spec as ref_make_spec
    from repro.models.small import tiny_mlp as ref_tiny_mlp
    from repro_torch.checkpoint import restore_state
    from repro_torch.core.flat import make_spec
    from repro_torch.models.small import tiny_mlp

    path = world["checkpoint"]["path"]
    ref_spec = ref_make_spec(jax.eval_shape(
        ref_tiny_mlp(in_dim=8, hidden=6, n_classes=2).init,
        jax.random.PRNGKey(0)))
    port_model = tiny_mlp(in_dim=8, hidden=6, n_classes=2)
    import torch

    spec = make_spec(port_model.init(torch.Generator().manual_seed(0)))
    ref = jax.device_get(ref_restore_state(path, ref_spec))
    port = restore_state(path, spec)
    assert int(ref.round) == port.round == world["checkpoint"]["saved_round"]
    assert np.asarray(ref.params).shape == (N, spec.dim)
    for k in ("params", "mom", "w", "losses"):
        np.testing.assert_array_equal(np.asarray(getattr(ref, k)),
                                      getattr(port, k).numpy(), err_msg=k)
    assert abs(float(np.asarray(ref.w).sum()) - N) < 1e-3
