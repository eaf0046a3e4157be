"""The port's training launcher (``repro_torch.launch.train``) on the CPU at
``reduced`` glm4-9b (f32, 2 layers), 2 pods, K = 2, 2 x 16 tokens a step:
``--smoke`` runs and conserves the push-sum mass; per-round and superstep
dispatch give the same state; a run resumed from its checkpoint equals the
uninterrupted run bit for bit; the rounds after a checkpoint equal the
reference's ``make_round_step`` run from that checkpoint (restored by the
reference's ``checkpoint.restore(like=...)``); pod checkpoints (params,
``v``, ``w``, ``round``, ``comp``, ``link``) cross both ways between the
packages' ``checkpoint.save`` / ``restore(like=...)``; ``--paged`` runs
and resumes its store; and ``--host-mesh`` runs the pod runtime on the
reference's (2, 2, 2) mesh in an 8-rank world under
``torch.distributed.run`` (gloo), its log and its checkpoint (gathered
whole by rank 0) equal to the mesh-less run's within the pod runtime's
tolerance (``test_torch_pod_runtime.py``), for glm4-9b and for the
launcher's default arch, xlstm-350m.

Tolerance: the port's rounds against the reference's: f32 sums in their
own orders, params and ``v`` to 1e-5 of each leaf's largest magnitude
(``test_torch_round_step.py`` measured 1e-6), ``w`` to 1e-6.  Everything
within the port is deterministic on the CPU: bit for bit.
"""
import os
import shutil
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import checkpoint as ref_ckpt
from repro.configs import registry as ref_registry
from repro.core.stages import LinkState as RefLinkState
from repro.data.synthetic import make_lm_stream as ref_make_lm_stream
from repro.launch import steps as ref_steps
from repro.models.registry import get_model_api as ref_get_model_api
from repro_torch import checkpoint
from repro_torch.core.flat import tree_flatten
from repro_torch.core.stages import LinkState
from repro_torch.launch import train

BASE = ["--arch", "glm4-9b", "--smoke", "--seq", "16", "--batch", "2",
        "--device", "cpu"]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this file's small tensors: the suite runs
    files in parallel workers, and a thread pool per worker oversubscribes
    the cores (tiny ops then wait on each other's spinning threads)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _leaves(tree):
    return tree_flatten(tree)[1]


def _equal_states(a, b):
    for key in ("params", "v"):
        for x, y in zip(_leaves(a[key]), _leaves(b[key])):
            assert torch.equal(x, y), key
    assert torch.equal(a["w"], b["w"])


def test_smoke_run_on_the_cpu():
    rec = train.main(BASE + ["--rounds", "2"])
    assert [h["round"] for h in rec["history"]] == [0, 1]
    for h in rec["history"]:
        assert np.isfinite(h["loss"]) and 0.0 <= h["acc"] <= 1.0
        assert abs(h["w_mass"] - train.N_PODS) < 1e-6
    assert rec["params"]["embed"].shape[0] == train.N_PODS
    # The launcher's default arch, xlstm-350m, reduced.
    rec = train.main(["--device", "cpu", "--smoke", "--rounds", "1",
                      "--batch", "2", "--seq", "16"])
    assert rec["api"].cfg.name == "xlstm-350m"
    assert np.isfinite(rec["history"][0]["loss"])
    assert abs(rec["history"][0]["w_mass"] - train.N_PODS) < 1e-6


def test_superstep_and_resume_equal_the_uninterrupted_run(tmp_path):
    full = str(tmp_path / "full")
    per_round = train.main(BASE + ["--rounds", "4"])
    rec = train.main(BASE + ["--rounds", "4", "--superstep", "2",
                             "--ckpt-dir", full])
    _equal_states(per_round, rec)
    for a, b in zip(per_round["history"], rec["history"]):
        assert (a["loss"], a["acc"], a["w_mass"]) == (
            b["loss"], b["acc"], b["w_mass"])
    assert sorted(os.listdir(full)) == ["ckpt_1.npz", "ckpt_3.npz"]

    # Interrupted after the first superstep: only round 1's file is there.
    cut = str(tmp_path / "cut")
    os.makedirs(cut)
    shutil.copy(os.path.join(full, "ckpt_1.npz"), cut)
    resumed = train.main(BASE + ["--rounds", "4", "--superstep", "2",
                                 "--ckpt-dir", cut, "--resume"])
    assert [h["round"] for h in resumed["history"]] == [2, 3]
    _equal_states(resumed, rec)
    for a, b in zip(resumed["history"], rec["history"][2:]):
        assert (a["loss"], a["acc"]) == (b["loss"], b["acc"])


def test_rounds_after_a_checkpoint_match_the_reference(tmp_path):
    d = str(tmp_path)
    rec = train.main(BASE + ["--rounds", "4", "--superstep", "2",
                             "--ckpt-dir", d])
    ref_api = ref_get_model_api(ref_registry.get_config("glm4-9b",
                                                        smoke=True))
    p = jax.eval_shape(ref_api.init, jax.random.PRNGKey(0))
    stacked = jax.tree.map(
        lambda x: np.zeros((train.N_PODS,) + x.shape, x.dtype), p)
    like = {"params": stacked, "v": stacked,
            "w": np.zeros((train.N_PODS,), np.float32),
            "round": np.zeros((), np.int32)}
    st = ref_ckpt.restore(os.path.join(d, "ckpt_1.npz"), like=like)
    assert int(st["round"]) == 1
    state = tuple(jax.tree.map(jnp.asarray, st[k]) for k in ("params", "v",
                                                             "w"))
    cfg = ref_steps.StepConfig(lr=0.05, alpha=0.9, rho=0.05, local_steps=2)
    round_step = jax.jit(ref_steps.make_round_step(ref_api, cfg))
    toks = np.asarray(ref_make_lm_stream(ref_api.cfg.vocab_size, 16,
                                         4 * train.N_PODS * 2 * 2))
    toks = toks.reshape(4, train.N_PODS, 2, 2, 16)
    params, v, w = state
    for r in (2, 3):
        params, v, w, _, _, m = round_step(
            params, v, w, (), (), {"tokens": jnp.asarray(toks[r])},
            ref_steps.pod_mixing_matrix(train.N_PODS))
        h = rec["history"][r]
        assert h["loss"] == pytest.approx(float(m["loss"]), rel=1e-5)
        assert h["acc"] == float(m["acc"])
    want = jax.device_get((params, v))
    for got, ref in ((rec["params"], want[0]), (rec["v"], want[1])):
        paths, leaves = tree_flatten(got)
        for path, leaf in zip(paths, leaves):
            r_leaf = ref
            for k in path:
                r_leaf = r_leaf[k]
            scale = float(np.abs(r_leaf).max())
            assert float(np.abs(leaf.numpy() - r_leaf).max()) <= 1e-5 * scale
    np.testing.assert_allclose(rec["w"].numpy(), np.asarray(w), atol=1e-6)


def _pod_trees(seed):
    rng = np.random.default_rng(seed)
    params = {"layers": {"w": rng.standard_normal((2, 3, 4)).astype(
        np.float32)}, "embed": rng.standard_normal((2, 5)).astype(np.float32)}
    v = {"layers": {"w": rng.standard_normal((2, 3, 4)).astype(np.float32)},
         "embed": rng.standard_normal((2, 5)).astype(np.float32)}
    extra = {"w": np.array([0.75, 1.25], np.float32),
             "round": np.int32(4),
             "comp": rng.standard_normal((2, 17)).astype(np.float32),
             "bufx": rng.standard_normal((2, 2, 17)).astype(np.float32),
             "bufw": rng.random((2, 2)).astype(np.float32)}
    return params, v, extra


def _port_tree(params, v, extra, link=True):
    t = {k: torch.from_numpy(np.array(x)) for k, x in params.items()
         if k != "layers"}
    tree = {
        "params": {**t, "layers": {"w": torch.from_numpy(params["layers"]["w"])}},
        "v": {"embed": torch.from_numpy(v["embed"]),
              "layers": {"w": torch.from_numpy(v["layers"]["w"])}},
        "w": torch.from_numpy(extra["w"]), "round": extra["round"],
        "comp": torch.from_numpy(extra["comp"]),
    }
    if link:
        tree["link"] = LinkState(torch.Generator().manual_seed(11),
                                 torch.from_numpy(extra["bufx"]),
                                 torch.from_numpy(extra["bufw"]))
    return tree


def _ref_tree(params, v, extra, link=True):
    tree = {"params": jax.tree.map(jnp.asarray, params),
            "v": jax.tree.map(jnp.asarray, v),
            "w": jnp.asarray(extra["w"]), "round": extra["round"],
            "comp": jnp.asarray(extra["comp"])}
    if link:
        tree["link"] = RefLinkState(jax.random.PRNGKey(3),
                                    jnp.asarray(extra["bufx"]),
                                    jnp.asarray(extra["bufw"]))
    return tree


def test_pod_checkpoints_cross_both_ways(tmp_path):
    params, v, extra = _pod_trees(0)
    # The port's file, read by the reference (the link key as the JAX key
    # words of its generator's seed).
    path = checkpoint.save(str(tmp_path / "port"), 4,
                           _port_tree(params, v, extra))
    zeros = jax.tree.map(np.zeros_like, (params, v, extra))
    got = ref_ckpt.restore(path, like=_ref_tree(*zeros))
    np.testing.assert_array_equal(got["params"]["layers"]["w"],
                                  params["layers"]["w"])
    np.testing.assert_array_equal(got["v"]["embed"], v["embed"])
    np.testing.assert_array_equal(got["comp"], extra["comp"])
    np.testing.assert_array_equal(got["link"].bufx, extra["bufx"])
    np.testing.assert_array_equal(got["link"].bufw, extra["bufw"])
    assert int(got["round"]) == 4
    np.testing.assert_array_equal(np.asarray(got["link"].key),
                                  np.array([0, 11], np.uint32))
    # ... and by the port itself, generator state included.
    like = _port_tree(*zeros)
    mine = checkpoint.restore(path, like=like)
    assert torch.equal(mine["link"].bufx, torch.from_numpy(extra["bufx"]))
    g = torch.Generator().manual_seed(11)
    assert torch.equal(mine["link"].key.get_state(), g.get_state())
    assert mine["link"].last == ()

    # The reference's file, read by the port: every array; the link key is
    # a JAX key, which no torch.Generator can take.
    rpath = ref_ckpt.save(str(tmp_path / "ref"), 4,
                          _ref_tree(params, v, extra, link=False))
    back = checkpoint.restore(rpath, like=_port_tree(*zeros, link=False))
    assert torch.equal(back["params"]["embed"],
                       torch.from_numpy(params["embed"]))
    assert torch.equal(back["v"]["layers"]["w"],
                       torch.from_numpy(v["layers"]["w"]))
    assert torch.equal(back["w"], torch.from_numpy(extra["w"]))
    assert torch.equal(back["comp"], torch.from_numpy(extra["comp"]))
    assert int(back["round"]) == 4
    lpath = ref_ckpt.save(str(tmp_path / "refl"), 4,
                          _ref_tree(params, v, extra))
    with pytest.raises(ValueError, match="JAX PRNG key"):
        checkpoint.restore(lpath, like=_port_tree(*zeros))
    with pytest.raises(ValueError, match="structure mismatch"):
        checkpoint.restore(lpath, like=_port_tree(*zeros, link=False))


def test_paged_driver_runs_and_resumes(tmp_path):
    """``--paged``: a population of 64 clients in a store under
    ``--store-dir``, 8 active a round; the store is the checkpoint, and
    ``--resume`` reopens it at the next round with the mass still n."""
    argv = ["--paged", "--n-clients", "64", "--k-active", "8",
            "--store-dir", str(tmp_path / "pop"), "--device", "cpu"]
    rec = train.main(argv + ["--rounds", "1"])
    assert abs(rec["mass"] - 64) < 1e-3
    assert rec["trainer"].runner.round_index == 1
    with pytest.raises(SystemExit, match="already holds a client store"):
        train.main(argv + ["--rounds", "1"])
    rec = train.main(argv + ["--rounds", "1", "--resume"])
    assert rec["trainer"].runner.round_index == 2
    assert abs(rec["mass"] - 64) < 1e-3


def test_host_mesh_under_torch_distributed_run(tmp_path):
    """``--host-mesh`` in the 8-rank world of ``torch.distributed.run``,
    resumed from a mesh-less run's round-1 checkpoint (the shards placed
    from the whole file) for round 2: the mesh-less run's metrics (to the 4
    printed digits), ``w_mass=2.0000``, and rank 0's round-2 checkpoint
    (the reference's file tree, the shards gathered whole) within 1e-5 of
    each leaf's magnitude of the mesh-less run's."""
    base = ["--smoke", "--device", "cpu", "--arch", "glm4-9b", "--seq", "16",
            "--batch", "4", "--rounds", "3", "--superstep", "2"]
    meshless, ckpt = str(tmp_path / "meshless"), str(tmp_path / "mesh")
    train.main(base[:-4] + ["--rounds", "2", "--superstep", "2",
                            "--ckpt-dir", meshless])
    shutil.copytree(meshless, ckpt)
    want = train.main(base + ["--ckpt-dir", meshless, "--resume"])
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    src = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                       "src")
    env = {**os.environ, "OMP_NUM_THREADS": "1", "PYTHONPATH": src}
    r = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--nnodes", "1",
         "--nproc-per-node", "8", "--master-port", str(port), "-m",
         "repro_torch.launch.train", "--host-mesh"] + base
        + ["--ckpt-dir", ckpt, "--resume"],
        capture_output=True, text=True, env=env, timeout=600)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-3000:]
    lines = [ln for ln in r.stdout.splitlines() if ln.startswith("[train]")]
    assert "resumed" in lines[0]
    assert "2 pods x {'pod': 2, 'data': 2, 'model': 2}" in lines[1]
    rounds = [ln for ln in lines if "] round" in ln]
    assert len(rounds) == 1  # rank 0 logs, the others do not
    h = want["history"][0]
    assert h["round"] == 2 and "round    2" in rounds[0]
    assert f"loss={h['loss']:.4f} acc={h['acc']:.4f}" in rounds[0], (
        rounds[0], h)
    assert "w_mass=2.0000" in rounds[0]
    assert sorted(os.listdir(ckpt)) == ["ckpt_1.npz", "ckpt_2.npz"]
    like = {"params": want["params"], "v": want["v"], "w": want["w"],
            "round": np.zeros((), np.int32)}
    saved = checkpoint.restore(os.path.join(ckpt, "ckpt_2.npz"), like=like)
    assert int(saved["round"]) == 2
    for key in ("params", "v"):
        for a, b in zip(tree_flatten(saved[key])[1],
                        tree_flatten(want[key])[1]):
            assert (a - b).abs().max() <= 1e-5 * b.abs().max()
    assert (saved["w"] - want["w"]).abs().max() <= 1e-6


def test_host_mesh_default_arch_under_torch_distributed_run():
    """The reference's ``test_train_cli_host_mesh`` command: ``--host-mesh``
    with no ``--arch`` runs the launcher's default, xlstm-350m, its replicas
    placed over the (data, model) submeshes of the 8-rank world (its heads
    and up-projections on "model"): each round prints the mesh-less run's
    loss and accuracy (to the 4 printed digits; the pod runtime's rounds
    differ from them by about 1e-7, ``test_torch_pod_families.py``) and
    ``w_mass=2.0000``."""
    args = ["--smoke", "--device", "cpu", "--rounds", "2", "--batch", "4",
            "--seq", "32"]
    want = train.main(args)["history"]
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    src = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                       "src")
    env = {**os.environ, "OMP_NUM_THREADS": "1", "PYTHONPATH": src}
    r = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--nnodes", "1",
         "--nproc-per-node", "8", "--master-port", str(port), "-m",
         "repro_torch.launch.train", "--host-mesh"] + args,
        capture_output=True, text=True, env=env, timeout=600)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-3000:]
    lines = [ln for ln in r.stdout.splitlines() if ln.startswith("[train]")]
    assert lines[0].startswith("[train] xlstm-350m | 2 pods x {'pod': 2, "
                               "'data': 2, 'model': 2}"), lines[0]
    rounds = [ln for ln in lines if "] round" in ln]
    assert len(rounds) == 2
    for line, h in zip(rounds, want):
        got = dict(kv.split("=") for kv in line.split()[3:6])
        assert abs(float(got["loss"]) - h["loss"]) <= 1.5e-4, (line, h)
        assert abs(float(got["acc"]) - h["acc"]) <= 1.5e-4, (line, h)
        assert got["w_mass"] == "2.0000", line


def test_host_mesh_refuses_without_a_launcher(monkeypatch):
    for key in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(key, raising=False)
    with pytest.raises(SystemExit, match="torch.distributed.run"):
        train.main(["--host-mesh", "--smoke", "--device", "cpu", "--arch",
                    "glm4-9b", "--rounds", "1"])
