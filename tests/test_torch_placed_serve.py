"""Serving on the pod runtime's mesh in an 8-rank CPU world
(``tests/_torch_placed_serve_world.py``, gloo): ``launch.serve.generate``
on a replica placed over its pod's ``("data", "model")`` submesh of the
reference's ``(2, 2, 2)`` host mesh (and of a ``(2, 1, 4)`` mesh for an
xlstm with 2 heads), its prefill building the cache in the placement the
dry-run gives it (``launch.sharding.cache_spec``) and each decode step
reading and writing the rank's blocks.  Reduced configs with overrides
make each placement occur: the cache's kv heads on "model"; its head_dim
on "model" with q's heads there (FSDP on); a batch of 1 with its positions
on "data" and a window whose keys straddle two ranks, then lie on one;
MLA with the experts (deepseek-v3-671b); dbrx-132b; llava's image prefix;
hymba's SSM channels and meta tokens, with a batch of 4 and of 1; xlstm's
state on "model" by head, and whole where 2 heads are narrower than the
axis.  Prefill of 16 positions, then 3 decode steps.

Held to, against the mesh-less port from the same params (seed 0) and
prompts: equal greedy tokens; logits within 1e-5 of their largest
magnitude; the cache (gathered whole) within 1e-6 of each leaf's largest
magnitude, 4e-6 for the recurrent families.  The placed path sums partial
products over "model" (the row-parallel projections, the split scores,
the xLSTM gates, the SSM's dt, B and C) and the softmax over "data" in
other orders than the whole replica, about 1e-7 relative a sum; the
measured worst: 1.6e-6 on the logits, 7.8e-7 on an attention cache, and
1.8e-6 on a recurrent family's cache (xlstm's sLSTM cell after 19 steps,
each reading gates summed over "model"; hymba's SSM state 1.5e-6, its KV
1.2e-6).  That is rounding: the mesh-less path itself, every product's
contraction summed as two halves (the sum over a model axis of 2,
:class:`SplitSums`), moves the same caches by 1.1e-6 to 1.7e-6, and the
placed cache stays within twice that.  The head_dim and positions cases are also held to the reference's
``jax.jit(api.prefill)`` and ``jax.jit(make_serve_step(api))`` on the same
placements of its (2, 2, 2) host mesh (8 forced host devices, a
subprocess): equal tokens and logits within 1e-4 of their magnitude.  And
the bytes and counts of each collective kind one rank issues in a decode
step equal the dry-run's rules (``launch.dryrun.collectives``).
"""
from __future__ import annotations

import json
import os
import pickle
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

import _torch_placed_serve_world as world_script
from _torch_threads import one_thread  # noqa: F401,E402  (an autouse fixture)

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(os.path.dirname(HERE), "src")
WORLD = world_script.WORLD
CASES = world_script.CASES
S, NEW = world_script.S, world_script.NEW
TIMEOUT = 600
LOGITS = 1e-5
CACHE = 1e-6
RECURRENT_CACHE = 4e-6  # xlstm and hymba (the module docstring)
RECURRENT = ("hymba", "hymba_seq", "xlstm", "xlstm_wide")
REFERENCE_LOGITS = 1e-4

_REFERENCE = r"""
import dataclasses, os, pickle, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.configs.registry import get_config
from repro.launch import sharding as shlib
from repro.launch.mesh import make_host_mesh
from repro.launch.steps import make_serve_step
from repro.models.pdefs import PDef
from repro.models.registry import get_model_api

with open(sys.argv[1], "rb") as f:
    initial = pickle.load(f)
S, NEW = int(sys.argv[3]), int(sys.argv[4])
mesh = make_host_mesh((2, 2, 2), ("pod", "data", "model"))
out = {}
for name, case in initial.items():
    cfg = dataclasses.replace(get_config(case["arch"], smoke=True),
                              **case["overrides"])
    api = get_model_api(cfg)
    b = case["tokens"].shape[0]
    rows = ("pod", "data") if b % 4 == 0 else "data" if b % 2 == 0 else None

    def spec(d, fsdp):
        s = list(shlib.spec_for(d, mesh, fsdp=fsdp))
        s += [None] * (len(d.shape) - len(s))
        if rows == ("pod", "data"):
            s = [rows if a == "data" and ax == "batch" else a
                 for a, ax in zip(s, d.axes)]
        return NamedSharding(mesh, P(*s))

    is_def = lambda x: isinstance(x, PDef)  # noqa: E731
    with shlib.use_mesh(mesh, fsdp=cfg.fsdp):
        params = jax.tree.map(
            lambda x, d: jax.device_put(jnp.asarray(x), spec(d, cfg.fsdp)),
            case["params"], api.param_defs(), is_leaf=is_def)
        tok = NamedSharding(mesh, P(rows))
        batch = {"tokens": jax.device_put(jnp.asarray(case["tokens"]),
                                          NamedSharding(mesh, P(rows, None)))}
        cache_len = S + NEW
        logits, cache = jax.jit(api.prefill, static_argnums=(2,))(
            params, batch, cache_len)
        cache = jax.tree.map(
            lambda x, d: jax.device_put(x, spec(d, False)), cache,
            api.cache_defs(b, cache_len), is_leaf=is_def)
        step = jax.jit(make_serve_step(api), donate_argnums=(1,))
        last = logits[:, -1]
        lg, tk = [np.asarray(last)], []
        toks = jnp.argmax(last, -1).astype(jnp.int32)
        tk.append(np.asarray(toks))
        for i in range(NEW - 1):
            last, cache = step(params, cache, jax.device_put(toks, tok),
                               jnp.int32(S + i))
            toks = jnp.argmax(last, -1).astype(jnp.int32)
            lg.append(np.asarray(last))
            tk.append(np.asarray(toks))
    out[name] = {"logits": np.stack(lg, 1), "tokens": np.stack(tk, 1)}
with open(sys.argv[2], "wb") as f:
    pickle.dump(out, f)
"""


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _initial(path):
    """The params (seed 0, drawn by the port) and prompts of the cases the
    reference runs, as numpy, with their arch and overrides."""
    import torch

    from repro_torch.core.flat import tree_map
    from repro_torch.launch.serve import prompts
    from repro_torch.models.registry import get_model_api

    out = {}
    for name in world_script.REFERENCE:
        cfg = world_script.config(name)
        params = get_model_api(cfg).init(torch.Generator().manual_seed(0),
                                         "cpu")
        out[name] = {"arch": CASES[name][0], "overrides": CASES[name][1],
                     "params": tree_map(lambda x: x.numpy(), params),
                     "tokens": prompts(cfg, CASES[name][2], S, 0,
                                       "cpu")["tokens"].numpy()}
    with open(path, "wb") as f:
        pickle.dump(out, f)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    out = tmp_path_factory.mktemp("placed_serve")
    initial = out / "initial.pkl"
    _initial(initial)
    env = {**os.environ, "OMP_NUM_THREADS": "1", "MKL_NUM_THREADS": "1",
           "PYTHONPATH": SRC}
    env.pop("XLA_FLAGS", None)
    reference = subprocess.Popen(
        [sys.executable, "-c", _REFERENCE, str(initial),
         str(out / "reference.pkl"), str(S), str(NEW)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env={**env, "JAX_PLATFORMS": "cpu"})
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(HERE, "_torch_placed_serve_world.py"),
         "--rank", str(r), "--port", str(port), "--out", str(out)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env)
        for r in range(WORLD)]
    logs = []
    try:
        for p in procs + [reference]:
            logs.append(p.communicate(timeout=TIMEOUT)[0])
    finally:
        for p in procs + [reference]:
            if p.poll() is None:
                p.kill()
                p.wait()
    failed = [(r, p.returncode, log[-3000:]) for r, (p, log)
              in enumerate(zip(procs + [reference], logs)) if p.returncode]
    assert not failed, failed
    results = {"ranks": []}
    for r in range(WORLD):
        with open(out / f"rank{r}.json") as f:
            results["ranks"].append(json.load(f))
    for name in ("port", "reference"):
        with open(out / f"{name}.pkl", "rb") as f:
            results[name] = pickle.load(f)
    return results


@pytest.mark.parametrize("name", list(CASES))
def test_placed_generate_equals_the_meshless_one(world, name):
    """Every rank's placed prefill and 3 decode steps against the mesh-less
    ``generate`` of its pod's rows: the same tokens, the logits and every
    cache leaf within the module docstring's tolerances."""
    recurrent = world_script.config(name).block_kind in ("xlstm", "hymba")
    for rank in world["ranks"]:
        r = rank[name]
        assert r["tokens"], name
        assert r["logits"] <= LOGITS, r["logits"]
        tol = RECURRENT_CACHE if recurrent else CACHE
        assert max(r["cache"].values()) <= tol, r["cache"]


@pytest.mark.parametrize("name", list(CASES))
def test_each_cache_leaf_is_placed_as_the_dry_run_places_it(world, name):
    """The prefill's cache on every rank: each leaf's DTensor placements
    over the pod's ``(data, model)`` submesh are ``cache_spec``'s on the
    whole mesh, its ``("pod", "data")`` batch taken as the pod's rows on
    "data"; the case's placement is the one it was chosen for."""
    from repro_torch.launch import sharding as shlib
    from repro_torch.launch.mesh import AbstractMesh
    from repro_torch.models.registry import get_model_api

    cfg = world_script.config(name)
    _, _, b, (shape, axes) = CASES[name]
    api = get_model_api(cfg)
    mesh = AbstractMesh(axes, dict(zip(axes, shape)))
    n_prefix = 8 if cfg.task == "vlm" else 0
    from _torch_pod_world import _walk

    want = {}
    for path, d in _walk(api.cache_defs(b, S + NEW + n_prefix)):
        spec = shlib.cache_spec(d, mesh, cfg)
        spec = tuple("data" if a == ("pod", "data") else a for a in spec)
        want["/".join(path)] = [
            f"S({spec.index(a)})" if a in spec and shape[axes.index(a)] > 1
            else "R" for a in ("data", "model")]
    for rank in world["ranks"]:
        assert rank[name]["placements"] == want
    placed = want[next(iter(want))]
    expect = {"kv_heads": ["S(1)", "S(3)"], "head_dim": ["S(1)", "S(4)"],
              "seq": ["S(2)", "S(4)"], "mla_moe": ["S(1)", "R"],
              "hymba_seq": ["S(2)", "S(3)"], "xlstm": ["S(2)", "S(3)"],
              "xlstm_wide": ["R", "R"]}
    if name in expect:
        assert placed == expect[name], placed


@pytest.mark.parametrize("name", world_script.COUNTED)
def test_a_decode_step_s_collectives_equal_the_dry_run_s_rules(world,
                                                                name):
    """The bytes and counts of each collective kind a rank issues in one
    decode step on its placed cache equal ``launch.dryrun.collectives``
    for the same reduced config, rows and cache on the same mesh, given as
    an abstract one: the scores' all-reduce over "model", the softmax's
    combine over "data", q gathered to the cache's head_dim split, the
    FSDP gathers and the sub-blocks' sums."""
    for rank in world["ranks"]:
        c = rank[name]["collectives"]
        assert c["got"] == c["rules"], c


@pytest.mark.parametrize("name", world_script.REFERENCE)
def test_placed_serving_equals_the_reference_s_host_mesh_serve_step(world,
                                                                    name):
    """Rank 0's placed tokens and logits (its pod's rows) against the
    reference's jitted prefill and serve step on its (2, 2, 2) host mesh
    with the same placements."""
    port, ref = world["port"][name], world["reference"][name]
    rows = port["tokens"].shape[0]
    np.testing.assert_array_equal(port["tokens"], ref["tokens"][:rows])
    want = ref["logits"][:rows].astype(np.float64)
    err = np.abs(port["logits"] - want).max() / np.abs(want).max()
    assert err <= REFERENCE_LOGITS, err


class SplitSums(torch.overrides.TorchFunctionMode):
    """Every matrix product whose contraction is even summed as its two
    halves' products: the order a row-parallel projection's sum over a
    model axis of 2 takes, on one process."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        if (func in (torch.matmul, torch.Tensor.matmul,
                     torch.Tensor.__matmul__) and not kwargs
                and args[1].dim() >= 2 and args[0].shape[-1] % 2 == 0):
            a, b = args
            h = a.shape[-1] // 2
            return a[..., :h] @ b[..., :h, :] + a[..., h:] @ b[..., h:, :]
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("name", RECURRENT)
def test_the_recurrent_caches_differ_by_rounding(world, name):
    """The mesh-less ``generate`` against itself under :class:`SplitSums`
    (measured: each case's worst cache leaf 1.1e-6 to 1.7e-6 of its
    magnitude, the same tokens): every rank's placed cache, each leaf's
    largest difference from the mesh-less one, stays within twice the
    worst leaf of that reordering."""
    from _torch_pod_world import _rel, _walk
    from repro_torch.launch import serve
    from repro_torch.models.registry import get_model_api

    cfg = world_script.config(name)
    api = get_model_api(cfg)
    params = api.init(torch.Generator().manual_seed(0), "cpu")
    batch = serve.prompts(cfg, CASES[name][2], S, 0, "cpu")
    plain = serve.generate(api, params, batch, NEW)
    with SplitSums():
        split = serve.generate(api, params, batch, NEW)
    assert torch.equal(split["tokens"], plain["tokens"])
    want = dict(_walk(plain["cache"]))
    rounding = max(_rel(x, want[p]) for p, x in _walk(split["cache"]))
    placed = max(max(rank[name]["cache"].values())
                 for rank in world["ranks"])
    print(f"{name}: placed {placed:.3e}, split sums {rounding:.3e}")
    assert placed <= 2 * rounding, (placed, rounding)
