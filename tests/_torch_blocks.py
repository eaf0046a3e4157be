"""Shared harness of the recurrent and hybrid block tests
(``tests/test_torch_{xlstm,hymba}.py``, and the task rounds of
``tests/test_torch_pod_tasks.py``): both packages on the CPU at a
reduced config, parameters from the reference's own ``init`` carried across
by ``repro_torch.interop.params_from_numpy``, inputs from the same numpy
draws.  Each check states its tolerance where it is called.

Gradients and pod rounds are ill-conditioned at random init (xLSTM's
mLSTM denominator ``max(|q . n|, exp(-m))`` switches branch on about half
its rows, so its gradient jumps; hymba's deeper chain measured 1.2e-5
apart on a gradient leaf), so their tolerances are calibrated on the
reference itself: :func:`drifts` reruns the reference with its parameters
times (1 + 1e-6 N(0, 1)), elementwise, three times (f32-scale noise, the
size of the two packages' disagreement on the forward), and a leaf is then
held to twice the most the reference moved, or to the fixed tolerance
where that is larger."""
from __future__ import annotations

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as ref_registry
from repro.launch import steps as ref_steps
from repro.models.registry import get_model_api as ref_get_model_api
from repro_torch.configs import registry
from repro_torch.core.flat import tree_flatten
from repro_torch.interop import params_from_numpy, pod_state_from_numpy
from repro_torch.launch import steps
from repro_torch.models.registry import get_model_api


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for a file's small tensors: the suite runs files
    in parallel workers, and a thread pool per worker oversubscribes the
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def run_module(module: str, *args: str) -> str:
    """``python -m module args`` from the repo root with ``src`` on the
    path and 2 threads -> its standard output (it must exit 0)."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=os.path.join(root, "src"),
               OMP_NUM_THREADS="2")
    done = subprocess.run([sys.executable, "-m", module, *args], cwd=root,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert done.returncode == 0, done.stderr[-2000:]
    return done.stdout


def apis(ref_cfg, cfg, seed: int = 0):
    """(reference api, port api, reference params as numpy, port params).
    The reference's calls are compiled whole (``jax.jit``): run eagerly, a
    ``lax.scan`` is traced and compiled again at every call."""
    ref_api, api = ref_get_model_api(ref_cfg), get_model_api(cfg)
    ref_params = jax.device_get(jax.jit(ref_api.init)(
        jax.random.PRNGKey(seed)))
    ref_api = ref_api._replace(
        forward=jax.jit(ref_api.forward), loss=jax.jit(ref_api.loss),
        prefill=jax.jit(ref_api.prefill, static_argnums=2),
        decode_step=jax.jit(ref_api.decode_step))
    return ref_api, api, ref_params, params_from_numpy(ref_params)


def tokens(ref_cfg, b: int, s: int, seed: int = 1) -> np.ndarray:
    return np.array(ref_registry.make_batch(ref_cfg, b, s, seed=seed)["tokens"])


def rel_err(got, want) -> float:
    """max|got - want| over max|want|."""
    if isinstance(got, torch.Tensor):
        got = got.detach().float().numpy()
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()),
                                                 1e-30)


def close(got, want, what: str, rel: float) -> None:
    err = rel_err(got, want)
    assert err <= rel, f"{what}: max|err| {err:.3e} of max|want| > {rel}"


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def drifts(fn, params, n: int = 3, eps: float = 1e-6) -> list:
    """``fn`` of the reference's ``params`` times (1 + eps N(0, 1)),
    elementwise, for ``n`` draws (seeds 0 .. n - 1), as numpy."""
    out = []
    for seed in range(n):
        rng = np.random.default_rng(seed)
        noisy = jax.tree.map(lambda x: x * (1 + eps * rng.standard_normal(
            x.shape)).astype(x.dtype), params)
        out.append(jax.device_get(fn(noisy)))
    return out


def trees_close(got: dict, want: dict, what: str, rel: float,
                moved=()) -> None:
    """Every leaf of the port's tree against the reference's numpy tree:
    within ``rel`` of the leaf's largest magnitude, or within twice the
    most the reference's own leaf moved in ``moved`` (its reruns, trees
    like ``want``; see the module docstring) where that is larger."""
    paths, leaves = tree_flatten(got)
    for path, leaf in zip(paths, leaves):
        ref = _at(want, path)
        tol = max([rel] + [2 * rel_err(_at(m, path), ref) for m in moved])
        close(leaf, ref, f"{what} {'.'.join(path)}", tol)


def grad_parity(ref_api, api, ref_params, batch: dict, rel: float) -> dict:
    """The loss and its gradient with respect to every leaf, the port's
    ``torch.autograd`` against ``jax.grad`` of the reference's loss; loss
    to 1e-6 relative, each gradient leaf to ``rel`` of its largest
    magnitude or to twice the reference's own drift (:func:`drifts`).
    Returns the port's gradients by path."""
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    grad = jax.jit(lambda p: jax.grad(lambda q: ref_api.loss(q, jb)[0])(p))
    ref_l, _ = ref_api.loss(ref_params, jb)
    ref_g = jax.device_get(grad(ref_params))
    moved = drifts(grad, ref_params)
    params = params_from_numpy(ref_params)
    paths, leaves = tree_flatten(params)
    for x in leaves:
        x.requires_grad_(True)
    loss, _ = api.loss(params, {k: torch.from_numpy(v.copy())
                                for k, v in batch.items()})
    grads = torch.autograd.grad(loss, leaves)
    assert float(loss.detach()) == pytest.approx(float(ref_l), rel=1e-6)
    got = {}
    for path, g in zip(paths, grads):
        node = got
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = g
    trees_close(got, ref_g, "grad", rel, moved)
    return {tuple(p): g for p, g in zip(paths, grads)}


def pod_round_parity(ref_api, api, ref_params, batches, rel: float) -> list:
    """The pods-as-clients round of both packages (2 pods, K local steps,
    lr 0.05, alpha 0.9, rho 0.05, the dense ``P_pod``) on ``batches``: a
    token array of shape (rounds, 2, K, B, S), or a dict of the task's
    arrays of shape (rounds, 2, K, B, ...); each round restarts the port
    from the reference's state (params, momentum ``v``, push-sum ``w``).
    Holds every params and ``v`` leaf to ``rel`` of its largest magnitude
    or to twice the reference's own drift (:func:`drifts` of the round's
    params), ``w`` to 1e-6, the loss to 1e-5 relative and the accuracy to
    one position a step (``configs.registry.step_positions``).  The two
    replicas differ
    (the second is half the first), so the first mix already moves them.
    Returns the reference's losses."""
    if not isinstance(batches, dict):
        batches = {"tokens": batches}
    first = np.asarray(next(iter(batches.values())))
    kw = dict(lr=0.05, alpha=0.9, rho=0.05, local_steps=first.shape[2])
    ref_round = jax.jit(ref_steps.make_round_step(ref_api,
                                                  ref_steps.StepConfig(**kw)))
    port_round = steps.make_round_step(api, steps.StepConfig(**kw))
    params = jax.tree.map(lambda x: jnp.stack([x, x * 0.5]), ref_params)
    ref = (params, jax.tree.map(jnp.zeros_like, params), jnp.ones((2,)), (),
           ())
    step_positions = registry.step_positions(
        {k: torch.from_numpy(np.asarray(x)) for k, x in batches.items()})
    losses = []
    for r in range(first.shape[0]):
        p, v, w = jax.device_get(ref[:3])
        state = pod_state_from_numpy({"params": p, "v": v, "w": w})
        got = port_round(*state, {k: torch.from_numpy(np.array(x[r]))
                                  for k, x in batches.items()},
                         steps.pod_mixing_matrix(2))
        batch = {k: jnp.asarray(x[r]) for k, x in batches.items()}
        P = ref_steps.pod_mixing_matrix(2)
        moved = drifts(lambda p: ref_round(p, *ref[1:], batch, P)[:2], ref[0])
        ref = ref_round(*ref, batch, P)
        ref_p, ref_v, ref_w, _, _, ref_m = jax.device_get(ref)
        trees_close(got[0], ref_p, f"round {r} params", rel,
                    [m[0] for m in moved])
        trees_close(got[1], ref_v, f"round {r} v", rel, [m[1] for m in moved])
        close(got[2], ref_w, f"round {r} w", 1e-6)
        m = got[5]
        assert float(m["loss"]) == pytest.approx(float(ref_m["loss"]),
                                                 rel=1e-5)
        assert (abs(float(m["acc"]) - float(ref_m["acc"]))
                <= 1 / step_positions)
        assert float(got[2].sum()) == pytest.approx(2.0, abs=1e-6)
        losses.append(float(ref_m["loss"]))
        ref = ref[:5]
    return losses
