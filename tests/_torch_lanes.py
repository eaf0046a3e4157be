"""Shared harness of the personalized-lane tests
(``tests/test_torch_lanes_{moe,tasks,blocks}.py``): the port's lane-stacked
``forward``, ``prefill`` and ``decode_step`` against the JAX reference's
``make_personalized_serve_step`` and ``jax.vmap(forward)`` on the CPU, at
``reduced`` size in f32, as ``tests/test_torch_serve_personalized.py``
does for the dense decoders.

Both packages expand the same delta-bank rows (rank 2, 0.02 standard
normals, push-sum weights in [0.5, 1.5), lanes in the permuted client order
``IDS``) over the same base (the reference's ``init``, carried across by
``repro_torch.interop.params_from_numpy``) and run the same batch.  The
reference vmaps each call over (params, batch) lanes with an inner batch of
1, its calls compiled whole (``jax.jit``); the port stacks the lanes'
weights on a leading axis and runs one pass over the layers for every lane.

Tolerances: the expanded weights within 1e-5 of their magnitude (one rank-2
``A @ B`` in another order, then the same division and add); logits within
1e-4 of their magnitude (f32 sums in each package's own order; the block
files state the same for xlstm and hymba); greedy tokens equal.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.core.flat import bind_delta_spec as ref_bind
from repro.core.flat import make_delta_spec as ref_make_delta_spec
from repro.launch.steps import (
    make_personalized_serve_step as ref_make_personalized,
)
from repro.models.registry import get_model_api as ref_get_model_api
from repro_torch.core.flat import bind_delta_spec, make_delta_spec
from repro_torch.core.flat import tree_flatten, tree_map
from repro_torch.interop import params_from_numpy
from repro_torch.launch import serve
from repro_torch.launch.steps import make_personalized_serve_step
from repro_torch.models.registry import get_model_api

RANK, STEPS = 2, 3
IDS = np.array([2, 0, 1])  # lane b serves client IDS[b]


def rel_err(got, want) -> float:
    """max|got - want| over max|want|."""
    if isinstance(got, torch.Tensor):
        got = got.detach().float().numpy()
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()),
                                                 1e-30)


def close(got, want, what: str, rel: float = 1e-4) -> None:
    err = rel_err(got, want)
    assert err <= rel, f"{what}: max|err| {err:.3e} of max|want| > {rel}"


class Lanes:
    """Both packages' apis, specs and expanded lanes for one config pair.

    ``ref_stacked`` and ``stacked`` are the lanes' de-biased weights (lane b
    = client ``IDS[b]``), held to each other within 1e-5 when built."""

    def __init__(self, ref_cfg, cfg):
        self.ref_api, self.api = ref_get_model_api(ref_cfg), get_model_api(cfg)
        ref_params = jax.device_get(jax.jit(self.ref_api.init)(
            jax.random.PRNGKey(0)))
        params = params_from_numpy(ref_params)
        ref_spec = ref_bind(ref_make_delta_spec(ref_params, rank=RANK),
                            ref_params)
        self.spec = bind_delta_spec(make_delta_spec(params, rank=RANK), params)
        assert self.spec.dim == ref_spec.dim
        assert self.spec.delta.modes == ref_spec.delta.modes
        rng = np.random.default_rng(0)
        bank = (0.02 * rng.standard_normal((3, self.spec.dim))).astype(
            np.float32)
        w = rng.uniform(0.5, 1.5, 3).astype(np.float32)
        self.ref_ps = ref_make_personalized(self.ref_api, ref_spec)
        self.ps = make_personalized_serve_step(self.api, self.spec)
        self.ref_stacked = jax.jit(self.ref_ps.expand)(
            jnp.asarray(bank), jnp.asarray(w), jnp.asarray(IDS))
        with torch.no_grad():
            self.stacked = self.ps.expand(torch.from_numpy(bank),
                                          torch.from_numpy(w),
                                          torch.from_numpy(IDS))
        got, want = tree_flatten(self.stacked)[1], jax.tree.leaves(
            self.ref_stacked)
        assert len(got) == len(want)
        for g, r in zip(got, want):
            close(g, np.asarray(r), "expanded weights", 1e-5)

    def forward(self, batch: dict, stacked=None):
        """(the port's laned forward logits and aux, the reference's
        ``jax.vmap`` of its forward over lanes with an inner batch of 1:
        logits and aux with the inner batch taken out)."""
        fwd = jax.jit(jax.vmap(self.ref_api.forward))
        ref_logits, ref_aux = fwd(self.ref_stacked, {
            k: jnp.asarray(v)[:, None] for k, v in batch.items()})
        with torch.no_grad():
            logits, aux = self.api.forward(
                self.stacked if stacked is None else stacked,
                {k: torch.from_numpy(v.copy()) for k, v in batch.items()})
        return (logits, aux), (np.asarray(ref_logits)[:, 0],
                               jax.device_get(ref_aux))

    def serve(self, batch: dict, steps: int = STEPS) -> None:
        """Prefill ``batch`` and ``steps`` greedy decode steps in both
        packages through their personalized serve steps (a cache of the
        vlm's image prefix + prompt + ``steps`` + 1 positions, decode at
        prefix + prompt + i), every logit within 1e-4 of its magnitude and
        the greedy tokens equal."""
        n_prefix = batch["image_feats"].shape[1] if "image_feats" in batch else 0
        s = batch["tokens"].shape[1]
        cache_len = n_prefix + s + steps + 1
        ref_logits, ref_cache = jax.jit(self.ref_ps.prefill,
                                        static_argnums=(2,))(
            self.ref_stacked, {k: jnp.asarray(v) for k, v in batch.items()},
            cache_len)
        with torch.no_grad():
            logits, cache = self.ps.prefill(
                self.stacked, {k: torch.from_numpy(v.copy())
                               for k, v in batch.items()}, cache_len)
        name = self.api.cfg.name
        close(logits, np.asarray(ref_logits), f"{name} prefill logits")
        toks = np.array(ref_logits[:, -1].argmax(-1), np.int32)
        np.testing.assert_array_equal(logits[:, -1].argmax(-1).numpy(), toks)
        decode = jax.jit(self.ref_ps.decode_step)
        for i in range(steps):
            pos = n_prefix + s + i
            ref_logits, ref_cache = decode(self.ref_stacked, ref_cache,
                                           jnp.asarray(toks), jnp.int32(pos))
            with torch.no_grad():
                logits, cache = self.ps.decode_step(
                    self.stacked, cache, torch.from_numpy(toks), pos)
            close(logits, np.asarray(ref_logits), f"{name} decode step {i}")
            toks = np.array(ref_logits.argmax(-1), np.int32)
            np.testing.assert_array_equal(logits.argmax(-1).numpy(), toks)

    def prefill_error(self, batch: dict, stacked) -> float:
        """The port's prefill on ``stacked`` (a mutant's lanes) against the
        reference's prefill on the true lanes, relative."""
        n_prefix = batch["image_feats"].shape[1] if "image_feats" in batch else 0
        cache_len = n_prefix + batch["tokens"].shape[1] + 1
        ref_logits, _ = jax.jit(self.ref_ps.prefill, static_argnums=(2,))(
            self.ref_stacked, {k: jnp.asarray(v) for k, v in batch.items()},
            cache_len)
        with torch.no_grad():
            logits, _ = self.ps.prefill(
                stacked, {k: torch.from_numpy(v.copy())
                          for k, v in batch.items()}, cache_len)
        return rel_err(logits, np.asarray(ref_logits))


def swapped(stacked: dict) -> dict:
    """The lanes' weights with lanes 0 and 1 swapped."""
    order = torch.tensor([1, 0, 2])
    return tree_map(lambda t: t[order], stacked)


def serve_main_with_clients(arch: str, capsys) -> None:
    """``serve.main --clients 2 --zero-clients 1`` on the CPU at smoke
    size: it expands, serves both lanes, and lane 0 (a zero row) gives the
    logits of the dense serve of the base on the same requests, within
    1e-5 of their magnitude (batched matmuls over the lanes against one
    shared weight); lane 1's tokens differ from the base's."""
    argv = ["--device", "cpu", "--arch", arch, "--prompt-len", "12",
            "--new-tokens", "3"]
    rec = serve.main(argv + ["--clients", "2", "--rank", "2",
                             "--zero-clients", "1"])
    assert "[serve] expand 2 clients" in capsys.readouterr().out
    assert tuple(rec["tokens"].shape) == (2, 3) and rec["finite"]
    assert rec["bank"].shape == (2, rec["spec"].dim)
    assert torch.count_nonzero(rec["bank"][0]) == 0
    assert rec["params"]["final_norm"].shape[0] == 2
    dense = serve.main(argv + ["--batch", "2"])
    for k, v in rec["batch"].items():
        assert torch.equal(v, dense["batch"][k])
    close(rec["logits"][0], dense["logits"][0].numpy(),
          f"{arch}: lane 0 against the dense serve", 1e-5)
    assert rel_err(rec["logits"][1], dense["logits"][1].numpy()) > 1e-4
