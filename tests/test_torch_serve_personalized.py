"""The port's personalized serving (``launch.steps.make_personalized_serve_step``
and ``serve.main --clients``) against the JAX reference's, on the CPU at
``reduced`` size (the four dense decoders' smoke configs, f32).

Both packages expand the same delta-bank rows (rank 2, random rows and
push-sum weights, lanes in a permuted client order) over the same base
(the reference's ``init``, copied across) and serve the same prompts.  The
reference vmaps prefill and decode over (params, batch) lanes with an
inner batch of 1; the port stacks the lanes' weights on a leading axis and
runs one pass over the layers for every lane (batched matmuls, the flash
kernel's plain version on the CPU with the lanes as its batch).

Tolerance: as ``tests/test_torch_llm_serve.py``, each logit within 1e-4 of
the logits' magnitude (f32 sums in each package's own order); the expanded
weights within 1e-5 of theirs (one ``A @ B`` product of rank 2 in another
order, then the same division and add).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as ref_registry
from repro.core.flat import bind_delta_spec as ref_bind
from repro.core.flat import make_delta_spec as ref_make_delta_spec
from repro.launch.steps import (
    make_personalized_serve_step as ref_make_personalized,
)
from repro.models.registry import get_model_api as ref_get_model_api
from repro_torch.configs import registry
from repro_torch.core.flat import bind_delta_spec, make_delta_spec
from repro_torch.core.flat import tree_flatten, tree_map
from repro_torch.interop import params_from_numpy
from repro_torch.launch import serve
from repro_torch.launch.steps import make_personalized_serve_step
from repro_torch.models.registry import get_model_api
from _torch_threads import one_thread  # noqa: F401,E402  (an autouse fixture)

ARCHS = ("codeqwen1.5-7b", "gemma3-12b", "glm4-9b", "phi3-medium-14b")
S, STEPS, RANK = 40, 3, 2
IDS = np.array([2, 0, 1])  # lane b serves client IDS[b]


def _close(got, want, what, rel=1e-4):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= rel * scale, f"{what}: max|err| {err:.3e} > {rel} * {scale:.3e}"


def _setup(arch):
    ref_api = ref_get_model_api(ref_registry.get_config(arch, smoke=True))
    api = get_model_api(registry.get_config(arch, smoke=True))
    ref_params = jax.device_get(ref_api.init(jax.random.PRNGKey(0)))
    params = params_from_numpy(ref_params)
    ref_spec = ref_bind(ref_make_delta_spec(ref_params, rank=RANK), ref_params)
    spec = bind_delta_spec(make_delta_spec(params, rank=RANK), params)
    rng = np.random.default_rng(0)
    bank = (0.02 * rng.standard_normal((3, spec.dim))).astype(np.float32)
    w = rng.uniform(0.5, 1.5, 3).astype(np.float32)
    tokens = np.array(ref_registry.make_batch(ref_api.cfg, len(IDS), S,
                                              seed=1)["tokens"])
    return ref_api, api, ref_spec, spec, bank, w, tokens


@pytest.mark.parametrize("arch", ARCHS)
def test_personalized_serving_matches_the_reference(arch):
    ref_api, api, ref_spec, spec, bank, w, tokens = _setup(arch)
    assert spec.dim == ref_spec.dim
    assert spec.delta.modes == ref_spec.delta.modes
    ref_ps = ref_make_personalized(ref_api, ref_spec)
    ps = make_personalized_serve_step(api, spec)

    ref_stacked = ref_ps.expand(jnp.asarray(bank), jnp.asarray(w),
                                jnp.asarray(IDS))
    with torch.no_grad():
        stacked = ps.expand(torch.from_numpy(bank), torch.from_numpy(w),
                            torch.from_numpy(IDS))
    got_leaves = tree_flatten(stacked)[1]
    want_leaves = jax.tree.leaves(ref_stacked)
    assert len(got_leaves) == len(want_leaves)
    for g, r in zip(got_leaves, want_leaves):
        _close(g, np.asarray(r), "expanded weights", rel=1e-5)

    cache_len = S + STEPS
    ref_logits, ref_cache = jax.jit(ref_ps.prefill, static_argnums=(2,))(
        ref_stacked, {"tokens": jnp.asarray(tokens)}, cache_len)
    with torch.no_grad():
        logits, cache = ps.prefill(stacked, {"tokens": torch.from_numpy(tokens)},
                                   cache_len)
    _close(logits, np.asarray(ref_logits), f"{arch} prefill logits")
    toks = np.asarray(ref_logits[:, -1].argmax(-1), np.int32)
    np.testing.assert_array_equal(logits[:, -1].argmax(-1).numpy(), toks)
    decode = jax.jit(ref_ps.decode_step)
    for i in range(STEPS):
        ref_logits, ref_cache = decode(ref_stacked, ref_cache,
                                       jnp.asarray(toks), jnp.int32(S + i))
        with torch.no_grad():
            logits, cache = ps.decode_step(stacked, cache,
                                           torch.from_numpy(toks), S + i)
        _close(logits, np.asarray(ref_logits), f"{arch} decode step {i}")
        toks = np.asarray(ref_logits.argmax(-1), np.int32)
        np.testing.assert_array_equal(logits.argmax(-1).numpy(), toks)


@pytest.mark.parametrize("arch", ("gemma3-12b", "glm4-9b"))
def test_a_zero_row_serves_the_base(arch):
    _, api, _, spec, bank, _, tokens = _setup(arch)
    bank[1] = 0.0
    ps = make_personalized_serve_step(api, spec)
    with torch.no_grad():
        stacked = ps.expand(torch.from_numpy(bank), None,
                            torch.arange(3))
        lane = tree_map(lambda x: x[1], stacked)
        for a, b in zip(tree_flatten(lane)[1], tree_flatten(spec.base)[1]):
            assert torch.equal(a, b)
        batch = {"tokens": torch.from_numpy(tokens)}
        logits, cache = ps.prefill(stacked, batch, S + 1)
        dense, dcache = api.prefill(spec.base, {"tokens": batch["tokens"][1:2]},
                                    S + 1)
        _close(logits[1:2], dense, "prefill, zero row against the base",
               rel=1e-5)
        tok = logits[:, -1].argmax(-1).to(torch.int32)
        step, _ = ps.decode_step(stacked, cache, tok, S)
        dstep, _ = api.decode_step(spec.base, dcache, tok[1:2], S)
        _close(step[1:2], dstep, "decode, zero row against the base", rel=1e-5)


def test_serve_main_with_clients_runs_on_the_cpu(capsys):
    argv = ["--device", "cpu", "--arch", "glm4-9b", "--prompt-len", "12",
            "--new-tokens", "4"]
    rec = serve.main(argv + ["--clients", "3", "--rank", "2",
                             "--zero-clients", "1"])
    assert "[serve] expand 3 clients" in capsys.readouterr().out
    assert tuple(rec["tokens"].shape) == (3, 4) and rec["finite"]
    assert rec["bank"].shape == (3, rec["spec"].dim)
    assert torch.count_nonzero(rec["bank"][0]) == 0
    assert torch.count_nonzero(rec["bank"][1]) > 0
    dense = serve.main(argv + ["--batch", "3"])
    assert torch.equal(rec["batch"]["tokens"], dense["batch"]["tokens"])
    _close(rec["logits"][0], dense["logits"][0], "lane 0 against the dense "
           "serve", rel=1e-5)
    assert not torch.equal(rec["tokens"][1:], dense["tokens"][1:])
