"""The MoE decoders' training target on the CPU against the JAX reference,
at ``reduced`` size (f32, 2 layers): ``ModelApi.loss`` of dbrx-132b (GQA,
softmax top 2 of 4 experts) and deepseek-v3-671b (MLA, sigmoid top 2 of 4
and a shared expert), the cross entropy plus ``router_aux_coef`` times the
layers' mean aux load-balance loss, and its gradient with respect to every
leaf (the f32 routers included) against ``jax.value_and_grad`` of the
reference's; and ``cfg.remat``, under which each layer's aux comes out of
its checkpointed body.

Each side routes by its own f32 router; at these draws no token of either
model sits near a top-k tie (``tests/test_torch_moe.py`` prints the
smallest gap of a layer), so both choose the same experts.  The default
capacity factor (1.25, 25 slots an expert for a mean load of 20) drops
some assignments, and both drop the same ones.

Tolerance: both sides compute in f32 with their sums in their own orders,
the loss, the cross entropy and the aux to 1e-5 relative, every gradient
to 1e-4 of its leaf's largest magnitude.  ``remat`` recomputes the same
operations, so it must be equal bit for bit.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as ref_registry
from repro.data.synthetic import make_lm_stream as ref_make_lm_stream
from repro.models import transformer as ref_transformer
from repro.models.registry import get_model_api as ref_get_model_api
from repro_torch.configs import registry
from repro_torch.core.flat import tree_flatten
from repro_torch.interop import params_from_numpy
from repro_torch.models import transformer
from repro_torch.models.registry import get_model_api

ARCHS = ("dbrx-132b", "deepseek-v3-671b")
B, S = 2, 40


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_CACHE: dict = {}


def _setup(arch):
    if arch not in _CACHE:
        ref_api = ref_get_model_api(ref_registry.get_config(arch, smoke=True))
        api = get_model_api(registry.get_config(arch, smoke=True))
        ref_params = jax.device_get(ref_api.init(jax.random.PRNGKey(0)))
        toks = np.array(ref_make_lm_stream(ref_api.cfg.vocab_size, S, B,
                                           seed=4))
        _CACHE[arch] = (ref_api, api, ref_params, toks)
    return _CACHE[arch]


def _close(got, want, rel, what):
    got = got.detach().numpy()
    want = np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= rel * scale, f"{what}: max|err| {err:.3e} > {rel} x {scale:.3e}"


def _loss_and_grads(api, ref_params, toks):
    params = params_from_numpy(ref_params)
    paths, leaves = tree_flatten(params)
    for x in leaves:
        x.requires_grad_(True)
    loss, (ce, acc) = api.loss(params, {"tokens": torch.from_numpy(toks)})
    return paths, loss, ce, acc, torch.autograd.grad(loss, leaves)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_gradient_match_jax_value_and_grad(arch):
    ref_api, api, ref_params, toks = _setup(arch)
    batch = {"tokens": jnp.asarray(toks)}
    (ref_l, (ref_ce, ref_acc)), ref_g = jax.value_and_grad(
        ref_api.loss, has_aux=True)(ref_params, batch)
    paths, loss, ce, acc, grads = _loss_and_grads(api, ref_params, toks)
    loss, ce = loss.detach(), ce.detach()
    assert float(loss) == pytest.approx(float(ref_l), rel=1e-5)
    assert float(ce) == pytest.approx(float(ref_ce), rel=1e-5)
    assert float(acc) == float(ref_acc)
    # The aux term is in the loss, and is the reference's.
    ref_aux = ref_transformer.forward(ref_params, batch, ref_api.cfg)[1]["moe_aux"]
    with torch.no_grad():
        aux = transformer.forward(params_from_numpy(ref_params),
                                  {"tokens": torch.from_numpy(toks)},
                                  api.cfg)[1]["moe_aux"]
    assert float(aux) == pytest.approx(float(ref_aux), rel=1e-5)
    assert float(aux) > 0.5  # E * sum(frac * imp) is about 1 when balanced
    assert float(loss - ce) == pytest.approx(
        api.cfg.router_aux_coef * float(aux), rel=1e-4)
    ref_g = jax.device_get(ref_g)
    assert len(paths) == len(jax.tree.leaves(ref_g))
    for path, g in zip(paths, grads):
        want = ref_g
        for k in path:
            want = want[k]
        _close(g, want, 1e-4, f"{arch} grad {'.'.join(path)}")


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_gives_the_same_loss_and_gradient(arch):
    ref_api, api, ref_params, toks = _setup(arch)
    remat = get_model_api(dataclasses.replace(api.cfg, remat=True))
    out = [_loss_and_grads(a, ref_params, toks) for a in (api, remat)]
    assert torch.equal(out[0][1], out[1][1])
    for g0, g1 in zip(out[0][4], out[1][4]):
        assert torch.equal(g0, g1)
