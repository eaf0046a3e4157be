"""The port's training pieces against the JAX reference on the CPU, at
``reduced`` size (f32, 2 layers, hd 64): ``data.synthetic.make_lm_stream``
token for token; the ``lm`` loss and its gradient (``transformer.loss``
through ``ModelApi.loss``) against ``jax.value_and_grad`` of the
reference's, for glm4-9b (GQA group 2) and gemma3-12b (a 32-token window
under a 40-token sequence, qk-norm, tied embeddings); ``cfg.remat``;
``layers.softmax_xent`` under autograd; ``launch.steps.make_train_step`` at
a push-sum weight w != 1; ``_microbatched_loss``; and ``optim.sgd``.

The port's forward runs its attention through ``ops.flash_attention``, so
under autograd through the flash Function and its plain backward; the
reference differentiates its plain ``_dot_attn``.

Tolerance: both sides compute in f32 with their sums in their own orders:
the loss to 1e-6 relative, gradients, params and momentum to 1e-5 of each
leaf's largest magnitude (measured: about 1e-7 and 1e-6), accuracy exactly;
the schedules (f32 ``pow`` and ``cos`` of each library) to 1e-6
relative.  ``remat`` recomputes the same operations, so it must be equal
bit for bit.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as ref_registry
from repro.data.synthetic import make_lm_stream as ref_make_lm_stream
from repro.launch import steps as ref_steps
from repro.models import layers as ref_layers
from repro.models.registry import get_model_api as ref_get_model_api
from repro.optim import sgd as ref_sgd
from repro_torch.configs import registry
from repro_torch.core.flat import tree_flatten
from repro_torch.data.synthetic import make_lm_stream
from repro_torch.interop import params_from_numpy
from repro_torch.launch import steps
from repro_torch.models import layers
from repro_torch.models.registry import get_model_api
from repro_torch.optim import sgd

ARCHS = ("glm4-9b", "gemma3-12b")
B, S = 2, 40

_CACHE: dict = {}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this file's small tensors: the suite runs
    files in parallel workers, and a thread pool per worker oversubscribes
    the cores (tiny ops then wait on each other's spinning threads)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _setup(arch):
    if arch not in _CACHE:
        ref_api = ref_get_model_api(ref_registry.get_config(arch, smoke=True))
        api = get_model_api(registry.get_config(arch, smoke=True))
        ref_params = jax.device_get(ref_api.init(jax.random.PRNGKey(0)))
        toks = np.asarray(ref_make_lm_stream(ref_api.cfg.vocab_size, S, B,
                                             seed=4))
        _CACHE[arch] = (ref_api, api, ref_params, toks)
    return _CACHE[arch]


def _close(got, want, rel, what):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= rel * scale, f"{what}: max|err| {err:.3e} > {rel} x {scale:.3e}"


def _close_trees(got, want, rel, what):
    paths, leaves = tree_flatten(got)
    for path, leaf in zip(paths, leaves):
        ref_leaf = want
        for k in path:
            ref_leaf = ref_leaf[k]
        _close(leaf, ref_leaf, rel, f"{what} {'.'.join(path)}")


@pytest.mark.parametrize("vocab,seq,n", [(512, 16, 6), (151_552, 33, 3),
                                         (100, 8, 4)])
def test_make_lm_stream_is_the_references_token_for_token(vocab, seq, n):
    for seed in (0, 5):
        got = make_lm_stream(vocab, seq, n, seed=seed)
        want = np.asarray(ref_make_lm_stream(vocab, seq, n, seed=seed))
        assert got.dtype == torch.int32 and tuple(got.shape) == (n, seq)
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_gradient_match_jax_value_and_grad(arch):
    ref_api, api, ref_params, toks = _setup(arch)
    (ref_l, (ref_ce, ref_acc)), ref_g = jax.value_and_grad(
        ref_api.loss, has_aux=True)(ref_params, {"tokens": jnp.asarray(toks)})
    params = params_from_numpy(ref_params)
    paths, leaves = tree_flatten(params)
    for x in leaves:
        x.requires_grad_(True)
    loss, (ce, acc) = api.loss(params, {"tokens": torch.from_numpy(toks)})
    grads = torch.autograd.grad(loss, leaves)
    assert float(loss) == pytest.approx(float(ref_l), rel=1e-6)
    assert float(ce) == pytest.approx(float(ref_ce), rel=1e-6)
    assert float(acc) == float(ref_acc)
    ref_g = jax.device_get(ref_g)
    for path, g in zip(paths, grads):
        want = ref_g
        for k in path:
            want = want[k]
        _close(g, want, 1e-5, f"{arch} grad {'.'.join(path)}")


def test_remat_gives_the_same_loss_and_gradient():
    ref_api, api, ref_params, toks = _setup("glm4-9b")
    remat = get_model_api(dataclasses.replace(api.cfg, remat=True))
    batch = {"tokens": torch.from_numpy(toks)}
    out = []
    for a in (api, remat):
        params = params_from_numpy(ref_params)
        paths, leaves = tree_flatten(params)
        for x in leaves:
            x.requires_grad_(True)
        loss, _ = a.loss(params, batch)
        out.append((loss.detach(), torch.autograd.grad(loss, leaves)))
    assert torch.equal(out[0][0], out[1][0])
    for g0, g1 in zip(out[0][1], out[1][1]):
        assert torch.equal(g0, g1)


def test_softmax_xent_under_autograd_matches_the_reference():
    rng = np.random.default_rng(7)
    logits = rng.standard_normal((3, 5, 11)).astype(np.float32) * 3
    labels = rng.integers(0, 11, (3, 5)).astype(np.int32)
    mask = (rng.random((3, 5)) > 0.3).astype(np.float32)
    for m in (None, mask):
        def ref_fn(lg):
            return ref_layers.softmax_xent(
                lg, jnp.asarray(labels), None if m is None else jnp.asarray(m))

        (ref_l, ref_acc), ref_vjp = jax.vjp(ref_fn, jnp.asarray(logits))
        (ref_g,) = ref_vjp((jnp.float32(1.0), jnp.float32(0.0)))
        lg = torch.from_numpy(logits).requires_grad_()
        loss, acc = layers.softmax_xent(
            lg, torch.from_numpy(labels),
            None if m is None else torch.from_numpy(m))
        (g,) = torch.autograd.grad(loss, lg)
        assert float(loss) == pytest.approx(float(ref_l), rel=1e-6)
        assert float(acc) == float(ref_acc)
        _close(g, ref_g, 1e-6, "softmax_xent grad")


def test_train_step_at_w_not_one():
    """One local step at push-sum weight w = 0.625: the de-bias z = x / w,
    the two-pass SAM gradient at z, momentum and descent on x."""
    ref_api, api, ref_params, toks = _setup("glm4-9b")
    step_kw = dict(lr=0.05, alpha=0.9, rho=0.05)
    ref_train = jax.jit(ref_steps.make_train_step(
        ref_api, ref_steps.StepConfig(**step_kw)))
    train = steps.make_train_step(api, steps.StepConfig(**step_kw))
    v = jax.tree.map(lambda x: 0.1 * x, ref_params)
    ref_p, ref_v, ref_m = jax.device_get(ref_train(
        ref_params, v, jnp.float32(0.625), {"tokens": jnp.asarray(toks)}))
    with torch.no_grad():
        got_p, got_v, got_m = train(
            params_from_numpy(ref_params), params_from_numpy(jax.device_get(v)),
            torch.tensor(0.625), {"tokens": torch.from_numpy(toks)})
    _close_trees(got_p, ref_p, 1e-5, "params")
    _close_trees(got_v, ref_v, 1e-5, "v")
    assert float(got_m["loss"]) == pytest.approx(float(ref_m["loss"]),
                                                 rel=1e-6)
    assert float(got_m["acc"]) == float(ref_m["acc"])


def test_microbatched_loss_matches_the_reference():
    """Two checkpointed chunks of one sequence each: the loss, the metrics
    and the gradient of the chunk mean."""
    ref_api, api, ref_params, toks = _setup("glm4-9b")
    ref_loss = ref_steps._microbatched_loss(ref_api.loss, 2)
    loss_fn = steps._microbatched_loss(api.loss, 2)
    (ref_l, (ref_ce, ref_acc)), ref_g = jax.value_and_grad(
        ref_loss, has_aux=True)(ref_params, {"tokens": jnp.asarray(toks)})
    params = params_from_numpy(ref_params)
    paths, leaves = tree_flatten(params)
    for x in leaves:
        x.requires_grad_(True)
    loss, (ce, acc) = loss_fn(params, {"tokens": torch.from_numpy(toks)})
    grads = torch.autograd.grad(loss, leaves)
    assert float(loss) == pytest.approx(float(ref_l), rel=1e-6)
    assert float(ce) == pytest.approx(float(ref_ce), rel=1e-6)
    assert float(acc) == pytest.approx(float(ref_acc), abs=1e-7)
    ref_g = jax.device_get(ref_g)
    for path, g in zip(paths, grads):
        want = ref_g
        for k in path:
            want = want[k]
        _close(g, want, 1e-5, f"microbatched grad {'.'.join(path)}")
    with torch.no_grad():
        whole = api.loss(params, {"tokens": torch.from_numpy(toks)})[0]
    assert float(loss) == pytest.approx(float(whole), rel=1e-6)


def test_schedules_match_the_reference():
    decay, ref_decay = (sgd.exponential_decay(0.1),
                        ref_sgd.exponential_decay(0.1))
    cos, ref_cos = (sgd.warmup_cosine(0.1, 10, 100),
                    ref_sgd.warmup_cosine(0.1, 10, 100))
    for step in (0, 1, 5, 10, 11, 57, 100, 250):
        for f, g in ((decay, ref_decay), (cos, ref_cos)):
            got = f(step)
            assert got.dtype == torch.float32
            assert float(got) == pytest.approx(float(g(step)), rel=1e-6)


def test_sgd_momentum_step_matches_the_reference():
    rng = np.random.default_rng(9)

    def tree(dtype):
        return {"a": {"w": rng.standard_normal((3, 4)).astype(dtype)},
                "b": rng.standard_normal(5).astype(dtype)}

    p, v, g = tree(np.float32), tree(np.float32), tree(np.float32)
    ref_p, ref_v = jax.device_get(ref_sgd.sgd_momentum_step(
        jax.tree.map(jnp.asarray, p), jax.tree.map(jnp.asarray, v),
        jax.tree.map(jnp.asarray, g), 0.05, alpha=0.9))
    got_p, got_v = sgd.sgd_momentum_step(
        params_from_numpy(p), params_from_numpy(v), params_from_numpy(g),
        0.05, alpha=0.9)
    _close_trees(got_p, ref_p, 1e-7, "p")
    _close_trees(got_v, ref_v, 1e-7, "v")
    bf = params_from_numpy(p)
    bf = {"a": {"w": bf["a"]["w"].bfloat16()}, "b": bf["b"].bfloat16()}
    out_p, out_v = sgd.sgd_momentum_step(bf, params_from_numpy(v),
                                         params_from_numpy(g), 0.05)
    assert out_p["b"].dtype == torch.bfloat16
    assert out_v["b"].dtype == torch.float32


def test_model_api_names_an_unknown_block_kind():
    """Every block kind of the zoo has a module (the reference's three:
    transformer, xlstm, hymba); another kind is refused by name."""
    for arch in ref_registry.ARCH_IDS:
        cfg = registry.get_config(arch, smoke=True)
        assert callable(get_model_api(cfg).loss)
    kind = dataclasses.replace(registry.get_config("glm4-9b", smoke=True),
                               block_kind="rwkv")
    with pytest.raises(ValueError, match="'rwkv'"):
        get_model_api(kind)