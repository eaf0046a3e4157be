"""The port's paper models against the JAX reference, same params.

Each reference model is initialized by JAX, its params carried across by
``repro_torch.interop.params_from_numpy``, and both are fed the same numpy
batch: logits, loss, accuracy and every gradient leaf must agree.  The
ResNet runs at 1/8 width on 16x16 inputs, which keeps the stride-2 SAME
convolutions (asymmetric (0, 1) padding in XLA) and GroupNorm on the path.

PyTorch's oneDNN CPU convolutions are switched off for the ResNet: their backward
corrupts the heap on the 1/8-width ResNet at batch 6 (torch 2.13.0+cpu;
the native CPU convolutions are fine), a fault of the CPU library, not of
either package.

Tolerance: both sides compute in float32 on the CPU with reductions
(matmuls, convolutions, normalisation sums) in their own orders — 1e-4 of
each output's magnitude (logits; the gradients as one set) and 1e-5 on the loss.  The
data builders are pure numpy and must match byte for byte.
"""
import jax
import numpy as np
import pytest
import torch
from torch.func import grad

from repro.data import dirichlet as ref_dirichlet
from repro.data import synthetic as ref_synthetic
from repro.models import small as ref_small
from repro_torch.core.flat import tree_flatten
from repro_torch.data import dirichlet, synthetic
from repro_torch.interop import params_from_numpy
from repro_torch.models import small
from _torch_threads import one_thread  # noqa: F401,E402  (an autouse fixture)

MODELS = {
    "mnist_2nn": (lambda m: m.mnist_2nn(), (784,)),
    "tiny_mlp": (lambda m: m.tiny_mlp(), (32,)),
    "cifar_cnn": (lambda m: m.cifar_cnn(), (32, 32, 3)),
    "resnet18_gn": (lambda m: m.resnet18_gn(image=(16, 16, 3),
                                            width_mult=0.125), (16, 16, 3)),
}


def _leaves(tree):
    return [np.asarray(x) for x in jax.tree.leaves(tree)]


@pytest.mark.parametrize("name", sorted(MODELS))
def test_model_matches_reference(name):
    with torch.backends.mkldnn.flags(enabled=name != "resnet18_gn"):
        _check_model(name)


def _check_model(name):
    make, shape = MODELS[name]
    ref_model, model = make(ref_small), make(small)
    ref_params = jax.device_get(jax.jit(ref_model.init)(jax.random.PRNGKey(1)))
    params = params_from_numpy(ref_params)
    rng = np.random.default_rng(0)
    x = np.tanh(rng.standard_normal((6,) + shape)).astype(np.float32)
    y = rng.integers(0, 10, size=6).astype(np.int32)
    batch_np = {"x": x, "y": y}
    batch = {"x": torch.from_numpy(x), "y": torch.from_numpy(y)}

    ref_logits = np.asarray(jax.jit(ref_model.apply)(ref_params, x))
    logits = model.apply(params, batch["x"]).detach().numpy()
    scale = np.abs(ref_logits).max()
    np.testing.assert_allclose(logits, ref_logits, rtol=0, atol=1e-4 * scale)

    (ref_loss, ref_acc), ref_g = jax.jit(jax.value_and_grad(
        ref_model.loss, has_aux=True))(ref_params, batch_np)
    loss, acc = model.loss(params, batch)
    assert abs(float(loss) - float(ref_loss)) <= 1e-5 * max(1.0, abs(float(ref_loss)))
    assert float(acc) == float(ref_acc)

    g = grad(lambda p, b: model.loss(p, b)[0])(params, batch)
    _, port_leaves = tree_flatten(g)
    ref_leaves = _leaves(ref_g)
    # One scale for all leaves: a conv bias in front of a GroupNorm has a
    # gradient of exactly zero in exact arithmetic, so its own magnitude is
    # rounding noise.
    gs = max(np.abs(want).max() for want in ref_leaves)
    for got, want in zip(port_leaves, ref_leaves, strict=True):
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4 * gs)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_params_flatten_in_the_reference_leaf_order(name):
    make, _ = MODELS[name]
    ref_params = jax.jit(make(ref_small).init)(jax.random.PRNGKey(0))
    paths, leaves = tree_flatten(params_from_numpy(jax.device_get(ref_params)))
    ref_paths = [tuple(k.key for k in p)
                 for p, _ in jax.tree_util.tree_flatten_with_path(ref_params)[0]]
    assert paths == ref_paths
    port_init = make(small).init(torch.Generator().manual_seed(0))
    port_paths, port_leaves = tree_flatten(port_init)
    assert port_paths == ref_paths
    assert [tuple(t.shape) for t in port_leaves] == [
        tuple(x.shape) for x in jax.tree.leaves(ref_params)]


def test_softmax_xent_matches_reference():
    rng = np.random.default_rng(3)
    logits = rng.standard_normal((16, 10)).astype(np.float32)
    logits[0, 3] = logits[0, 5] = 9.0  # an argmax tie: first index wins
    labels = rng.integers(0, 10, size=16).astype(np.int32)
    ref_ce, ref_acc = ref_small._softmax_xent(logits, labels)
    ce, acc = small._softmax_xent(torch.from_numpy(logits),
                                  torch.from_numpy(labels))
    assert abs(float(ce) - float(ref_ce)) <= 1e-6
    assert float(acc) == float(ref_acc)


@pytest.mark.parametrize("dataset", ["mnist", "cifar10"])
def test_synthetic_data_is_byte_identical(dataset):
    ref_train, ref_test = ref_synthetic.make_dataset(dataset, 300, 50, seed=4)
    train, test = synthetic.make_dataset(dataset, 300, 50, seed=4)
    for a, b in ((ref_train, train), (ref_test, test)):
        for k in ("x", "y"):
            assert a[k].dtype == b[k].dtype and a[k].tobytes() == b[k].tobytes()


@pytest.mark.parametrize("alpha", [0.3, 0.0])
def test_dirichlet_partition_is_identical(alpha):
    labels = np.random.default_rng(5).integers(0, 10, size=500)
    ref_parts = ref_dirichlet.dirichlet_partition(labels, 12, alpha, seed=2)
    parts = dirichlet.dirichlet_partition(labels, 12, alpha, seed=2)
    assert all(np.array_equal(a, b) for a, b in zip(ref_parts, parts,
                                                    strict=True))
    data = {"x": np.arange(500.0)[:, None], "y": labels}
    ref_stacked = ref_dirichlet.stack_client_data(data, ref_parts, pad_to=64)
    stacked = dirichlet.stack_client_data(data, parts, pad_to=64)
    for k in data:
        assert ref_stacked[k].tobytes() == stacked[k].tobytes()
