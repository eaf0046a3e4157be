"""The low-rank delta bank of the port against the JAX reference.

Layouts (modes, ranks, offsets, sizes, d_delta and the leaf path strings)
must be the reference's exactly, for every model, rank and ``adapt=`` form:
they are integer arithmetic on the same shapes.  The init row, built from
the reference's own normal draws, must be the reference's bit for bit (one
f32 division per element).  ``debias`` and ``grad_rows`` compute f32
matrix products whose sums XLA and PyTorch order differently.  ``debias``
expands ``A @ B`` (sums of r <= 8 terms): 1e-6 of the result's magnitude.
``grad_rows`` pulls back ``dA = G B^T`` and ``dB = A^T G``, sums of up to
N = 1,600 terms (cifar_cnn's fc1); two orders of one sum differ by at most
2 (N - 1) 2^-24 times the sum of the terms' magnitudes, which is
``grad_rows`` of ``|G|`` at ``|X|``, so that is the bound, element by
element.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import flat as ref_flat
from repro_torch.core import flat
from repro_torch.core.flat import tree_flatten
from repro_torch.interop import params_from_numpy
from repro_torch.models import small
from _torch_threads import one_thread  # noqa: F401,E402  (an autouse fixture)

MODELS = ("mnist_2nn", "cifar_cnn", "tiny_mlp")
ADAPT = ["auto", "2d", "['fc1']", "conv2",
         lambda path, shape: path.endswith("['w']") and shape[-1] > 10]


def _params(name, seed=0):
    return getattr(small, name)().init(torch.Generator().manual_seed(seed))


def _np(tree):
    return flat.tree_map(lambda t: t.numpy(), tree)


@pytest.mark.parametrize("adapt", ADAPT, ids=["auto", "2d", "fc1", "conv2",
                                              "callable"])
@pytest.mark.parametrize("rank", [1, 8, "full"])
@pytest.mark.parametrize("name", MODELS)
def test_delta_layout_is_the_reference(name, rank, adapt):
    params = _params(name)
    want = ref_flat.make_delta_spec(_np(params), rank=rank, adapt=adapt)
    got = flat.make_delta_spec(params, rank=rank, adapt=adapt)
    assert got.paths == want.paths
    assert got.modes == want.modes
    assert got.ranks == want.ranks
    assert got.offsets == want.offsets
    assert got.sizes == want.sizes
    assert got.asizes == want.asizes
    assert got.dim == want.dim
    bf16 = flat.make_delta_spec(params, rank=rank, adapt=adapt,
                                dtype=torch.bfloat16)
    assert bf16.dtype == torch.bfloat16 and bf16.dim == got.dim


def test_cifar_cnn_rank8_is_the_bank_the_card_runs():
    """The full-width scenario path's delta bank: 10 leaves, 4 low-rank
    and 6 dense, d_delta = 73,178 (2 mod 8: bf16 rows start 4 bytes off a
    16-byte boundary)."""
    spec = flat.make_delta_spec(_params("cifar_cnn"), rank=8)
    assert spec.dim == 73_178 and spec.full.dim == 1_756_426
    assert spec.modes.count("lowrank") == 4 and spec.modes.count("dense") == 6
    assert spec.paths[3] == "['conv2']['w']" and spec.modes[3] == "lowrank"


@pytest.mark.parametrize("rank", [1, 8])
@pytest.mark.parametrize("name", MODELS)
def test_init_row_from_the_reference_draws_is_its_row(name, rank):
    params = _params(name)
    ref_spec = ref_flat.make_delta_spec(_np(params), rank=rank)
    spec = flat.make_delta_spec(params, rank=rank)
    key = jax.random.PRNGKey(3)
    keys = jax.random.split(key, len(ref_spec.modes))
    normals = [torch.from_numpy(np.array(jax.random.normal(
        keys[i], spec._factor_shapes(i)[0], jnp.float32)))
        for i, m in enumerate(spec.modes) if m == "lowrank"]
    got = spec.build_init_row(normals)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(ref_spec.init_row(key)))
    # B = 0: the initial delta is exactly zero, every client is the base.
    bound = flat.bind_delta_spec(spec, params)
    for a, b in zip(tree_flatten(bound.unravel(spec.init_row(
            torch.Generator().manual_seed(1))))[1], tree_flatten(params)[1]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("rank", [1, 8, "full"])
@pytest.mark.parametrize("name", ["mnist_2nn", "cifar_cnn"])
def test_debias_and_grad_rows_match_the_reference(name, rank):
    base = _params(name, seed=1)
    ref_spec = ref_flat.bind_delta_spec(
        ref_flat.make_delta_spec(_np(base), rank=rank),
        jax.tree.map(jnp.asarray, _np(base)))
    spec = flat.bind_delta_spec(flat.make_delta_spec(base, rank=rank), base)
    rng = np.random.default_rng(2)
    n = 3
    X = (0.05 * rng.standard_normal((n, spec.dim))).astype(np.float32)
    w = rng.uniform(0.5, 1.5, n).astype(np.float32)
    for i in range(n):
        want = ref_spec.debias(jnp.asarray(X[i]), jnp.float32(w[i]))
        got = spec.debias(torch.from_numpy(X[i]), torch.tensor(w[i]))
        for g, wl in zip(tree_flatten(got)[1], jax.tree.leaves(want)):
            np.testing.assert_allclose(g.numpy(), np.asarray(wl), rtol=0,
                                       atol=1e-6 * float(np.abs(wl).max()))
    G = flat.tree_map(lambda t: torch.from_numpy(rng.standard_normal(
        (n,) + tuple(t.shape)).astype(np.float32)), base)
    want = np.asarray(ref_spec.ravel_grad_stacked(
        jax.tree.map(jnp.asarray, _np(G)), jnp.asarray(X)))
    got = spec.ravel_grad_stacked(G, torch.from_numpy(X)).numpy()
    assert got.shape == (n, spec.dim)
    terms = max([s[-2] for s, m in zip(spec.delta.full.shapes,
                                       spec.delta.modes) if m == "lowrank"]
                + [s[-1] for s, m in zip(spec.delta.full.shapes,
                                         spec.delta.modes) if m == "lowrank"]
                + [1])
    mags = spec.ravel_grad_stacked(flat.tree_map(torch.abs, G),
                                   torch.from_numpy(np.abs(X))).numpy()
    bound = 2 * (terms - 1) * 2.0 ** -24 * mags
    assert np.all(np.abs(got - want) <= bound)
    # Dense leaves pull back as the identity: those columns are exact.
    dense = np.concatenate([np.arange(o, o + sz) for o, sz, m in zip(
        spec.delta.offsets, spec.delta.sizes, spec.delta.modes)
        if m == "dense"] + [np.zeros(0, int)])
    np.testing.assert_array_equal(got[:, dense], want[:, dense])


def test_ravel_round_trip_and_lowrank_refusal():
    base = _params("mnist_2nn")
    full = flat.bind_delta_spec(flat.make_delta_spec(base, rank="full"), base)
    row = torch.randn(full.dim, generator=torch.Generator().manual_seed(0))
    assert torch.allclose(full.ravel(full.unravel(row)), row, atol=1e-6)
    low = flat.bind_delta_spec(flat.make_delta_spec(base, rank=8), base)
    with pytest.raises(ValueError, match="factored"):
        low.ravel(low.unravel(torch.zeros(low.dim)))
    stacked = low.debias_stacked(torch.zeros(2, low.dim), torch.ones(2))
    assert stacked["fc1"]["w"].shape == (2,) + tuple(base["fc1"]["w"].shape)


def test_base_from_the_reference_params_crosses_bit_for_bit():
    base = _params("tiny_mlp", seed=4)
    got = params_from_numpy(_np(base))
    for a, b in zip(tree_flatten(got)[1], tree_flatten(base)[1]):
        assert torch.equal(a, b)
