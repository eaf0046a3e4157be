"""Flat bank and topology builds of the port against the JAX reference.

Bank rows: the port's ``BankSpec`` must lay every small model out exactly
as the reference's (same offsets, the same bytes in every row).

Topologies: each sampler is a draw plus a build.  The reference's own
draw (its ``jax.random`` numbers for the same key) is handed to the port's
build, and the operator must come out as the reference's.  ``torch.topk``
and ``jax.lax.top_k`` may order ties differently, so neighbor lists are
compared per receiver as sets of (sender, weight) slots; dense matrices
must be equal (their entries are exact reciprocals of integer degrees)
except Metropolis diagonals, ``1 - row sum``, whose sums may round in
another order (one f32 ulp of 1 per summand).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import flat as ref_flat
from repro.core import topology as ref_topo
from repro_torch.core import flat, topology
from repro_torch.models import small
from _torch_threads import one_thread  # noqa: F401,E402  (an autouse fixture)

MODELS = {
    "mnist_2nn": lambda m: m.mnist_2nn(),
    "tiny_mlp": lambda m: m.tiny_mlp(),
    "cifar_cnn": lambda m: m.cifar_cnn(),
    "resnet18_gn": lambda m: m.resnet18_gn(),
}


# -- flat bank ----------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(MODELS))
def test_bank_row_equals_reference_row(name):
    # Any params of the right structure will do: the port's init, carried
    # to the reference as numpy.
    params = MODELS[name](small).init(torch.Generator().manual_seed(2))
    ref_params = flat.tree_map(lambda t: t.numpy(), params)
    ref_spec = ref_flat.make_spec(ref_params)
    ref_row = np.asarray(ref_spec.ravel(ref_params))
    spec = flat.make_spec(params)
    assert (spec.dim, spec.offsets, spec.sizes, spec.shapes) == (
        ref_spec.dim, ref_spec.offsets, ref_spec.sizes, ref_spec.shapes)
    row = spec.ravel(params)
    assert row.dtype == torch.float32
    assert row.numpy().tobytes() == ref_row.tobytes()
    # unravel / ravel round trip, and the stacked forms.
    back = spec.unravel(row)
    assert spec.ravel(back).numpy().tobytes() == ref_row.tobytes()
    bank = torch.stack([row, 2 * row, -row])
    ref_bank = np.asarray(ref_spec.ravel_stacked(
        ref_spec.unravel_stacked(jnp.asarray(bank.numpy()))))
    assert spec.ravel_stacked(spec.unravel_stacked(bank)).numpy().tobytes() \
        == ref_bank.tobytes()


def test_debias_divides_every_leaf():
    spec = flat.make_spec(small.tiny_mlp().init(torch.Generator().manual_seed(0)))
    row = torch.arange(spec.dim, dtype=torch.float32)
    z = spec.debias(row, torch.tensor(4.0))
    assert torch.equal(spec.ravel(z), row / 4.0)


def test_bank_dtype_override_and_promotion():
    tree = {"a": torch.zeros(3, dtype=torch.bfloat16),
            "b": torch.zeros(2, dtype=torch.float32)}
    assert flat.make_spec(tree).dtype == torch.float32
    assert flat.make_spec(tree, dtype=torch.bfloat16).dtype == torch.bfloat16


# -- topology: builds fed the reference's draws --------------------------------

CASES = [(8, 2, 0), (16, 3, 1), (32, 10, 2), (100, 10, 3)]


def _t(a):
    return torch.from_numpy(np.array(a))


def _key(seed):
    return jax.random.PRNGKey(seed)


def _same_lists(port, ref):
    """Per receiver, the same multiset of (sender, weight) slots, with the
    self loop in slot 0."""
    pidx, pw = port.idx.numpy(), port.wgt.numpy()
    ridx, rw = np.asarray(ref.idx), np.asarray(ref.wgt)
    assert pidx.shape == ridx.shape and pidx.dtype == np.int32
    np.testing.assert_array_equal(pidx[:, 0], ridx[:, 0])
    for i in range(pidx.shape[0]):
        assert sorted(zip(pidx[i], pw[i])) == sorted(zip(ridx[i], rw[i])), i


@pytest.mark.parametrize("n,k,seed", CASES)
def test_kout_build_matches_reference(n, k, seed):
    scores = jax.random.uniform(_key(seed), (n, n))
    P = topology.build_kout(_t(scores), k)
    np.testing.assert_array_equal(P.numpy(), np.asarray(
        ref_topo.sample_kout(_key(seed), n, k)))
    _same_lists(topology.build_kout_neighbors(_t(scores), k),
                ref_topo.sample_kout_neighbors(_key(seed), n, k))


@pytest.mark.parametrize("n,k,seed", CASES)
def test_selective_build_matches_reference(n, k, seed):
    losses = np.random.default_rng(seed).uniform(0, 3, n).astype(np.float32)
    gumbel = jax.random.gumbel(_key(seed), (n, n))
    P = topology.build_kout_selective(_t(gumbel), _t(losses), k)
    np.testing.assert_array_equal(P.numpy(), np.asarray(
        ref_topo.sample_kout_selective(_key(seed), jnp.asarray(losses), n, k)))
    _same_lists(
        topology.build_kout_selective_neighbors(_t(gumbel), _t(losses), k),
        ref_topo.sample_kout_selective_neighbors(_key(seed),
                                                 jnp.asarray(losses), n, k))


@pytest.mark.parametrize("n,k,seed", CASES)
def test_symmetric_builds_match_reference(n, k, seed):
    scores = jax.random.uniform(_key(seed), (n, n))
    P = topology.build_symmetric_k_regular(_t(scores), k)
    want = np.asarray(ref_topo.sample_symmetric_k_regular(_key(seed), n, k))
    np.testing.assert_array_equal(P.numpy() > 0, want > 0)
    off = ~np.eye(n, dtype=bool)
    np.testing.assert_array_equal(P.numpy()[off], want[off])
    # The diagonal is 1 - (row sum): deg summands of at most 1, each
    # rounding in its own order, so deg ulps of 1.
    deg = int((want[off].reshape(n, n - 1) > 0).sum(axis=1).max())
    np.testing.assert_allclose(np.diag(P.numpy()), np.diag(want), rtol=0,
                               atol=deg * 2 ** -24)
    perms = np.stack([np.asarray(jax.random.permutation(kk, n))
                      for kk in jax.random.split(_key(seed), k)])
    nl = topology.build_symmetric_neighbors(_t(perms))
    ref_nl = ref_topo.sample_symmetric_neighbors(_key(seed), n, k)
    np.testing.assert_array_equal(nl.idx.numpy(), np.asarray(ref_nl.idx))
    ref_w = np.asarray(ref_nl.wgt)
    np.testing.assert_array_equal(nl.wgt.numpy()[:, 1:], ref_w[:, 1:])
    # Slot 0 is 1 - (sum of the 2k edge weights).
    np.testing.assert_allclose(nl.wgt.numpy()[:, 0], ref_w[:, 0], rtol=0,
                               atol=2 * k * 2 ** -24)


@pytest.mark.parametrize("n", [2, 5, 8, 33])
def test_static_families_match_reference(n):
    np.testing.assert_array_equal(topology.directed_ring(n).numpy(),
                                  np.asarray(ref_topo.directed_ring(n)))
    np.testing.assert_array_equal(topology.exponential_cycle(n).numpy(),
                                  np.asarray(ref_topo.exponential_cycle(n)))
    for t in range(3):
        np.testing.assert_array_equal(
            topology.directed_exponential(n, t).numpy(),
            np.asarray(ref_topo.directed_exponential(n, t)))
    ring, ref_ring = topology.neighbors_ring(n), ref_topo.neighbors_ring(n)
    np.testing.assert_array_equal(ring.idx.numpy(), np.asarray(ref_ring.idx))
    np.testing.assert_array_equal(ring.wgt.numpy(), np.asarray(ref_ring.wgt))
    cyc = topology.neighbors_exponential_cycle(n)
    ref_cyc = ref_topo.neighbors_exponential_cycle(n)
    np.testing.assert_array_equal(cyc.idx.numpy(), np.asarray(ref_cyc.idx))
    np.testing.assert_array_equal(cyc.wgt.numpy(), np.asarray(ref_cyc.wgt))
    np.testing.assert_array_equal(
        topology.dense_from_neighbors(ring, n).numpy(),
        topology.directed_ring(n).numpy())


def test_dense_from_neighbors_matches_reference():
    nl = ref_topo.sample_symmetric_neighbors(_key(4), 12, 3)
    port = topology.dense_from_neighbors(
        topology.NeighborList(_t(nl.idx), _t(nl.wgt)), 12)
    np.testing.assert_array_equal(
        port.numpy(), np.asarray(ref_topo.dense_from_neighbors(nl, 12)))


@pytest.mark.parametrize("kind", ["kout", "ring", "exponential", "symmetric",
                                  "full"])
@pytest.mark.parametrize("mixer", ["directed", "symmetric"])
def test_k_tables_match_reference(kind, mixer):
    cfg = topology.TopologyConfig(kind=kind, n_clients=40, k_out=6)
    ref_cfg = ref_topo.TopologyConfig(kind=kind, n_clients=40, k_out=6)
    assert topology.family_k_in(cfg, mixer) == ref_topo.family_k_in(
        ref_cfg, mixer)
    assert topology.neighbor_k_max(cfg, mixer) == ref_topo.neighbor_k_max(
        ref_cfg, mixer)


# -- topology: the port's own draws --------------------------------------------

@pytest.mark.parametrize("kind", ["kout", "ring", "exponential", "symmetric"])
def test_own_draws_give_column_stochastic_operators(kind):
    gen = torch.Generator().manual_seed(7)
    cfg = topology.TopologyConfig(kind=kind, n_clients=24, k_out=4)
    P = topology.sample_mixing(gen, cfg, t=1)
    assert topology.is_column_stochastic(P)
    nl = topology.sample_neighbors(gen, cfg, t=1)
    # The CUDA kernels take contiguous operands only.
    assert P.is_contiguous() and nl.idx.is_contiguous()
    assert nl.wgt.is_contiguous()
    assert nl.idx.dtype == torch.int32
    assert nl.idx.shape == (24, topology.neighbor_k_max(cfg))
    assert topology.is_column_stochastic(topology.dense_from_neighbors(nl, 24))
    losses = torch.rand(24, generator=gen)
    if kind == "kout":
        sel = topology.sample_mixing(gen, cfg, losses=losses)
        assert topology.is_column_stochastic(sel) and sel.is_contiguous()
        assert ((sel > 0).sum(dim=0) == cfg.k_out + 1).all()
        sel_nl = topology.sample_neighbors(gen, cfg, losses=losses)
        assert topology.is_column_stochastic(
            topology.dense_from_neighbors(sel_nl, 24))


def test_unported_families_are_refused():
    """Every family is ported; what stays refused is what the reference
    refuses: a two_tier configuration its checks reject, and the full
    graph's sparse form."""
    for kw, msg in ((dict(kind="two_tier", k_out=2), "n_pods >= 2"),
                    (dict(kind="two_tier", k_out=2, n_pods=3), "divisible"),
                    (dict(kind="two_tier", k_out=5, n_pods=2), "k_out must"),
                    (dict(kind="kout", k_out=2, n_pods=2), "two_tier-only")):
        with pytest.raises(ValueError, match=msg):
            topology.TopologyConfig(n_clients=8, **kw)
    cfg = topology.TopologyConfig(kind="two_tier", n_clients=8, k_out=2,
                                  n_pods=2)
    assert topology.neighbor_k_max(cfg) == 4 + 2
    with pytest.raises(ValueError, match="full graph"):
        topology.sample_neighbors(torch.Generator(), topology.TopologyConfig(
            kind="full", n_clients=8, k_out=2))
