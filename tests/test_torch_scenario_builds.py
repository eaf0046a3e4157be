"""Scenario builds, compressors and the oracle's pytree forms of the port
against the JAX reference, on the reference's own draws and shared inputs.

Every build is fed the random numbers the reference draws for the same key
(its ``jax.random.uniform`` / ``randint`` calls, recomputed here), so the
operators must come out bit for bit: drop masks and churn masks only select
entries, and the re-normalization divides by integer degrees summed
exactly.  The one exception is a Metropolis diagonal, ``1 - row sum``,
whose sum may round in another order (one f32 ulp of 1 per summand).

Compressors take the same input in both packages and must agree bit for
bit: they are elementwise f32 arithmetic, a row max and a k-th largest
magnitude, none of which depends on a summation order.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import pushsum as ref_pushsum
from repro.core import sam as ref_sam
from repro.core import stages as ref_stages
from repro.core import topology as ref_topo
from repro_torch.core import pushsum, sam, stages, topology
from repro_torch.core.flat import tree_flatten
from repro_torch.interop import params_from_numpy, tensor_from_numpy
from _torch_threads import one_thread  # noqa: F401,E402  (an autouse fixture)


def _t(a):
    return torch.from_numpy(np.array(a))


def _key(seed):
    return jax.random.PRNGKey(seed)


def _nl(ref_nl):
    return topology.NeighborList(_t(ref_nl.idx), _t(ref_nl.wgt))


def _same_nl(port, ref):
    np.testing.assert_array_equal(port.idx.numpy(), np.asarray(ref.idx))
    np.testing.assert_array_equal(port.wgt.numpy(), np.asarray(ref.wgt))


CASES = [(8, 2, 0), (17, 3, 1), (40, 10, 2)]
DROPS = [0.0, 0.3, 0.7, 1.0]


# -- link drops ------------------------------------------------------------------

@pytest.mark.parametrize("drop", DROPS)
@pytest.mark.parametrize("n,k,seed", CASES)
def test_drop_links_dense_directed_is_the_reference(n, k, seed, drop):
    for P in (ref_topo.sample_kout(_key(seed), n, k),
              jnp.full((n, n), 1.0 / n, jnp.float32)):
        dkey = _key(seed + 100)
        u = jax.random.uniform(dkey, (n, n))
        want = np.asarray(ref_topo.drop_links_dense(dkey, P, drop))
        got = topology.drop_links_dense(_t(u), _t(P), drop)
        np.testing.assert_array_equal(got.numpy(), want)
        assert topology.is_column_stochastic(got)


@pytest.mark.parametrize("drop", DROPS)
@pytest.mark.parametrize("n,k,seed", CASES)
def test_drop_links_dense_symmetric_is_the_reference(n, k, seed, drop):
    P = ref_topo.sample_symmetric_k_regular(_key(seed), n, k)
    dkey = _key(seed + 200)
    u = jax.random.uniform(dkey, (n, n))
    want = np.asarray(ref_topo.drop_links_dense(dkey, P, drop, symmetric=True))
    got = topology.LinkModel(drop=drop).drop_links(_t(u), _t(P),
                                                   symmetric=True).numpy()
    off = ~np.eye(n, dtype=bool)
    np.testing.assert_array_equal(got[off], want[off])
    np.testing.assert_array_equal(got, got.T)
    deg = int((want[off].reshape(n, n - 1) > 0).sum(axis=1).max())
    np.testing.assert_allclose(np.diag(got), np.diag(want), rtol=0,
                               atol=max(deg, 1) * 2 ** -24)


@pytest.mark.parametrize("drop", DROPS)
@pytest.mark.parametrize("n,k,seed", CASES)
def test_drop_links_neighbors_is_the_reference(n, k, seed, drop):
    nl = ref_topo.sample_kout_neighbors(_key(seed), n, k)
    # Pad slots (weight 0) must stay inert.
    nl = ref_topo.NeighborList(
        jnp.concatenate([nl.idx, nl.idx[:, :1]], axis=1),
        jnp.concatenate([nl.wgt, jnp.zeros_like(nl.wgt[:, :1])], axis=1))
    dkey = _key(seed + 300)
    u = jax.random.uniform(dkey, nl.idx.shape)
    want = ref_topo.drop_links_neighbors(dkey, nl, drop)
    got = topology.LinkModel(drop=drop).drop_links(_t(u), _nl(nl))
    _same_nl(got, want)
    assert topology.is_column_stochastic(topology.dense_from_neighbors(got, n))


def test_draws_have_the_operator_shape():
    gen = torch.Generator().manual_seed(0)
    P = topology.sample_kout(gen, 9, 2)
    nl = topology.sample_kout_neighbors(gen, 9, 2)
    assert topology.draw_drops(gen, P).shape == (9, 9)
    assert topology.draw_drops(gen, nl).shape == (9, 3)
    d = stages.draw_delays(gen, nl, 2)
    assert d.shape == (9, 3) and int(d.min()) >= 0 and int(d.max()) <= 2
    u = topology.draw_churn(gen, 9)
    assert u.shape == (3, 9) and float(u.min()) >= 0 and float(u.max()) < 1


# -- delay slices ------------------------------------------------------------------

@pytest.mark.parametrize("bound", [1, 2, 3])
@pytest.mark.parametrize("n,k,seed", CASES)
def test_delay_slices_are_the_reference_and_sum_to_p(n, k, seed, bound):
    lkey = _key(seed + 400)
    P = ref_topo.sample_kout(_key(seed), n, k)
    d = jax.random.randint(lkey, (n, n), 0, bound + 1)
    want = ref_stages._delay_slices(lkey, P, bound)
    got = stages._delay_slices(_t(d), _t(P), bound)
    assert len(got) == bound + 1
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    np.testing.assert_array_equal(sum(g.numpy() for g in got), np.asarray(P))
    assert np.all(np.diag(got[0].numpy()) == np.diag(np.asarray(P)))

    nl = ref_topo.sample_kout_neighbors(_key(seed), n, k)
    d = jax.random.randint(lkey, nl.idx.shape, 0, bound + 1)
    want = ref_stages._delay_slices(lkey, nl, bound)
    got = stages._delay_slices(_t(d), _nl(nl), bound)
    for g, w in zip(got, want):
        _same_nl(g, w)
    np.testing.assert_array_equal(sum(g.wgt.numpy() for g in got),
                                  np.asarray(nl.wgt))
    np.testing.assert_array_equal(got[0].wgt.numpy()[:, 0],
                                  np.asarray(nl.wgt)[:, 0])


# -- churn ---------------------------------------------------------------------------

def _churn_draw(key, n):
    return np.stack([np.asarray(jax.random.uniform(k, (n,)))
                     for k in jax.random.split(key, 3)])


@pytest.mark.parametrize("model", [
    dict(fail_prob=0.3, recover_prob=0.5, permanent_frac=0.2),
    dict(fail_prob=1.0),  # every live node fails
    dict(fail_prob=1.0, permanent_frac=1.0),  # every failure is permanent
    dict(fail_prob=0.5, recover_prob=1.0),  # every down node returns
    dict(fail_prob=1e-9, recover_prob=0.0),  # nothing ever comes back
])
def test_churn_transition_is_the_reference(model):
    n = 64
    rng = np.random.default_rng(0)
    live = rng.choice(np.array([topology.LIVE, topology.DOWN,
                                topology.DOWN_PERMANENT], np.int8), n)
    ref_model, port_model = ref_topo.ChurnModel(**model), topology.ChurnModel(
        **model)
    ref_live, port_live = jnp.asarray(live), torch.from_numpy(live.copy())
    for r in range(5):
        key = _key(r)
        ref_live = ref_topo.churn_transition(key, ref_live, ref_model)
        port_live = topology.churn_transition(_t(_churn_draw(key, n)),
                                              port_live, port_model)
        assert port_live.dtype == torch.int8
        np.testing.assert_array_equal(port_live.numpy(), np.asarray(ref_live))
        # Permanent death is absorbing.
        assert np.all(port_live.numpy()[live == topology.DOWN_PERMANENT]
                      == topology.DOWN_PERMANENT)
    if model.get("fail_prob") == 1.0 and not model.get("recover_prob"):
        assert not np.any(port_live.numpy() == topology.LIVE)


@pytest.mark.parametrize("n,k,seed", CASES)
def test_churn_links_are_the_reference_and_dead_columns_identity(n, k, seed):
    alive = np.asarray(jax.random.uniform(_key(seed + 7), (n,))) < 0.6
    alive[0] = False
    P = ref_topo.sample_kout(_key(seed), n, k)
    want = np.asarray(ref_topo.churn_links_dense(P, jnp.asarray(alive)))
    got = topology.ChurnModel(fail_prob=0.1).mask_operator(
        _t(P), torch.from_numpy(alive)).numpy()
    np.testing.assert_array_equal(got, want)
    for j in np.flatnonzero(~alive):
        np.testing.assert_array_equal(got[:, j], np.eye(n)[:, j])
        np.testing.assert_array_equal(got[j], np.eye(n)[j])
    assert topology.is_column_stochastic(torch.from_numpy(got))

    S = ref_topo.sample_symmetric_k_regular(_key(seed), n, k)
    want = np.asarray(ref_topo.churn_links_dense(S, jnp.asarray(alive),
                                                 symmetric=True))
    got = topology.churn_links_dense(_t(S), torch.from_numpy(alive),
                                     symmetric=True).numpy()
    off = ~np.eye(n, dtype=bool)
    np.testing.assert_array_equal(got[off], want[off])
    np.testing.assert_allclose(np.diag(got), np.diag(want), rtol=0,
                               atol=n * 2 ** -24)

    nl = ref_topo.sample_kout_neighbors(_key(seed), n, k)
    want_nl = ref_topo.churn_links_neighbors(nl, jnp.asarray(alive))
    got_nl = topology.churn_links_neighbors(_nl(nl), torch.from_numpy(alive))
    _same_nl(got_nl, want_nl)
    dense = topology.dense_from_neighbors(got_nl, n).numpy()
    for j in np.flatnonzero(~alive):
        np.testing.assert_array_equal(dense[:, j], np.eye(n)[:, j])


# -- compressors and the self-loop ---------------------------------------------

def _banks(seed, n, d):
    rng = np.random.default_rng(seed)
    X = (rng.standard_normal((n, d)) * rng.uniform(0.01, 3, (n, 1))).astype(
        np.float32)
    X[0, : d // 3] = 0.0  # ties at zero
    R = (0.1 * rng.standard_normal((n, d))).astype(np.float32)
    return X, R


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,d", [(3, 7), (8, 4099), (5, 20000)])
def test_int8_rows_is_the_reference_bit_for_bit(n, d, dt):
    X, _ = _banks(n + d, n, d)
    Xr = jnp.asarray(X, dt)
    _, want = ref_stages.Int8RowCompressor().apply((), Xr)
    _, got = stages.Int8RowCompressor().apply((), tensor_from_numpy(
        np.asarray(Xr)))
    assert got.dtype == (torch.float32 if dt == "float32" else torch.bfloat16)
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want, np.float32))


@pytest.mark.parametrize("ratio", [0.05, 0.3, 1e-6])
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,d", [(3, 7), (8, 4099), (5, 20000)])
def test_topk_ef_is_the_reference_and_feeds_back_exactly(n, d, dt, ratio):
    X, R = _banks(n * d, n, d)
    Xr = jnp.asarray(X, dt)
    comp = ref_stages.TopKEFCompressor(ratio)
    want_r, want = comp.apply(jnp.asarray(R), Xr)
    Xt = tensor_from_numpy(np.asarray(Xr))
    Rt = torch.from_numpy(R)
    got_r, got = stages.TopKEFCompressor(ratio).apply(Rt, Xt)
    assert got.dtype == Xt.dtype and got_r.dtype == torch.float32
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want, np.float32))
    np.testing.assert_array_equal(got_r.numpy(), np.asarray(want_r))
    # Error feedback: what was sent plus what is kept is exactly the
    # signal, in f32, whatever the bank dtype.
    assert torch.equal(got.float() + got_r, Xt.float() + Rt)
    k = max(int(ratio * d), 1)
    assert int((got.float() != 0).sum(dim=1).min()) >= min(k, d - d // 3)


@pytest.mark.parametrize("sparse", [False, True])
def test_selfloop_correction_is_the_reference(sparse):
    n, d = 9, 300
    X, R = _banks(5, n, d)
    Xq = X + R
    if sparse:
        P = ref_topo.sample_kout_neighbors(_key(3), n, 2)
        Pt = _nl(P)
        mixed = ref_pushsum.gossip_bank(P, jnp.asarray(Xq), use_kernel=False)
    else:
        P = ref_topo.sample_kout(_key(3), n, 2)
        Pt = _t(P)
        mixed = ref_pushsum.gossip_bank(P, jnp.asarray(Xq), use_kernel=False)
    mixed = np.array(mixed)
    want = ref_stages._selfloop_correction(P, jnp.asarray(Xq), jnp.asarray(X),
                                           jnp.asarray(mixed))
    got = stages._selfloop_correction(Pt, torch.from_numpy(Xq),
                                      torch.from_numpy(X),
                                      torch.from_numpy(mixed))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    same = torch.from_numpy(mixed)
    Xt = torch.from_numpy(X)
    assert stages._selfloop_correction(Pt, Xt, Xt, same) is same


# -- the oracle's pytree forms -----------------------------------------------------

def test_pytree_pushsum_and_momentum_are_the_reference():
    rng = np.random.default_rng(4)
    n = 8
    tree = {"a": {"w": rng.standard_normal((n, 5, 3)).astype(np.float32)},
            "b": rng.standard_normal((n, 7)).astype(np.float32)}
    v = {"a": {"w": rng.standard_normal((n, 5, 3)).astype(np.float32)},
         "b": rng.standard_normal((n, 7)).astype(np.float32)}
    w = rng.uniform(0.5, 1.5, n).astype(np.float32)
    ref_tree = jax.tree.map(jnp.asarray, tree)
    port_tree = params_from_numpy(tree)
    wt = torch.from_numpy(w)
    for P in (ref_topo.sample_kout(_key(1), n, 2),
              ref_topo.sample_kout_neighbors(_key(1), n, 2)):
        Pt = _nl(P) if isinstance(P, ref_topo.NeighborList) else _t(P)
        want = ref_pushsum.gossip(P, ref_tree, use_kernel=False)
        for use_kernel in (False, True):
            got = pushsum.gossip(Pt, port_tree, use_kernel=use_kernel)
            for g, wl in zip(tree_flatten(got)[1], jax.tree.leaves(want)):
                np.testing.assert_allclose(g.numpy(), np.asarray(wl), rtol=0,
                                           atol=1e-6 * float(
                                               np.abs(wl).max()))
    want = ref_pushsum.debias(ref_tree, jnp.asarray(w))
    got = pushsum.debias(port_tree, wt)
    for g, wl in zip(tree_flatten(got)[1], jax.tree.leaves(want)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(wl))
    want = float(ref_pushsum.consensus_error(ref_tree, jnp.asarray(w)))
    assert abs(float(pushsum.consensus_error(port_tree, wt)) - want) \
        <= 1e-5 * want
    for alpha in (0.0, 0.9):
        ref_v = ref_sam.momentum_update(jax.tree.map(jnp.asarray, v),
                                        ref_tree, alpha)
        port_v = sam.momentum_update(params_from_numpy(v), port_tree, alpha)
        for g, wl in zip(tree_flatten(port_v)[1], jax.tree.leaves(ref_v)):
            np.testing.assert_array_equal(g.numpy(), np.asarray(wl))
        ref_x = ref_sam.apply_update(ref_tree, ref_v, jnp.float32(0.05))
        port_x = sam.apply_update(port_tree, port_v, 0.05)
        for g, wl in zip(tree_flatten(port_x)[1], jax.tree.leaves(ref_x)):
            np.testing.assert_array_equal(g.numpy(), np.asarray(wl))
