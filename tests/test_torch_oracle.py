"""The port's ``flat=False`` oracle, and the invariants the scenario path
must keep in the port alone.

Oracle parity: the port's ``flat=False`` path against the reference's, on
the golden setting (mnist_2nn, n = 8, kout k_out = 2, 3 local steps, 3
rounds) and the reference's own draws (``_torch_parity.reference_draws``
reads the oracle's key chain too: it splits its keys as the flat round
does).  Both mix with their plain versions in f32, so each leaf holds
within 1e-5 of its largest magnitude, ``w`` within 1e-6, loss, accuracy
and the test metrics within 1e-5.  int8 (``quantize_gossip``) quantizes
each client-stacked leaf with one global scale, ``step = max|leaf| /
127`` of the pre-mix leaf (read from the port's own local steps on the
round's draws); a code within the noise of a rounding boundary flips, so
that run restarts the port from the reference's state every round and
holds leaf row i to ``1e-5 max|leaf| + step * sum_{j != i} P[i, j]`` (the
self-loop is never quantized).

Invariants of the port (its own draws, the CPU):

* a zero ``LinkModel`` and a zero ``ChurnModel`` build the plain program,
  bit for bit;
* ``delta="full"`` trains the dense bank's models: the de-biased models
  agree within 1e-5 of their magnitude after 3 rounds (``z = base +
  delta / w`` against ``x / w``: the same updates, rounded around another
  origin);
* push-sum mass ``w.sum() + bufw.sum()`` stays n = 8 within 1e-5 (about
  ten f32 ulps of 8) over 20 rounds of drops, delays and churn;
* the oracle equals the flat path round by round on the same seed: the
  same draws in the same order, the same f32 operations per element (the
  dense mix sums each coordinate over senders in the same order, leaf by
  leaf or row by row), so the states are equal bit for bit.  Their
  consensus models are means over clients reduced over differently shaped
  tensors (whole rows against leaves), so they and the test metrics agree
  within 1e-6 of their magnitude and 1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (BATCH, K_OUT, LOCAL_STEPS, N_CLIENTS,
                           PARTICIPATION, golden_data, reference_draws)
from repro.core import FLTrainer as RefTrainer
from repro.core import TopologyConfig as RefTopo
from repro.core import make_algo as ref_make_algo
from repro.data.synthetic import make_dataset
from repro.models.small import mnist_2nn as ref_mnist_2nn
from repro_torch.core import (ChurnModel, DeltaConfig, FLState, FLTrainer,
                              LinkModel, TopologyConfig, make_algo, topology)
from repro_torch.core.flat import tree_flatten, tree_map
from repro_torch.interop import params_from_numpy
from repro_torch.models.small import mnist_2nn
from _torch_threads import one_thread  # noqa: F401,E402  (an autouse fixture)


@pytest.fixture(scope="module")
def cdata():
    return golden_data()


@pytest.fixture(scope="module")
def test_data():
    return make_dataset("mnist", 1200, 100, seed=0)[1]


def _leaves_t(tree):
    return tree_flatten(tree)[1]


def _leaves(tree):
    return [np.asarray(x) for x in _leaves_t(tree)]


def _port_oracle_state(ref, gen):
    s = jax.device_get(ref.state)
    return FLState(params_from_numpy(s.params), None,
                   torch.from_numpy(np.array(s.w)), gen, int(s.round),
                   torch.from_numpy(np.array(s.losses)))


def _dense_p(P):
    if isinstance(P, topology.NeighborList):
        return topology.dense_from_neighbors(P, N_CLIENTS).numpy()
    return np.asarray(P, np.float32)


@pytest.mark.parametrize("name,algo_kw", [
    ("dfedsgpsm", {}), ("fedavg", {}), ("dfedsgpsm",
                                        dict(quantize_gossip=True)),
], ids=["dfedsgpsm", "fedavg", "dfedsgpsm-int8"])
def test_oracle_matches_the_reference_oracle(cdata, test_data, name, algo_kw):
    int8 = bool(algo_kw)
    kw = dict(local_steps=LOCAL_STEPS, batch_size=BATCH, **algo_kw)
    ref_model = ref_mnist_2nn()
    ref = RefTrainer(ref_model.loss, ref_model.init,
                     {k: jnp.asarray(v) for k, v in cdata.items()},
                     ref_make_algo(name, **kw),
                     RefTopo(kind="kout", n_clients=N_CLIENTS, k_out=K_OUT),
                     seed=0, participation=PARTICIPATION, flat=False)
    model = mnist_2nn()
    port = FLTrainer(model.loss, model.init, cdata, make_algo(name, **kw),
                     TopologyConfig(kind="kout", n_clients=N_CLIENTS,
                                    k_out=K_OUT),
                     seed=0, participation=PARTICIPATION, flat=False,
                     device="cpu")
    port.state = _port_oracle_state(ref, port.state.key)
    m_rows = cdata["x"].shape[1]
    for r in range(3):
        draws = reference_draws(ref, m_rows)
        if int8:
            port.state = _port_oracle_state(ref, port.state.key)
            st = port.state
            x_half, _, _ = port._local_update(
                st.params, st.w, torch.as_tensor(draws["batch_idx"]).long(),
                port.program.data, port.program.round_lr(st.round))
            steps = [float(x.abs().max()) / 127.0 for x in _leaves_t(x_half)]
        ref_m = {k: float(v) for k, v in ref.run_round().items()}
        port_m = {k: float(v) for k, v in port.run_round(draws).items()}
        for k in ("loss", "acc"):
            assert abs(port_m[k] - ref_m[k]) <= 1e-5, (k, r, port_m, ref_m)
        want_leaves = [np.asarray(x) for x in jax.tree.leaves(
            jax.device_get(ref.state.params))]
        for i, (got, want) in enumerate(zip(_leaves(port.state.params),
                                            want_leaves, strict=True)):
            tol = 1e-5 * float(np.abs(want).max())
            if int8:
                off = _dense_p(draws["P"]) * (1 - np.eye(N_CLIENTS))
                tol = tol + steps[i] * off.sum(axis=1).reshape(
                    (-1,) + (1,) * (want.ndim - 1))
            assert np.all(np.abs(got - want) <= tol), (r, name)
        np.testing.assert_allclose(port.state.w.numpy(),
                                   np.asarray(ref.state.w), rtol=0, atol=1e-6)
    tl, ta = port.evaluate(test_data, batch=64)  # a ragged last chunk
    rl, ra = ref.evaluate({k: jnp.asarray(v) for k, v in test_data.items()},
                          batch=64)
    assert abs(tl - rl) <= 1e-5 and abs(ta - ra) <= 1e-5
    if name != "fedavg":
        z = _leaves(port.debiased_models())
        for got, want in zip(z, jax.tree.leaves(ref.debiased_models())):
            np.testing.assert_allclose(got, np.asarray(want), rtol=0,
                                       atol=1e-5 * float(np.abs(want).max()))
        want = float(ref.consensus_error())
        assert abs(float(port.consensus_error()) - want) <= 1e-4 * want


@pytest.mark.parametrize("name", ["dfedsgpsm", "dfedavgm", "fedavg"])
def test_oracle_equals_the_flat_path_bit_for_bit(cdata, test_data, name):
    model = mnist_2nn()
    algo = make_algo(name, local_steps=2, batch_size=BATCH)
    topo = TopologyConfig(kind="kout", n_clients=N_CLIENTS, k_out=K_OUT)
    flat, oracle = (FLTrainer(model.loss, model.init, cdata, algo, topo,
                              seed=0, participation=PARTICIPATION, flat=f,
                              device="cpu") for f in (True, False))
    ravel = (flat.spec.ravel if name == "fedavg"
             else flat.spec.ravel_stacked)
    for r in range(3):
        mf, mo = flat.run_round(), oracle.run_round()
        assert float(mf["loss"]) == float(mo["loss"]), r
        assert torch.equal(flat.state.params, ravel(oracle.state.params)), r
        assert torch.equal(flat.state.w, oracle.state.w)
        assert torch.equal(flat.state.losses, oracle.state.losses)
    for a, b in zip(tree_flatten(flat.average_model())[1],
                    tree_flatten(oracle.average_model())[1]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0,
                                   atol=1e-6 * float(b.abs().max()))
    for a, b in zip(flat.evaluate(test_data), oracle.evaluate(test_data)):
        assert abs(a - b) <= 1e-5
    hist = oracle.fit(2, test_data=test_data, eval_every=2)
    assert [h["round"] for h in hist] == [0, 1] and "test_acc" in hist[1]


@pytest.mark.parametrize("gossip", ["dense", "sparse"])
def test_zero_scenarios_are_the_plain_program_bit_for_bit(cdata, gossip):
    model = mnist_2nn()
    algo = make_algo("dfedsgpsm", local_steps=2, batch_size=BATCH)
    topo = TopologyConfig(kind="kout", n_clients=N_CLIENTS, k_out=K_OUT)
    plain, zero = (FLTrainer(model.loss, model.init, cdata, algo, topo,
                             seed=1, gossip=gossip, device="cpu", **kw)
                   for kw in ({}, dict(link=LinkModel(), churn=ChurnModel())))
    assert zero.program.link is None and not zero.program.churned
    for _ in range(2):
        mp, mz = plain.run_round(), zero.run_round()
        assert set(mp) == set(mz) == {"loss", "acc"}
        assert torch.equal(plain.state.params, zero.state.params)
        assert torch.equal(plain.state.w, zero.state.w)
        assert torch.equal(plain.state.losses, zero.state.losses)


def test_full_rank_delta_trains_the_dense_models(cdata):
    model = mnist_2nn()
    algo = make_algo("dfedsgpsm", local_steps=2, batch_size=BATCH)
    topo = TopologyConfig(kind="kout", n_clients=N_CLIENTS, k_out=K_OUT)
    tr_d = FLTrainer(model.loss, model.init, cdata, algo, topo, seed=0,
                     delta=DeltaConfig(rank="full", adapt="all"), device="cpu")
    base = tr_d.spec.base
    tr_x = FLTrainer(model.loss, lambda g: tree_map(torch.clone, base), cdata,
                     algo, topo, seed=0, device="cpu")
    for _ in range(3):
        md, mx = tr_d.run_round(), tr_x.run_round()
        assert abs(float(md["loss"]) - float(mx["loss"])) <= 1e-5
    for a, b in zip(tree_flatten(tr_d.debiased_models())[1],
                    tree_flatten(tr_x.debiased_models())[1]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0,
                                   atol=1e-5 * float(b.abs().max()))


@pytest.mark.parametrize("gossip", ["dense", "sparse"])
def test_mass_is_n_over_20_rounds_of_drops_delays_and_churn(cdata, gossip):
    model = mnist_2nn()
    tr = FLTrainer(model.loss, model.init, cdata,
                   make_algo("dfedsgpsm", local_steps=1, batch_size=16),
                   TopologyConfig(kind="kout", n_clients=N_CLIENTS,
                                  k_out=K_OUT), seed=2, gossip=gossip,
                   link=LinkModel(drop=0.3, delay=2),
                   churn=ChurnModel(fail_prob=0.2, recover_prob=0.5,
                                    permanent_frac=0.1, resurrect="cold"),
                   device="cpu")
    for rec in tr.fit(20, superstep=7):
        assert abs(rec["w_mass"] - N_CLIENTS) <= 1e-5, rec
    st = tr.state
    total = float(st.w.sum() + st.link.bufw.sum())
    assert abs(total - N_CLIENTS) <= 1e-5
