"""SAM, push-sum, interop and the round program of the port on its own
draws.

SAM and push-sum are held against the reference on shared numpy inputs
(float32 on the CPU; reductions in their own orders, so 1e-5 of the
magnitude for gradients and 1e-6 for mixed weights).  The round program
is checked for what holds whatever the draws: push-sum mass stays n,
losses are finite, the eval cadence follows the global round counter,
central rounds refresh only the sampled clients' losses.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import pushsum as ref_pushsum
from repro.core import sam as ref_sam
from repro.core import topology as ref_topology
from repro.models import small as ref_small
from repro_torch.core import (
    ALGORITHMS, FLTrainer, TopologyConfig, make_algo, make_program, pushsum,
    sam, topology,
)
from repro_torch.core.flat import tree_flatten
from repro_torch.data.dirichlet import dirichlet_partition, stack_client_data
from repro_torch.data.synthetic import make_dataset
from repro_torch.interop import (
    bank_row_from_numpy, params_from_numpy, state_from_numpy,
    tensor_from_numpy,
)
from repro_torch.models import small
from _torch_threads import one_thread  # noqa: F401,E402  (an autouse fixture)


@pytest.fixture(scope="module")
def setting():
    train, test = make_dataset("mnist", 600, 64, seed=1)
    parts = dirichlet_partition(train["y"], 8, alpha=0.3, seed=1)
    return small.mnist_2nn(), stack_client_data(train, parts, pad_to=64), test


# -- SAM and push-sum against the reference ------------------------------------

@pytest.mark.parametrize("rho", [0.0, 0.1])
def test_sam_gradient_matches_reference(rho):
    ref_model = ref_small.mnist_2nn()
    ref_params = jax.device_get(jax.jit(ref_model.init)(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(0)
    batch = {"x": rng.standard_normal((16, 784)).astype(np.float32),
             "y": rng.integers(0, 10, 16).astype(np.int32)}
    ref_g, (ref_loss, ref_acc) = jax.jit(
        lambda p, b: ref_sam.sam_gradient(ref_model.loss, p, b, rho))(
            ref_params, batch)
    model = small.mnist_2nn()
    g, (loss, acc) = sam.sam_gradient(
        model.loss, params_from_numpy(ref_params),
        {k: torch.from_numpy(v) for k, v in batch.items()}, rho)
    assert abs(float(loss) - float(ref_loss)) <= 1e-5
    assert float(acc) == float(ref_acc)
    ref_leaves = [np.asarray(x) for x in jax.tree.leaves(ref_g)]
    scale = max(np.abs(x).max() for x in ref_leaves)
    for got, want in zip(tree_flatten(g)[1], ref_leaves, strict=True):
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=1e-5 * scale)
    norm = sam.global_norm(g)
    assert abs(float(norm) - float(ref_sam.global_norm(ref_g))) <= 1e-5 * (
        float(norm))


def test_pushsum_matches_reference():
    rng = np.random.default_rng(1)
    n, d = 9, 40
    X = rng.standard_normal((n, d)).astype(np.float32)
    w = rng.uniform(0.5, 1.5, n).astype(np.float32)
    P = np.asarray(jax.random.uniform(jax.random.PRNGKey(1), (n, n)))
    P = (P / P.sum(axis=0, keepdims=True)).astype(np.float32)
    np.testing.assert_allclose(
        pushsum.gossip_weights(torch.from_numpy(P), torch.from_numpy(w)).numpy(),
        np.asarray(ref_pushsum.gossip_weights(jnp.asarray(P), jnp.asarray(w))),
        rtol=0, atol=1e-6)
    nl = jax.device_get(ref_topology.sample_kout_neighbors(
        jax.random.PRNGKey(2), n, 3))
    port_nl = topology.NeighborList(torch.from_numpy(np.array(nl.idx)),
                                    torch.from_numpy(np.array(nl.wgt)))
    np.testing.assert_allclose(
        pushsum.gossip_weights(port_nl, torch.from_numpy(w)).numpy(),
        np.asarray(ref_pushsum.gossip_weights(nl, jnp.asarray(w))),
        rtol=0, atol=1e-6)
    np.testing.assert_allclose(
        pushsum.gossip_bank(port_nl, torch.from_numpy(X)).numpy(),
        np.asarray(ref_pushsum.gossip_bank(nl, jnp.asarray(X))),
        rtol=0, atol=1e-6 * np.abs(X).max())
    np.testing.assert_array_equal(
        pushsum.debias_bank(torch.from_numpy(X), torch.from_numpy(w)).numpy(),
        np.asarray(ref_pushsum.debias_bank(jnp.asarray(X), jnp.asarray(w))))
    assert abs(float(pushsum.consensus_error_bank(
        torch.from_numpy(X), torch.from_numpy(w))) - float(
        ref_pushsum.consensus_error_bank(jnp.asarray(X), jnp.asarray(w)))) \
        <= 1e-5 * float(ref_pushsum.consensus_error_bank(
            jnp.asarray(X), jnp.asarray(w)))


def test_interop_carries_bf16_bit_for_bit():
    a = np.asarray(jnp.asarray(np.linspace(-3, 3, 11), jnp.bfloat16))
    t = tensor_from_numpy(a)
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.float().numpy(), a.astype(np.float32))
    row = bank_row_from_numpy(np.arange(5, dtype=np.float32))
    assert row.dtype == torch.float32 and row.tolist() == [0, 1, 2, 3, 4]
    gen = torch.Generator()
    st = state_from_numpy({"params": np.ones((3, 4), np.float32), "w":
                           np.ones(3, np.float32), "round": np.int32(2),
                           "losses": np.zeros(3, np.float32)}, gen)
    assert st.round == 2 and st.mom is None and st.key is gen


# -- the round program on its own draws -----------------------------------------

@pytest.mark.parametrize("gossip", ["dense", "sparse"])
@pytest.mark.parametrize("name", ["dfedsgpsm", "dfedsam", "fedavg"])
def test_own_draws_keep_mass_and_finite_losses(setting, name, gossip):
    model, cdata, test = setting
    tr = FLTrainer(model.loss, model.init, cdata,
                   make_algo(name, local_steps=2, batch_size=16),
                   TopologyConfig(kind="kout", n_clients=8, k_out=2), seed=3,
                   participation=0.25, gossip=gossip, device="cpu")
    assert tr.program.sparse_mix == (gossip == "sparse" and name != "fedavg")
    hist = tr.fit(3, test_data=test, eval_every=2)
    assert [h["round"] for h in hist] == [0, 1, 2]
    assert all(np.isfinite(h["loss"]) for h in hist)
    assert ["test_loss" in h for h in hist] == [False, True, False]
    assert abs(float(tr.state.w.sum()) - 8.0) <= 1e-5
    assert tr.state.round == 3
    tl, ta = tr.evaluate(test)
    assert np.isfinite(tl) and 0.0 <= ta <= 1.0
    avg = tr.average_model()
    assert set(avg) == {"fc1", "fc2", "out"}


def test_same_seed_same_run(setting):
    model, cdata, _ = setting
    runs = []
    for _ in range(2):
        tr = FLTrainer(model.loss, model.init, cdata,
                       make_algo("dfedsgpsm_s", local_steps=2),
                       TopologyConfig(kind="kout", n_clients=8, k_out=2),
                       seed=5, device="cpu")
        tr.run_round()
        tr.run_round()
        runs.append(tr.state.params.clone())
    assert torch.equal(runs[0], runs[1])


def test_central_round_refreshes_only_the_sampled_losses(setting):
    model, cdata, _ = setting
    tr = FLTrainer(model.loss, model.init, cdata,
                   make_algo("fedavg", local_steps=1),
                   TopologyConfig(kind="kout", n_clients=8, k_out=2), seed=0,
                   participation=0.25, device="cpu")
    sel = torch.tensor([6, 1])
    idx = torch.zeros((1, 2, 32), dtype=torch.long)
    m = tr.run_round({"sel": sel, "batch_idx": idx})
    nz = torch.nonzero(tr.state.losses).flatten().tolist()
    assert sorted(nz) == [1, 6]
    assert abs(float(m["loss"]) - float(tr.state.losses[sel].mean())) < 1e-6
    assert tr.state.params.shape == (tr.spec.dim,)


def test_run_superstep_history_and_exponential_cycle(setting):
    model, cdata, test = setting
    prog = make_program(model.loss, model.init, cdata,
                        make_algo("sgp", local_steps=1),
                        TopologyConfig(kind="exponential", n_clients=8, k_out=1),
                        gossip="sparse", device="cpu")
    assert prog.exp_cycle.idx.shape == (3, 8, 2)
    state = prog.init(torch.Generator().manual_seed(0))
    state, hist = prog.run_superstep(state, 4, eval_every=2, test_data=test)
    assert hist["loss"].shape == (4,)
    assert hist["eval_mask"].tolist() == [False, True, False, True]
    assert abs(float(state.w.sum()) - 8.0) <= 1e-5


def test_unported_stages_and_options_are_refused(setting):
    model, cdata, _ = setting
    topo = TopologyConfig(kind="kout", n_clients=8, k_out=2)
    for algo in (make_algo("sgp", compressor="zip"),
                 make_algo("sgp", solver="adam")):
        with pytest.raises(ValueError, match="unknown stage"):
            make_program(model.loss, model.init, cdata, algo, topo,
                         device="cpu")
    with pytest.raises(ValueError, match="gossip must be"):
        make_program(model.loss, model.init, cdata, make_algo("sgp"), topo,
                     gossip="nccl", device="cpu")
    # The halo executor and the mesh are ported: without a mesh "halo"
    # refuses, and a mesh must carry the clients axis and divide n.
    with pytest.raises(ValueError, match="needs a mesh"):
        make_program(model.loss, model.init, cdata, make_algo("sgp"), topo,
                     gossip="halo", device="cpu")

    class Mesh:
        def __init__(self, **axes):
            self.axis_names, self.shape = tuple(axes), dict(axes)

    for mesh, msg in ((Mesh(data=2), "no 'clients' axis"),
                      (Mesh(clients=3), "divisible")):
        with pytest.raises(ValueError, match=msg):
            FLTrainer(model.loss, model.init, cdata, make_algo("sgp"), topo,
                      device="cpu", mesh=mesh)
    with pytest.raises(ValueError, match="no client bank to shard"):
        make_program(model.loss, model.init, cdata, make_algo("fedavg"),
                     topo, device="cpu", mesh=Mesh(clients=2))
    # paged= is ported (the disk-backed store): without a store it refuses
    # as the reference does.
    with pytest.raises(ValueError, match="needs store_dir"):
        FLTrainer(model.loss, model.init, cdata, make_algo("sgp"), topo,
                  device="cpu", paged=True)


def test_registry_matches_reference():
    from repro.core import ALGORITHMS as REF

    assert sorted(ALGORITHMS) == sorted(REF)
    for name, cfg in ALGORITHMS.items():
        ref = REF[name]
        for field in ("comm", "local_steps", "rho", "alpha", "selection",
                      "lr", "lr_decay", "batch_size", "solver", "compressor",
                      "topk_ratio", "prox_mu", "quantize_gossip"):
            assert getattr(cfg, field) == getattr(ref, field), (name, field)
