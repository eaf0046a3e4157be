"""The two-tier topology family in the port (``TopologyConfig(kind=
"two_tier")``, ``TwoTierOp``, ``build_two_tier``, its mixes, rounds, paged
round and CLI) against the JAX reference, on the CPU.

The reference samples the operator from ``jax.random.uniform(key, (n,
n))``; the port's build takes those scores and must give the reference's
``idx``, ``wgt`` and ``intra`` bit for bit, at n = 8 with 2 pods and n = 64
with 8.  Rounds replay the reference's draws (the operator from its
``mixing_matrix``, the minibatches from its key chain, as
``_torch_parity`` recomputes them) and restart the port from the
reference's state before every round (3 rounds, DFedSGPSM, dense and
operator form, uncompressed and with top-k EF).

Tolerances: both packages compute in f32 on the CPU and differ only in the
order of their reductions (the reference's intra term is an einsum at
HIGHEST precision, the port's a ``bmm``): the bank within 1e-5 of its
largest magnitude, w within 1e-6, loss and accuracy within 1e-5 (the
round-parity tests' bounds), plus under top-k EF the flip bound of
``test_torch_round_compress.py`` on the residual and, on the bank, over
the coordinates some sender swapped; the
operator and dense mixes against each other within 1e-6 of the output's
magnitude.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (
    PreCompression,
    flip_step,
    golden_data,
    run_scenario_parity,
    swap_bound,
)
from repro.core import ChurnModel as RefChurn
from repro.core import LinkModel as RefLink
from repro.core import TopologyConfig as RefTopo
from repro.core import make_algo as ref_make_algo
from repro.core import make_program as ref_make_program
from repro.core import topology as ref_topology
from repro.core.program import plan_keys as ref_plan_keys
from repro.data.dirichlet import dirichlet_partition, stack_client_data
from repro.data.synthetic import DatasetSpec, make_dataset
from repro.models.small import tiny_mlp as ref_tiny_mlp
from repro.store import ResidentDriver as RefResident
from repro_torch.core import (
    ChurnModel,
    LinkModel,
    TopologyConfig,
    make_algo,
    make_program,
    pushsum,
    topology,
)
from repro_torch.launch import train
from repro_torch.models.small import tiny_mlp
from repro_torch.store import ResidentDriver


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


SHAPES = [(8, 2, 2), (64, 8, 10)]  # (n, n_pods, k_out)


def _ops(n, pods, k, seed):
    key = jax.random.PRNGKey(seed)
    ref = jax.jit(ref_topology.sample_two_tier, static_argnums=(1, 2, 3))(
        key, n, pods, k)
    scores = np.array(jax.random.uniform(key, (n, n)))
    return ref, topology.build_two_tier(torch.from_numpy(scores), pods, k)


@pytest.mark.parametrize("n,pods,k", SHAPES)
@pytest.mark.parametrize("seed", [0, 7])
def test_build_equals_the_references_on_its_scores(n, pods, k, seed):
    ref, op = _ops(n, pods, k, seed)
    assert op.inter.idx.dtype == torch.int32
    assert op.intra.shape == (pods, n // pods, n // pods)
    np.testing.assert_array_equal(op.inter.idx.numpy(), np.asarray(ref.inter.idx))
    np.testing.assert_array_equal(op.inter.wgt.numpy(), np.asarray(ref.inter.wgt))
    np.testing.assert_array_equal(op.intra.numpy(), np.asarray(ref.intra))
    cfg = TopologyConfig(kind="two_tier", n_clients=n, k_out=k, n_pods=pods)
    ref_cfg = RefTopo(kind="two_tier", n_clients=n, k_out=k, n_pods=pods)
    assert topology.neighbor_k_max(cfg) == ref_topology.neighbor_k_max(ref_cfg)
    assert topology.family_k_in(cfg) == ref_topology.family_k_in(ref_cfg)


@pytest.mark.parametrize("n,pods,k", SHAPES)
def test_dense_form_equals_the_references_and_is_column_stochastic(n, pods, k):
    ref, op = _ops(n, pods, k, 3)
    P = topology.dense_from_two_tier(op)
    np.testing.assert_array_equal(P.numpy(),
                                  np.asarray(ref_topology.dense_from_two_tier(ref)))
    assert topology.is_column_stochastic(P, atol=1e-6)
    # The self-loop rides the pod blocks' diagonals, never the inter slot 0.
    assert torch.all(op.inter.wgt[:, 0] == 0)
    gen = torch.Generator().manual_seed(1)
    cfg = TopologyConfig(kind="two_tier", n_clients=n, k_out=k, n_pods=pods)
    drawn = topology.sample_neighbors(gen, cfg)
    assert isinstance(drawn, topology.TwoTierOp)
    assert topology.is_column_stochastic(topology.sample_mixing(gen, cfg))


@pytest.mark.parametrize("n,pods,k", SHAPES)
def test_operator_mix_equals_dense_mix(n, pods, k):
    _, op = _ops(n, pods, k, 5)
    P = topology.dense_from_two_tier(op)
    gen = torch.Generator().manual_seed(2)
    X = torch.randn(n, 257, generator=gen)
    w = torch.rand(n, generator=gen) + 0.5
    got, want = pushsum.gossip_bank(op, X), pushsum.gossip_bank(P, X)
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) <= 1e-6 * scale
    gw, ww = pushsum.gossip_weights(op, w), pushsum.gossip_weights(P, w)
    assert float((gw - ww).abs().max()) <= 1e-6 * float(ww.abs().max())
    assert abs(float(gw.sum()) - float(w.sum())) <= 1e-5 * n


def test_config_checks_match_the_references():
    for kw, msg in ((dict(n_clients=8, k_out=2), "n_pods >= 2"),
                    (dict(n_clients=8, k_out=2, n_pods=3), "divisible"),
                    (dict(n_clients=8, k_out=5, n_pods=2), "k_out must be")):
        for cls in (RefTopo, TopologyConfig):
            with pytest.raises(ValueError, match=msg):
                cls(kind="two_tier", **kw)
    for cls in (RefTopo, TopologyConfig):
        with pytest.raises(ValueError, match="two_tier-only"):
            cls(kind="kout", n_clients=8, k_out=2, n_pods=2)


# -- rounds, replaying the reference's draws ----------------------------------

N, PODS, K_OUT = 8, 2, 2
TOPO = dict(kind="two_tier", n_clients=N, k_out=K_OUT, n_pods=PODS)


@pytest.mark.parametrize("compressor,gossip", [
    pytest.param("identity", "dense", id="dense"),
    pytest.param("identity", "sparse", id="sparse"),
    pytest.param("topk_ef", "dense", id="topk_ef-dense"),
    pytest.param("topk_ef", "sparse", id="topk_ef-sparse"),
])
def test_rounds_hold_parity_with_the_reference(compressor, gossip):
    """The top-k EF cases run the self-loop correction, which reads the
    self-weights off the pod blocks' diagonals in the operator form (its
    inter list's slot 0 is a zero pad).  Their bank is held to 1e-5 max|X|
    plus, per coordinate, the flip bound of ``test_torch_round_compress.py``
    over the senders that swapped that coordinate (``swap_bound``): a
    wrong self-weight moves receiver i's row by its own dropped share,
    which no other sender's flip covers."""
    probe = PreCompression()
    for r, ref_m, port_m, ref_s, port_s in run_scenario_parity(
            "dfedsgpsm", gossip, golden_data(), topo=TOPO,
            algo_kw=dict(compressor=compressor), resync=True, probe=probe):
        rec = probe.rounds[r]
        want, got = ref_s["params"], port_s["params"]
        scale = float(np.abs(want).max())
        bound = 1e-5 * scale
        if compressor == "topk_ef":
            step = flip_step(rec, compressor)
            bound = bound + swap_bound(rec["P"], step, ref_s["comp"],
                                       port_s["comp"])
            np.testing.assert_allclose(
                port_s["comp"], ref_s["comp"], rtol=0,
                atol=1e-5 * scale + float(step.max()),
                err_msg=f"{gossip} residual, round {r}")
        err = np.abs(got - want)
        assert np.all(err <= bound), (compressor, gossip, r,
                                      float((err - bound).max()))
        np.testing.assert_allclose(port_s["w"], ref_s["w"], rtol=0,
                                   atol=1e-6, err_msg=f"{gossip} w, round {r}")
        mom = ref_s["mom"]
        np.testing.assert_allclose(port_s["mom"], mom, rtol=0,
                                   atol=1e-5 * float(np.abs(mom).max()))
        for k in ("loss", "acc"):
            assert abs(port_m[k] - ref_m[k]) <= 1e-5, (gossip, k, r, port_m,
                                                       ref_m)
        assert abs(float(port_s["w"].sum()) - N) <= 1e-5


def test_the_self_weights_are_the_pod_blocks_diagonals():
    """The self-loop correction's weight per receiver: the diagonal of the
    dense form, never the inter list's zero-weight slot 0."""
    from repro_torch.core.stages import _self_weights

    _, op = _ops(N, PODS, K_OUT, 4)
    want = np.diagonal(topology.dense_from_two_tier(op).numpy())
    np.testing.assert_array_equal(_self_weights(op).numpy(), want)
    assert np.all(want > 0)


def test_operator_form_refuses_drops_and_churn_as_the_reference_does():
    m, rm = tiny_mlp(), ref_tiny_mlp()
    cdata = golden_data()
    for kw, msg in ((dict(link="drop"), "link drops on the two-tier"),
                    (dict(churn="churn"), "churn on the two-tier"),
                    (dict(algo="dfedsam"), "directed push-sum gossip only"),
                    (dict(algo="dfedsgpsm_s"), "no two-tier form")):
        for pkg in ("ref", "port"):
            algo = (ref_make_algo if pkg == "ref" else make_algo)(
                kw.get("algo", "sgp"))
            link = churn = None
            if "link" in kw:
                link = (RefLink if pkg == "ref" else LinkModel)(drop=0.2)
            if "churn" in kw:
                churn = (RefChurn if pkg == "ref" else ChurnModel)(
                    fail_prob=0.1)
            with pytest.raises(ValueError, match=msg):
                if pkg == "ref":
                    ref_make_program(
                        rm.loss, rm.init,
                        {k: jnp.asarray(v) for k, v in cdata.items()}, algo,
                        RefTopo(kind="two_tier", n_clients=N, k_out=K_OUT,
                                n_pods=PODS),
                        gossip="sparse", link=link, churn=churn)
                else:
                    make_program(m.loss, m.init, cdata, algo,
                                 TopologyConfig(kind="two_tier", n_clients=N,
                                                k_out=K_OUT, n_pods=PODS),
                                 gossip="sparse", link=link, churn=churn,
                                 device="cpu")
    _, op = _ops(8, 2, 2, 0)
    with pytest.raises(ValueError, match="two-tier operator form"):
        LinkModel(drop=0.1).drop_links(torch.rand(8, 3), op)
    with pytest.raises(ValueError, match="two-tier operator form"):
        ChurnModel(fail_prob=0.1).mask_operator(op, torch.ones(8, dtype=bool))


# -- the paged round --------------------------------------------------------------

PAGED_N, K_ACTIVE = 32, 4


def _paged_data():
    spec = DatasetSpec("toy", (16,), 4, margin=3.0)
    train_set, _ = make_dataset(spec, PAGED_N * 16, 64, seed=0)
    parts = dirichlet_partition(train_set["y"], PAGED_N, alpha=10.0, seed=0)
    return stack_client_data(train_set, parts, pad_to=32)


def _resident_draws(drv) -> dict:
    prog = drv.program
    _, akey, tkey, ckey_base = ref_plan_keys(drv._key)
    n = prog.n
    perm = np.asarray(jax.random.permutation(akey, n))
    active = perm[:drv.k_active]
    draws = {"perm": perm, "scores": np.asarray(
        jax.random.uniform(tkey, (drv.k_active, n)))}
    m = np.asarray(prog.data["x"]).shape[1]
    rows = []
    for g in active:
        key = jax.random.fold_in(ckey_base, int(g))
        steps = []
        for _ in range(prog.solver.local_steps):
            key, bk = jax.random.split(key)
            steps.append(np.asarray(jax.random.randint(
                bk, (prog.solver.batch_size,), 0, m)))
        rows.append(steps)
    draws["batch_idx"] = np.asarray(rows).transpose(1, 0, 2)
    return draws


def test_paged_two_tier_round_holds_parity_with_the_reference():
    cdata = _paged_data()
    kw = dict(local_steps=2, batch_size=8)
    topo_kw = dict(kind="two_tier", n_clients=PAGED_N, k_out=2, n_pods=4)
    rm = ref_tiny_mlp(in_dim=16, n_classes=4)
    ref = RefResident(ref_make_program(
        rm.loss, rm.init, cdata, ref_make_algo("dfedsgpsm", **kw),
        RefTopo(**topo_kw), gossip="dense"), k_active=K_ACTIVE, seed=3)
    m = tiny_mlp(in_dim=16, n_classes=4)
    port = ResidentDriver(make_program(
        m.loss, m.init, cdata, make_algo("dfedsgpsm", **kw),
        TopologyConfig(**topo_kw), gossip="dense", device="cpu"),
        k_active=K_ACTIVE, seed=3)
    assert port.c_max == ref.c_max
    s = jax.device_get(ref.state)
    port.state = port.state._replace(
        params=torch.from_numpy(np.array(s.params)),
        mom=torch.from_numpy(np.array(s.mom)),
        w=torch.from_numpy(np.array(s.w)))
    for r in range(3):
        draws = _resident_draws(ref)
        want = ref.run_round()
        got = port.run_round(draws)
        assert abs(got["loss"] - want["loss"]) <= 1e-5, r
        s = jax.device_get(ref.state)
        for k in ("params", "mom", "w"):
            a = np.asarray(getattr(s, k))
            scale = max(float(np.abs(a).max()), 1.0)
            np.testing.assert_allclose(getattr(port.state, k).numpy(), a,
                                       rtol=0, atol=1e-5 * scale,
                                       err_msg=f"{k}, round {r}")
    assert abs(port.total_mass() - PAGED_N) <= 1e-5 * PAGED_N


@pytest.mark.parametrize("seed,t", [(0, 0), (5, 3)])
def test_active_picks_build_equals_the_references(seed, t):
    n, m = 24, 6
    kw = dict(kind="two_tier", n_clients=n, k_out=3, n_pods=4)
    key = jax.random.PRNGKey(seed)
    active = np.asarray(jax.random.permutation(key, n))[:m]
    want = np.asarray(ref_topology.sample_active_picks(
        key, jnp.asarray(active, jnp.int32), RefTopo(**kw), t=t))
    scores = np.asarray(jax.random.uniform(key, (m, n)))
    got = topology.build_active_picks(torch.from_numpy(active),
                                      TopologyConfig(**kw), t=t,
                                      scores=torch.from_numpy(scores))
    np.testing.assert_array_equal(got.numpy(), want)
    assert topology.active_k_in(TopologyConfig(**kw)) == want.shape[1]


def test_the_paged_cli_runs_two_tier(tmp_path):
    """``--paged --topology two_tier`` raised ``TypeError`` before the
    family was ported; ``n_pods = max(n // 8, 2)`` as the reference's."""
    rec = train.main(["--paged", "--topology", "two_tier", "--n-clients", "64",
                      "--k-active", "8", "--rounds", "2", "--store-dir",
                      str(tmp_path / "pop"), "--device", "cpu"])
    tr = rec["trainer"]
    assert tr.topo.kind == "two_tier" and tr.topo.n_pods == 8
    assert tr.runner.round_index == 2
    assert abs(rec["mass"] - 64) < 1e-3
