"""The port's paged round (``repro_torch.store.PagedRunner``,
``RoundProgram.step_active``, ``topology.sample_active_picks``) against the
JAX reference's, and against the port's fully-resident twin, on the CPU.

The reference's draws are recomputed from its key chain exactly as its
runner consumes them: ``plan_keys(key)`` splits the round key into
``(key_next, akey, tkey, ckey_base)``; the active set is
``permutation(akey, n)[:k_active]``; the ``kout`` picks come from
``uniform(tkey, (k_active, n))``; client ``g``'s minibatches from
``fold_in(ckey_base, g)``, split once per local step as in
``SamMomentumSolver``.  The port's runner opens a copy of the reference's
store (the same rows) and takes those draws through ``run_round(draws)``.

Tolerances: a round on the same draws is held to the draw-exact 1e-5 of
the round-parity tests (relative to the bank's magnitude); paged against
resident within the port to the reference's own ``test_store.py`` bounds
(5e-5 on params, 1e-5 on w and the loss: the compact gather and the dense
mix sum in different orders); store-wide mass to 1e-5 of n.
"""
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import FLTrainer as RefTrainer
from repro.core import LinkModel as RefLink
from repro.core import TopologyConfig as RefTopo
from repro.core import make_algo as ref_make_algo
from repro.core import make_program as ref_make_program
from repro.core import topology as ref_topology
from repro.core.program import plan_keys as ref_plan_keys
from repro.data.dirichlet import dirichlet_partition, stack_client_data
from repro.data.synthetic import DatasetSpec, make_dataset
from repro.models.small import tiny_mlp as ref_tiny_mlp
from repro.store import PagedRunner as RefRunner
from repro_torch.core import FLTrainer, LinkModel, TopologyConfig
from repro_torch.core import make_algo, make_program, topology
from repro_torch.models.small import tiny_mlp
from repro_torch.store import ClientStore, PagedRunner, ResidentDriver
from _torch_threads import one_thread  # noqa: F401,E402  (an autouse fixture)

N = 16
K_ACTIVE = 4
TOL = 1e-5
_DATA: dict = {}


def _client_data(n=N):
    if n not in _DATA:
        spec = DatasetSpec("toy", (16,), 4, margin=3.0)
        train, _ = make_dataset(spec, n * 16, 64, seed=0)
        parts = dirichlet_partition(train["y"], n, alpha=10.0, seed=0)
        _DATA[n] = stack_client_data(train, parts, pad_to=32)
    return _DATA[n]


def _kw(kind):
    k_out = 1 if kind in ("ring", "exponential") else 2
    return dict(kind=kind, k_out=k_out, time_varying=kind == "exponential")


def _algo(compressor=None, name="dfedsgpsm"):
    kw = dict(local_steps=2, batch_size=8)
    if compressor:
        kw["compressor"] = compressor
    return kw, name


def _program(n=N, kind="kout", compressor=None, name="dfedsgpsm",
             link=None):
    kw, name = _algo(compressor, name)
    m = tiny_mlp(in_dim=16, n_classes=4)
    return make_program(m.loss, m.init, _client_data(n), make_algo(name, **kw),
                        TopologyConfig(n_clients=n, **_kw(kind)),
                        gossip="dense", link=link, device="cpu")


def _ref_program(n=N, kind="kout", compressor=None, name="dfedsgpsm",
                 link=None):
    kw, name = _algo(compressor, name)
    m = ref_tiny_mlp(in_dim=16, n_classes=4)
    return ref_make_program(m.loss, m.init, _client_data(n),
                            ref_make_algo(name, **kw),
                            RefTopo(n_clients=n, **_kw(kind)),
                            gossip="dense", link=link)


def ref_round_draws(runner) -> dict:
    """The draws of the reference runner's next round (no churn)."""
    prog = runner.program
    _, akey, tkey, ckey_base = ref_plan_keys(runner._key)
    n = prog.n
    perm = np.asarray(jax.random.permutation(akey, n))
    active = perm[:runner.k_active]
    draws = {"perm": perm}
    if prog.topo.kind == "kout":
        draws["scores"] = np.asarray(
            jax.random.uniform(tkey, (runner.k_active, n)))
    m = np.asarray(prog.data["x"]).shape[1]
    solver = prog.solver
    rows = []
    for g in active:
        key = jax.random.fold_in(ckey_base, int(g))
        steps = []
        for _ in range(solver.local_steps):
            key, bk = jax.random.split(key)
            steps.append(np.asarray(
                jax.random.randint(bk, (solver.batch_size,), 0, m)))
        rows.append(steps)
    draws["batch_idx"] = np.asarray(rows).transpose(1, 0, 2)
    return draws


# -- the picks' build -----------------------------------------------------------

@pytest.mark.parametrize("kind", ["ring", "exponential", "kout"])
@pytest.mark.parametrize("seed,t", [(0, 0), (5, 3)])
def test_active_picks_build_equals_the_references(kind, seed, t):
    n, m = 24, 6
    ref_cfg = RefTopo(n_clients=n, **_kw(kind))
    cfg = TopologyConfig(n_clients=n, **_kw(kind))
    key = jax.random.PRNGKey(seed)
    active = np.asarray(jax.random.permutation(key, n))[:m]
    want = np.asarray(ref_topology.sample_active_picks(
        key, jnp.asarray(active, jnp.int32), ref_cfg, t=t))
    scores = np.asarray(jax.random.uniform(key, (m, n)))
    got = topology.build_active_picks(torch.from_numpy(active), cfg, t=t,
                                      scores=torch.from_numpy(scores))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert topology.active_k_in(cfg) == ref_topology.active_k_in(ref_cfg)
    drawn = topology.sample_active_picks(torch.Generator().manual_seed(seed),
                                         torch.from_numpy(active), cfg, t=t)
    assert drawn.shape == want.shape
    assert not np.any(drawn.numpy() == active[:, None])


def test_active_picks_refuse_families_without_a_paged_form():
    with pytest.raises(ValueError, match="no active-set"):
        topology.active_k_in(TopologyConfig(kind="symmetric", n_clients=8,
                                            k_out=2))


# -- the port's paged round against the reference's ----------------------------

@pytest.mark.parametrize("kind", ["ring", "exponential", "kout"])
def test_paged_round_equals_the_references_on_its_draws(kind, tmp_path):
    ref = RefRunner(_ref_program(kind=kind), str(tmp_path / "ref"),
                    k_active=K_ACTIVE, seed=3, rows_per_chunk=4)
    shutil.copytree(ref.store.path, str(tmp_path / "port"))
    port = PagedRunner(_program(kind=kind), str(tmp_path / "port"),
                       k_active=K_ACTIVE, seed=3, rows_per_chunk=4)
    assert port.round_index == ref.round_index == 0
    for _ in range(3):
        draws = ref_round_draws(ref)
        want = ref.run_round()
        got = port.run_round(draws)
        assert abs(got["loss"] - want["loss"]) <= TOL
        assert got["rows_resident"] == want["rows_resident"]
        a = ref.read_rows(np.arange(N))
        b = port.read_rows(np.arange(N))
        for k in ("params", "mom", "w", "losses"):
            scale = max(float(np.abs(a[k]).max()), 1.0)
            assert float(np.abs(b[k] - a[k]).max()) <= TOL * scale, k
    assert abs(port.total_mass() - N) <= 1e-5 * N
    ref.close()
    port.close()


@pytest.mark.parametrize("opener", ["port", "reference"])
def test_a_paged_store_opens_in_the_other_package(tmp_path, opener):
    """Rows and the round index cross; the schedule is the opener's own."""
    path = str(tmp_path / "s")
    if opener == "port":
        w = RefRunner(_ref_program(), path, k_active=K_ACTIVE, seed=3,
                      rows_per_chunk=4)
    else:
        w = PagedRunner(_program(), path, k_active=K_ACTIVE, seed=3,
                        rows_per_chunk=4)
    w.run_round()
    w.run_round()
    w.save()
    rows = w.read_rows(np.arange(N))
    w.close()
    if opener == "port":
        o = PagedRunner(_program(), path, k_active=K_ACTIVE, seed=9)
    else:
        o = RefRunner(_ref_program(), path, k_active=K_ACTIVE, seed=9)
    assert o.round_index == 2
    got = o.read_rows(np.arange(N))
    for k in rows:
        np.testing.assert_array_equal(got[k], rows[k])
    rec = o.run_round()
    assert np.isfinite(rec["loss"])
    assert abs(o.total_mass() - N) <= 1e-5 * N
    o.close()


# -- paged against resident, within the port ------------------------------------

@pytest.mark.parametrize("kind,compressor", [
    ("ring", None), ("exponential", None), ("kout", None),
    ("kout", "int8_rows"), ("kout", "topk_ef")])
def test_paged_matches_resident(kind, compressor, tmp_path):
    program = _program(kind=kind, compressor=compressor)
    runner = PagedRunner(program, str(tmp_path / "s"), k_active=K_ACTIVE,
                         seed=3, rows_per_chunk=4)
    twin = ResidentDriver(program, k_active=K_ACTIVE, seed=3)
    for _ in range(3):
        mp, mt = runner.run_round(), twin.run_round()
        assert abs(mp["loss"] - mt["loss"]) < 1e-5
        assert mp["w_mass_closure_err"] < 1e-4
    rows = runner.read_rows(np.arange(N))
    np.testing.assert_allclose(rows["params"], twin.state.params.numpy(),
                               atol=5e-5)
    np.testing.assert_allclose(rows["w"], twin.state.w.numpy(), atol=1e-5)
    if compressor == "topk_ef":
        assert "ef" in rows and np.abs(rows["ef"]).max() > 0
    assert abs(runner.total_mass() - N) <= 1e-5 * N
    assert abs(twin.total_mass() - N) <= 1e-5 * N
    runner.close()


def test_mass_is_conserved_with_a_cold_population(tmp_path):
    n = 64
    runner = PagedRunner(_program(n=n), str(tmp_path / "s"),
                         k_active=K_ACTIVE, seed=0, rows_per_chunk=8)
    for _ in range(5):
        assert runner.run_round()["w_mass_closure_err"] < 1e-4
    assert abs(runner.total_mass() - n) <= 1e-5 * n
    runner.close()


def test_buffers_scale_with_the_closure_not_n(tmp_path):
    n, k_out = 64, 2
    program = _program(n=n)
    runner = PagedRunner(program, str(tmp_path / "s"), k_active=K_ACTIVE,
                         seed=0, rows_per_chunk=8)
    c_max = K_ACTIVE * (k_out + 1)
    assert runner.resident_rows == c_max < n
    assert runner.staging_rows == 2 * c_max
    for buf in runner._staging:
        assert buf["params"].shape == (c_max, program.spec.dim)
        assert buf["w"].shape == (c_max,)
    runner.run_round()
    rec = runner.run_round()
    assert rec["rows_resident"] <= c_max
    stats = runner.stats.as_dict()
    assert stats["rows_needed_per_round"] <= c_max
    assert 0.0 <= stats["prefetch_hit_rate"] <= 1.0
    assert stats["rows_faulted_per_round"] < stats["rows_needed_per_round"]
    runner.close()


def test_resume_is_bit_identical(tmp_path):
    program = _program()
    runner = PagedRunner(program, str(tmp_path / "s"), k_active=K_ACTIVE,
                         seed=3, rows_per_chunk=4)
    for _ in range(2):
        runner.run_round()
    runner.save()
    shutil.copytree(str(tmp_path / "s"), str(tmp_path / "snap"))
    a = [runner.run_round() for _ in range(2)]
    rows_a = runner.read_rows(np.arange(N))
    runner.close()
    resumed = PagedRunner(program, str(tmp_path / "snap"), k_active=K_ACTIVE,
                          seed=999, rows_per_chunk=4)
    assert resumed.round_index == 2
    b = [resumed.run_round() for _ in range(2)]
    rows_b = resumed.read_rows(np.arange(N))
    resumed.close()
    assert a == b
    for k in rows_a:
        np.testing.assert_array_equal(rows_a[k], rows_b[k])
    runner2 = PagedRunner(program, str(tmp_path / "snap"), k_active=K_ACTIVE)
    committed = runner2.read_rows(np.arange(N))
    runner2.run_round()
    runner2.restore()  # back to the last commit
    assert runner2.round_index == 2
    for k, v in runner2.read_rows(np.arange(N)).items():
        np.testing.assert_array_equal(v, committed[k])
    with pytest.raises(ValueError, match="own store"):
        runner2.restore(str(tmp_path / "s"))
    runner2.close()


def test_churned_paged_run_keeps_mass_and_resumes(tmp_path):
    from repro_torch.core import ChurnModel

    churn = ChurnModel(fail_prob=0.2, recover_prob=0.5, resurrect="cold")
    program = _program(n=32)
    runner = PagedRunner(program, str(tmp_path / "s"), k_active=K_ACTIVE,
                         seed=1, rows_per_chunk=8, churn=churn)
    twin = ResidentDriver(program, k_active=K_ACTIVE, seed=1, churn=churn)
    for _ in range(3):
        mp, mt = runner.run_round(), twin.run_round()
        assert abs(mp["loss"] - mt["loss"]) < 1e-5
        assert mp["live_frac"] == mt["live_frac"]
    assert abs(runner.total_mass() - 32) <= 1e-5 * 32
    runner.save()
    with pytest.raises(ValueError, match="churn"):
        PagedRunner(program, str(tmp_path / "s"), k_active=K_ACTIVE)
    runner.close()


# -- FLTrainer(paged=True) --------------------------------------------------------

def _trainer_args(pkg):
    kw, name = _algo()
    if pkg == "ref":
        m = ref_tiny_mlp(in_dim=16, n_classes=4)
        return (RefTrainer, (m.loss, m.init, _client_data(),
                             ref_make_algo(name, **kw),
                             RefTopo(kind="kout", n_clients=N, k_out=2)),
                {}, RefLink)
    m = tiny_mlp(in_dim=16, n_classes=4)
    return (FLTrainer, (m.loss, m.init, _client_data(), make_algo(name, **kw),
                        TopologyConfig(kind="kout", n_clients=N, k_out=2)),
            {"device": "cpu"}, LinkModel)


def test_trainer_paged_end_to_end(tmp_path):
    cls, args, kw, _ = _trainer_args("port")
    tr = cls(*args, seed=0, paged=True, store_dir=str(tmp_path / "s"),
             k_active=K_ACTIVE, **kw)
    hist = tr.fit(3, eval_every=3)
    assert len(hist) == 3 and all(np.isfinite(r["loss"]) for r in hist)
    assert abs(hist[-1]["pop_mass"] - N) <= 1e-5 * N
    assert tr.average_model()["fc1"]["w"].shape == (16, 32)
    assert np.isfinite(tr.consensus_error())
    with pytest.raises(ValueError, match="n, D"):
        tr.debiased_models()
    path = tr.save()
    assert ClientStore.exists(path)
    tr.restore(path)
    assert np.isfinite(tr.run_round()["loss"])
    tr.runner.close()


_VALIDATIONS = {
    "store_dir": dict(paged=True, k_active=K_ACTIVE),
    "k_active": dict(paged=True, store_dir="s"),
    "flat": dict(paged=True, flat=False, store_dir="s", k_active=K_ACTIVE),
    "link": dict(paged=True, store_dir="s", k_active=K_ACTIVE,
                 link=dict(drop=0.2)),
    "push-sum": dict(paged=True, store_dir="s", k_active=K_ACTIVE,
                     algo="dfedsam"),
}


@pytest.mark.parametrize("match", list(_VALIDATIONS))
def test_trainer_paged_validations_raise_as_the_references(tmp_path, match):
    for pkg in ("ref", "port"):
        cls, args, kw, Link = _trainer_args(pkg)
        opts = dict(_VALIDATIONS[match])
        if "store_dir" in opts:
            opts["store_dir"] = str(tmp_path / pkg / opts["store_dir"])
        if "link" in opts:
            opts["link"] = Link(**opts["link"])
        if "algo" in opts:
            algo = (ref_make_algo if pkg == "ref" else make_algo)(
                opts.pop("algo"), **_algo()[0])
            args = args[:3] + (algo,) + args[4:]
        with pytest.raises(ValueError, match=match):
            cls(*args, **opts, **kw)
