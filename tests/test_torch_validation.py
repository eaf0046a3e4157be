"""Every refusal of the reference's scenario configuration that needs no
device mesh refuses in the port too: ``LinkModel``, ``ChurnModel``, the
mixers, ``make_program`` and ``FLTrainer``.  Each case builds the same
configuration in both packages and both must raise ``ValueError``; where
the reference's message names the conflict, the port's must match it.
``mesh=``, ``paged=`` and ``faults=`` are ported and refuse what the
reference's refuse."""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as R
from repro.core import stages as ref_stages
from repro.core import topology as ref_topo
from repro.data.dirichlet import dirichlet_partition, stack_client_data
from repro.data.synthetic import make_dataset
from repro.models.small import tiny_mlp as ref_tiny
import repro_torch.core as T
from repro_torch.core import stages, topology
from repro_torch.models.small import tiny_mlp
from _torch_threads import one_thread  # noqa: F401,E402  (an autouse fixture)

N = 8


@functools.cache
def _cdata():
    train, _ = make_dataset("mnist", 200, 10, seed=0)
    parts = dirichlet_partition(train["y"], N, alpha=0.5, seed=0)
    return stack_client_data(train, parts, pad_to=32)


def _program(pkg, name, algo_kw=None, gossip="dense", link=None, churn=None,
             delta=None, topo_kind="kout"):
    algo = pkg.make_algo(name, local_steps=1, **(algo_kw or {}))
    topo = pkg.TopologyConfig(kind=topo_kind, n_clients=N, k_out=2)
    lk = None if link is None else pkg.LinkModel(**link)
    ch = None if churn is None else pkg.ChurnModel(**churn)
    if pkg is R:
        m = ref_tiny()
        data = {k: jnp.asarray(v) for k, v in _cdata().items()}
        return R.make_program(m.loss, m.init, data, algo, topo, gossip=gossip,
                              link=lk, churn=ch, delta=delta)
    m = tiny_mlp()
    return T.make_program(m.loss, m.init, _cdata(), algo, topo, gossip=gossip,
                          link=lk, churn=ch, delta=delta, device="cpu")


def _trainer(pkg, name="dfedsgpsm", algo_kw=None, **kw):
    algo = pkg.make_algo(name, local_steps=1, **(algo_kw or {}))
    topo = pkg.TopologyConfig(kind="kout", n_clients=N, k_out=2)
    for k in ("link", "churn"):
        if isinstance(kw.get(k), dict):
            cls = pkg.LinkModel if k == "link" else pkg.ChurnModel
            kw[k] = cls(**kw[k])
    if kw.get("bank_dtype") == "bf16":
        kw["bank_dtype"] = jnp.bfloat16 if pkg is R else torch.bfloat16
    if pkg is R:
        m = ref_tiny()
        data = {k: jnp.asarray(v) for k, v in _cdata().items()}
        return R.FLTrainer(m.loss, m.init, data, algo, topo, **kw)
    m = tiny_mlp()
    return T.FLTrainer(m.loss, m.init, _cdata(), algo, topo, device="cpu",
                       **kw)


# (id, callable taking the package, message the two raise)
CASES = [
    # LinkModel
    ("link-drop-above-1", lambda p: p.LinkModel(drop=1.5),
     "drop must be a probability"),
    ("link-drop-negative", lambda p: p.LinkModel(drop=-0.1),
     "drop must be a probability"),
    ("link-delay-negative", lambda p: p.LinkModel(delay=-1), "delay bound"),
    ("link-threshold-negative", lambda p: p.LinkModel(event_threshold=-1.0),
     "event_threshold must be"),
    ("link-decay-zero", lambda p: p.LinkModel(event_threshold=0.1,
                                              event_decay=0.0),
     "event_decay must be"),
    ("link-decay-above-1", lambda p: p.LinkModel(event_threshold=0.1,
                                                 event_decay=1.5),
     "event_decay must be"),
    ("link-schedule-not-callable",
     lambda p: p.LinkModel(event_threshold=0.1, event_schedule=0.5),
     "event_schedule must be callable"),
    ("link-decay-without-threshold", lambda p: p.LinkModel(event_decay=0.9),
     "set event_threshold"),
    ("link-delay-and-event", lambda p: p.LinkModel(delay=2,
                                                   event_threshold=0.1),
     "do not compose"),
    ("link-drop-and-event", lambda p: p.LinkModel(drop=0.2,
                                                  event_threshold=0.1),
     "do not compose"),
    ("link-drop-symmetric-lists", lambda p: p.LinkModel(drop=0.5).drop_links(
        *(((jnp.zeros((N, 5)), ref_topo.NeighborList(
            jnp.zeros((N, 5), jnp.int32), jnp.ones((N, 5)))) if p is R else
          (torch.zeros(N, 5), topology.NeighborList(
              torch.zeros(N, 5, dtype=torch.int32), torch.ones(N, 5))))),
        symmetric=True), "symmetric neighbor-list"),
    # ChurnModel
    ("churn-fail-negative", lambda p: p.ChurnModel(fail_prob=-0.1),
     "fail_prob must be"),
    ("churn-fail-above-1", lambda p: p.ChurnModel(fail_prob=1.5),
     "fail_prob must be"),
    ("churn-recover-above-1", lambda p: p.ChurnModel(fail_prob=0.1,
                                                     recover_prob=2.0),
     "recover_prob must be"),
    ("churn-permanent-negative", lambda p: p.ChurnModel(fail_prob=0.1,
                                                        permanent_frac=-1.0),
     "permanent_frac must be"),
    ("churn-resurrect-unknown", lambda p: p.ChurnModel(fail_prob=0.1,
                                                       resurrect="hot"),
     "resurrect must be"),
    ("churn-recover-without-fail", lambda p: p.ChurnModel(recover_prob=0.5),
     "set fail_prob"),
    ("churn-mask-symmetric-lists",
     lambda p: p.ChurnModel(fail_prob=0.1).mask_operator(
         *((ref_topo.NeighborList(jnp.zeros((N, 5), jnp.int32),
                                  jnp.ones((N, 5))), jnp.ones(N, bool))
           if p is R else (topology.NeighborList(
               torch.zeros(N, 5, dtype=torch.int32), torch.ones(N, 5)),
               torch.ones(N, dtype=torch.bool))), symmetric=True),
     "symmetric neighbor-list"),
    # Mixers
    ("delayed-mixer-delay-0", lambda p: (
        ref_stages if p is R else stages).DelayedPushSumMixer(delay=0),
     "delay >= 1"),
    ("event-threshold-needs-round", lambda p: (
        ref_stages if p is R else stages).EventTriggeredMixer(
            threshold=0.1, decay=0.5)._threshold_at(None),
     "needs the round"),
    # make_program
    ("program-unknown-compressor",
     lambda p: _program(p, "sgp", dict(compressor="zip")), "unknown stage"),
    ("program-links-on-central",
     lambda p: _program(p, "fedavg", link=dict(drop=0.2)),
     "no peer links"),
    ("program-delay-on-symmetric",
     lambda p: _program(p, "dfedavg", link=dict(delay=1)),
     "push-sum \\(directed\\) only"),
    ("program-event-on-symmetric",
     lambda p: _program(p, "dfedavg", link=dict(event_threshold=0.1)),
     "push-sum \\(directed\\) only"),
    ("program-churn-on-central",
     lambda p: _program(p, "fedavg", churn=dict(fail_prob=0.1)),
     "no peer population"),
    ("program-churn-with-event",
     lambda p: _program(p, "sgp", link=dict(event_threshold=0.1),
                        churn=dict(fail_prob=0.1)), "do not compose"),
    ("program-compressed-central",
     lambda p: _program(p, "fedavg", dict(compressor="int8_rows")),
     "do not model compressed"),
    ("program-quantize-gossip-central",
     lambda p: _program(p, "fedavg", dict(quantize_gossip=True)),
     "do not model compressed"),
    ("program-gossip-unknown",
     lambda p: _program(p, "sgp", gossip="bogus"), "gossip must be"),
    ("program-full-graph-sparse",
     lambda p: _program(p, "sgp", gossip="sparse", topo_kind="full"),
     "no sparse neighbor-list form"),
    ("program-drops-symmetric-sparse",
     lambda p: _program(p, "dfedavg", gossip="sparse", link=dict(drop=0.2)),
     "symmetric neighbor-list"),
    ("program-churn-symmetric-sparse",
     lambda p: _program(p, "dfedavg", gossip="sparse",
                        churn=dict(fail_prob=0.1)), "symmetric neighbor-list"),
    ("program-delta-central", lambda p: _program(p, "fedavg", delta=8),
     "no per-client deltas"),
    ("program-delta-selects-nothing",
     lambda p: _program(p, "sgp", delta=(R if p is R else T).DeltaConfig(
         rank=8, adapt="no-such-leaf")), "selected no leaves"),
    # FLTrainer
    ("trainer-oracle-delta",
     lambda p: _trainer(p, flat=False, delta=8), "delta=/bank_dtype="),
    ("trainer-oracle-bank-dtype",
     lambda p: _trainer(p, flat=False, bank_dtype="bf16"),
     "delta=/bank_dtype="),
    ("trainer-oracle-links",
     lambda p: _trainer(p, flat=False, link=dict(drop=0.1)),
     "perfect links only"),
    ("trainer-oracle-churn",
     lambda p: _trainer(p, flat=False, churn=dict(fail_prob=0.1)),
     "immortal population"),
    ("trainer-oracle-proximal",
     lambda p: _trainer(p, algo_kw=dict(solver="proximal"), flat=False),
     "only supports"),
    ("trainer-oracle-topk",
     lambda p: _trainer(p, algo_kw=dict(compressor="topk_ef"), flat=False),
     "only supports"),
    ("trainer-faults-without-paging",
     lambda p: _trainer(p, faults=object()), "faults="),
    ("trainer-paged-without-store", lambda p: _trainer(p, paged=True),
     "paged"),
]


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_both_packages_refuse(case):
    _, build, message = case
    with pytest.raises(ValueError, match=message if not case[0].startswith(
            "trainer-paged") else None):
        build(R)
    with pytest.raises(ValueError, match=message):
        build(T)


def test_unported_trainer_options_name_their_roadmap_item():
    """``mesh=`` (queue 1 item 12), ``paged=`` and ``faults=`` (item 11)
    are ported and refuse what the reference's refuse, with its
    messages: a mesh without the clients axis, one whose size does not
    divide n, and a mesh beside ``paged=``."""

    class Mesh:
        def __init__(self, **axes):
            self.axis_names, self.shape = tuple(axes), dict(axes)

    for pkg in (R, T):
        with pytest.raises(ValueError, match="no 'clients' axis"):
            _trainer(pkg, mesh=Mesh(data=2))
        with pytest.raises(ValueError, match="must be divisible"):
            _trainer(pkg, mesh=Mesh(clients=3))
        with pytest.raises(ValueError, match="paged training is single-host"):
            _trainer(pkg, mesh=Mesh(clients=2), paged=True, store_dir="x",
                     k_active=2)
    for pkg in (R, T):
        with pytest.raises(ValueError, match="paged=True needs store_dir"):
            _trainer(pkg, paged=True)
        with pytest.raises(ValueError, match="it needs paged=True"):
            _trainer(pkg, faults=object())


def test_zero_models_are_inactive():
    assert not topology.LinkModel().active and not topology.ChurnModel().active
    assert topology.LinkModel(drop=1.0).active
    prog = _program(T, "sgp", link=dict(), churn=dict())
    assert prog.link is None and not prog.linked and not prog.churned
    assert np.isclose(topology.LinkModel(drop=1.0).drop_links(
        torch.zeros(N, N), topology.sample_kout(torch.Generator(), N, 2)),
        torch.eye(N).numpy()).all()
