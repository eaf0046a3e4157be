"""Shared harness of the round-parity tests (``test_torch_round_*.py``): one
reference ``FLTrainer`` (JAX) and one port ``FLTrainer`` (PyTorch, CPU) on
the golden setting, the port started from the reference's own initial
state, and each round fed the reference's own draws.

The draws come from the reference's key chain, recomputed here exactly as
``RoundProgram.step`` and ``SamMomentumSolver`` consume it — nothing in
``repro`` changes for the test:

* ``keys = split(state.key, 2 + n)``; ``tkey = keys[1]`` goes to
  ``program.mixing_matrix`` (central algorithms: ``permutation(tkey, n)[:m]``);
* client i's key ``keys[2 + i]`` is split once per local step, and the
  second half is the ``randint`` key of that step's minibatch.

The scenario compositions also replay

* the link stream, ``split(state.link.key)[0]``: with drops, its split's
  first half is the key of the drop uniforms (one per entry of the dense
  operator or slot of the neighbor list) and the second half the key of
  the delayed mixer's ``randint`` delays, else the delays take it whole;
* the churn stream, ``split(state.churn.key)[1]``, split in three: the
  failure, permanence and recovery uniforms, one per client.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.core import ChurnModel as RefChurn
from repro.core import FLTrainer as RefTrainer
from repro.core import LinkModel as RefLink
from repro.core import TopologyConfig as RefTopo
from repro.core import make_algo as ref_make_algo
from repro.core.topology import NeighborList as RefNeighborList
from repro.core.topology import TwoTierOp as RefTwoTierOp
from repro.data.dirichlet import dirichlet_partition, stack_client_data
from repro.data.synthetic import make_dataset
from repro.models.small import mnist_2nn as ref_mnist_2nn
from repro_torch.core import ChurnModel, LinkModel
from repro_torch.core import FLTrainer, TopologyConfig, make_algo
from repro_torch.core import topology
from repro_torch.core.topology import NeighborList, TwoTierOp
from repro_torch.interop import program_with_delta_base
from repro_torch.interop import state_from_numpy
from repro_torch.models.small import mnist_2nn

N_CLIENTS = 8
K_OUT = 2
ROUNDS = 3
LOCAL_STEPS = 3
BATCH = 32
PARTICIPATION = 0.25


def golden_data():
    train, _ = make_dataset("mnist", 1200, 100, seed=0)
    parts = dirichlet_partition(train["y"], N_CLIENTS, alpha=0.3, seed=0)
    return stack_client_data(train, parts, pad_to=128)


def port_operator(P):
    """A reference mixing operator as the port's: a NeighborList or a
    TwoTierOp of tensors, or a dense numpy array."""
    def nl(x):
        return NeighborList(torch.from_numpy(np.array(x.idx)),
                            torch.from_numpy(np.array(x.wgt)))

    if isinstance(P, RefTwoTierOp):
        return TwoTierOp(torch.from_numpy(np.array(P.intra)), nl(P.inter))
    if isinstance(P, RefNeighborList):
        return nl(P)
    return np.array(P)


def dense_operator(P, n: int) -> np.ndarray:
    """The (n, n) dense matrix of a port operator, as float32 numpy."""
    if isinstance(P, TwoTierOp):
        return topology.dense_from_two_tier(P).numpy()
    if isinstance(P, NeighborList):
        return topology.dense_from_neighbors(P, n).numpy()
    return np.asarray(P, np.float32)


class PreCompression:
    """Probe of :func:`run_scenario_parity`: the port's pre-compression
    bank of each round, from its own local steps on the round's draws,
    ``y = X + residual`` and the round's operator, dense."""

    def __init__(self):
        self.rounds = []

    def __call__(self, port, draws):
        prog, st = port.program, port.state
        X, *_ = prog.solver.update(
            prog.loss_fn, prog.spec, st.params, st.w,
            torch.as_tensor(draws["batch_idx"]).long(), prog.data,
            prog.round_lr(st.round))
        y = X.float() + (st.comp if torch.is_tensor(st.comp) else 0.0)
        self.rounds.append(dict(X=X.float(), y=y,
                                P=dense_operator(draws["P"], prog.n)))


def flip_step(rec, compressor: str, ratio: float = 0.05) -> np.ndarray:
    """What one code flip can move each sender's transmitted coordinate
    by: one int8 quantisation step ``max|x_j| / 127``, or (top-k at
    ``ratio``) the k-th largest magnitude of ``y_j``."""
    if compressor == "int8_rows":
        return (rec["X"].abs().amax(dim=1) / 127.0).numpy()
    k = max(int(ratio * rec["y"].shape[1]), 1)
    return torch.topk(rec["y"].abs(), k, dim=1).values[:, -1].numpy()


def flip_bound(P: np.ndarray, step: np.ndarray) -> np.ndarray:
    """``sum_{j != i} P[i, j] step_j`` per receiver i, as an (n, 1) column:
    the self-loop rides at full precision, so a receiver's own flips do
    not count."""
    off = P * (1.0 - np.eye(P.shape[0], dtype=np.float32))
    return (off @ step)[:, None]


def swap_bound(P: np.ndarray, step: np.ndarray, ref_comp: np.ndarray,
               port_comp: np.ndarray) -> np.ndarray:
    """:func:`flip_bound` per coordinate, over the top-k coordinates that
    were actually swapped: sender j's coordinate c counts where exactly one
    package kept it (its EF residual is 0 there, and nonzero where it was
    dropped).  Where no sender swapped a coordinate the bound is 0, so the
    self-loop's own share is held to the draw-exact tolerance."""
    off = P * (1.0 - np.eye(P.shape[0], dtype=np.float32))
    swapped = (ref_comp == 0) != (port_comp == 0)
    return off @ (step[:, None] * swapped)


def reference_draws(tr: RefTrainer, m_rows: int) -> dict:
    """This round's draws of the reference trainer ``tr``, as numpy."""
    prog, state = tr.program, tr.state
    n = prog.n
    keys = jax.random.split(state.key, 2 + n)
    tkey, ckeys = keys[1], keys[2:]
    draws = {}
    if prog.mixer.kind == "central":
        m = max(int(prog.participation * n), 1)
        draws["sel"] = np.array(jax.random.permutation(tkey, n)[:m])
        ckeys = ckeys[:m]
    else:
        P = prog.mixing_matrix(tkey, state)
        draws["P"] = port_operator(P)
        if not _empty(state.link):
            shape = np.shape(P.idx if isinstance(P, RefNeighborList) else P)
            lkey = jax.random.split(state.link.key)[0]
            if prog.link is not None and prog.link.drop > 0:
                dkey, lkey = jax.random.split(lkey)
                draws["drop"] = np.array(jax.random.uniform(dkey, shape))
            if hasattr(prog.mixer, "delay"):
                draws["delay"] = np.array(jax.random.randint(
                    lkey, shape, 0, prog.mixer.delay + 1))
        if prog.churned:
            ckey = jax.random.split(state.churn.key)[1]
            draws["churn"] = np.stack([
                np.array(jax.random.uniform(k, (n,)))
                for k in jax.random.split(ckey, 3)])
    solver = prog.solver
    rows = []
    for key_i in ckeys:
        per_step = []
        for _ in range(solver.local_steps):
            key_i, bk = jax.random.split(key_i)
            per_step.append(np.asarray(
                jax.random.randint(bk, (solver.batch_size,), 0, m_rows)))
        rows.append(per_step)
    draws["batch_idx"] = np.asarray(rows).transpose(1, 0, 2)  # (K, rows, B)
    return draws


def state_dump(tr: RefTrainer) -> dict:
    s = jax.device_get(tr.state)
    return {"params": np.array(s.params),
            "mom": None if s.mom is None else np.array(s.mom),
            "w": np.array(s.w), "round": np.array(s.round),
            "losses": np.array(s.losses)}


def run_parity(name: str, gossip: str, cdata):
    """Run ROUNDS rounds of ``name`` in both packages on the same draws.

    Yields ``(round, ref_metrics, port_metrics, ref_state, port_state)``
    after each round, all as numpy."""
    algo_kw = dict(local_steps=LOCAL_STEPS, batch_size=BATCH)
    ref_model = ref_mnist_2nn()
    ref = RefTrainer(
        ref_model.loss, ref_model.init,
        {k: jnp.asarray(v) for k, v in cdata.items()},
        ref_make_algo(name, **algo_kw),
        RefTopo(kind="kout", n_clients=N_CLIENTS, k_out=K_OUT), seed=0,
        participation=PARTICIPATION, gossip=gossip,
    )
    model = mnist_2nn()
    port = FLTrainer(
        model.loss, model.init, cdata, make_algo(name, **algo_kw),
        TopologyConfig(kind="kout", n_clients=N_CLIENTS, k_out=K_OUT),
        seed=0, participation=PARTICIPATION, gossip=gossip, device="cpu",
    )
    port.state = state_from_numpy(state_dump(ref), port.state.key)
    m_rows = cdata["x"].shape[1]
    for r in range(ROUNDS):
        draws = reference_draws(ref, m_rows)
        ref_metrics = {k: float(v) for k, v in ref.run_round().items()}
        port_metrics = {k: float(v) for k, v in port.run_round(draws).items()}
        ref_state = state_dump(ref)
        port_state = {"params": port.state.params.numpy(),
                      "w": port.state.w.numpy()}
        yield r, ref_metrics, port_metrics, ref_state, port_state


def _empty(x) -> bool:
    """``()``: a carry the program does not hold (a ``LinkState`` is a
    tuple too, but never empty)."""
    return isinstance(x, tuple) and len(x) == 0


def scenario_state_dump(tr: RefTrainer) -> dict:
    """:func:`state_dump` plus the EF residual and the link and churn
    carries, as numpy (None where the program carries none)."""
    dump = state_dump(tr)
    s = jax.device_get(tr.state)

    def arr(x):
        return None if isinstance(x, tuple) else np.array(x)

    dump["comp"] = arr(s.comp)
    if not _empty(s.link):
        dump["link"] = {k: arr(getattr(s.link, k))
                        for k in ("bufx", "bufw", "last")}
    if not _empty(s.churn):
        dump["churn"] = {"live": np.array(s.churn.live), "tpl": arr(s.churn.tpl)}
    return dump


def port_state_dump(st) -> dict:
    """The same fields of a port ``FLState``, as float32 numpy (int8 for
    the liveness vector)."""
    def arr(x):
        return None if isinstance(x, tuple) or x is None else (
            x.float().numpy() if x.is_floating_point() else x.numpy())

    dump = {"params": arr(st.params), "mom": arr(st.mom), "w": arr(st.w),
            "losses": arr(st.losses), "comp": arr(st.comp)}
    if not _empty(st.link):
        dump["link"] = {k: arr(getattr(st.link, k))
                        for k in ("bufx", "bufw", "last")}
    if not _empty(st.churn):
        dump["churn"] = {"live": arr(st.churn.live), "tpl": arr(st.churn.tpl)}
    return dump


def run_scenario_parity(name: str, gossip: str, cdata, *, algo_kw=None,
                        link=None, churn=None, delta=None, bf16=False,
                        resync=False, rounds=ROUNDS, probe=None, topo=None):
    """:func:`run_parity` for the scenario compositions: ``algo_kw``
    overrides the algorithm (compressor, solver, ...), ``link`` / ``churn``
    are the fields of a ``LinkModel`` / ``ChurnModel`` (built in each
    package), ``topo`` the fields of the ``TopologyConfig`` (kout,
    ``N_CLIENTS``, ``K_OUT`` by default), ``delta`` the delta bank's rank,
    ``bf16`` a bfloat16 bank;
    the port trains over the reference's delta base.  ``resync`` restarts
    the port from the reference's state before every round, so each round's
    comparison holds one round's divergence (for lossy compressors, whose
    code flips would otherwise feed the next round).  ``probe(port, draws)``
    runs before each round of the port, on its state and that round's
    draws.

    Yields ``(round, ref_metrics, port_metrics, ref_state, port_state)``
    after each round, the states as :func:`scenario_state_dump` /
    :func:`port_state_dump`."""
    algo_kw = dict(local_steps=LOCAL_STEPS, batch_size=BATCH, **(algo_kw or {}))
    topo = topo or dict(kind="kout", n_clients=N_CLIENTS, k_out=K_OUT)
    ref_model = ref_mnist_2nn()
    ref = RefTrainer(
        ref_model.loss, ref_model.init,
        {k: jnp.asarray(v) for k, v in cdata.items()},
        ref_make_algo(name, **algo_kw),
        RefTopo(**topo), seed=0,
        participation=PARTICIPATION, gossip=gossip,
        link=None if link is None else RefLink(**link),
        churn=None if churn is None else RefChurn(**churn),
        delta=delta, bank_dtype=jnp.bfloat16 if bf16 else None,
    )
    model = mnist_2nn()
    port = FLTrainer(
        model.loss, model.init, cdata, make_algo(name, **algo_kw),
        TopologyConfig(**topo),
        seed=0, participation=PARTICIPATION, gossip=gossip,
        link=None if link is None else LinkModel(**link),
        churn=None if churn is None else ChurnModel(**churn),
        delta=delta, bank_dtype=torch.bfloat16 if bf16 else None,
        device="cpu",
    )
    if delta is not None:
        port.program = program_with_delta_base(
            port.program, jax.device_get(ref.program.spec.base))
        port.spec = port.program.spec
    st = port.state
    keys = dict(link_key=None if _empty(st.link) else st.link.key,
                churn_key=None if _empty(st.churn) else st.churn.key)
    port.state = state_from_numpy(scenario_state_dump(ref), st.key, **keys)
    m_rows = cdata["x"].shape[1]
    for r in range(rounds):
        draws = reference_draws(ref, m_rows)
        if resync and r:
            port.state = state_from_numpy(scenario_state_dump(ref),
                                          port.state.key, **keys)
        if probe is not None:
            probe(port, draws)
        ref_metrics = {k: float(v) for k, v in ref.run_round().items()}
        port_metrics = {k: float(v) for k, v in port.run_round(draws).items()}
        yield (r, ref_metrics, port_metrics, scenario_state_dump(ref),
               port_state_dump(port.state))
