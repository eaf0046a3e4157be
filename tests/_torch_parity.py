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
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.core import FLTrainer as RefTrainer
from repro.core import TopologyConfig as RefTopo
from repro.core import make_algo as ref_make_algo
from repro.core.topology import NeighborList as RefNeighborList
from repro.data.dirichlet import dirichlet_partition, stack_client_data
from repro.data.synthetic import make_dataset
from repro.models.small import mnist_2nn as ref_mnist_2nn
from repro_torch.core import FLTrainer, TopologyConfig, make_algo
from repro_torch.core.topology import NeighborList
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
        if isinstance(P, RefNeighborList):
            draws["P"] = NeighborList(torch.from_numpy(np.array(P.idx)),
                                      torch.from_numpy(np.array(P.wgt)))
        else:
            draws["P"] = np.array(P)
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
