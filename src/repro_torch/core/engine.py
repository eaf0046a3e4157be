"""Algorithm registry and the stateful trainer — the port of
``repro.core.engine``.

``AlgoConfig`` is one point in the stage-composition space; ``ALGORITHMS``
holds Algorithm 1 (DFedSGPSM), the seven paper baselines and the DFedSGPM
ablation.  :class:`FLTrainer` is a thin stateful wrapper over the round
program on the flat bank; ``flat=False`` selects the per-leaf parameter-dict
path, kept as the kernel-free equivalence oracle.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch
from torch.func import vmap

from repro_torch.core import pushsum, topology
from repro_torch.core.flat import BoundDeltaSpec, tree_map
from repro_torch.core.program import (
    FLState,
    RoundProgram,
    _as_device,
    _is_empty,
    make_program,
)
from repro_torch.core.sam import apply_update, momentum_update, sam_gradient
from repro_torch.core.stages import _sample_batch, _self_weights

__all__ = [
    "AlgoConfig",
    "ALGORITHMS",
    "FLState",
    "FLTrainer",
    "RoundProgram",
    "make_algo",
    "make_program",
]


@dataclasses.dataclass(frozen=True)
class AlgoConfig:
    """One federated-optimization algorithm = one stage composition."""

    name: str = "dfedsgpsm"
    comm: str = "directed"  # mixer: directed | symmetric | central
    local_steps: int = 5
    rho: float = 0.0  # SAM perturbation radius (0 = off)
    alpha: float = 0.0  # local momentum coefficient (0 = off)
    selection: bool = False  # DFedSGPSM-S neighbor selection
    lr: float = 0.1
    lr_decay: float = 0.998
    batch_size: int = 32
    solver: str = "sam_momentum"  # sam_momentum | sgd | proximal
    compressor: str = "identity"  # identity | int8_rows | topk_ef
    topk_ratio: float = 0.05  # kept fraction per row (topk_ef)
    prox_mu: float = 0.01  # proximal pull strength (proximal solver)
    # Legacy spelling of ``compressor="int8_rows"`` (the flat=False oracle
    # quantizes per leaf instead of per row).
    quantize_gossip: bool = False


ALGORITHMS: dict[str, AlgoConfig] = {
    "fedavg": AlgoConfig("fedavg", "central"),
    "dpsgd": AlgoConfig("dpsgd", "symmetric", local_steps=1),
    "dfedavg": AlgoConfig("dfedavg", "symmetric"),
    "dfedavgm": AlgoConfig("dfedavgm", "symmetric", alpha=0.9),
    "dfedsam": AlgoConfig("dfedsam", "symmetric", rho=0.25),
    "sgp": AlgoConfig("sgp", "directed", local_steps=1),
    "osgp": AlgoConfig("osgp", "directed"),
    "dfedsgpm": AlgoConfig("dfedsgpm", "directed", alpha=0.9),
    "dfedsgpsm": AlgoConfig("dfedsgpsm", "directed", alpha=0.9, rho=0.1),
    "dfedsgpsm_s": AlgoConfig(
        "dfedsgpsm_s", "directed", alpha=0.9, rho=0.1, selection=True
    ),
}


def make_algo(name: str, **overrides) -> AlgoConfig:
    return dataclasses.replace(ALGORITHMS[name], **overrides)


def _quantize_dequantize(tree):
    """Simulated int8 symmetric quantization of gossip payloads, one global
    scale per (client-stacked) leaf — the flat bank uses the tighter
    per-row ``Int8RowCompressor``."""

    def qdq(x):
        flat_x = x.float()
        scale = flat_x.abs().max() / 127.0 + 1e-12
        q = torch.clamp(torch.round(flat_x / scale), -127, 127)
        return (q * scale).to(x.dtype)

    return tree_map(qdq, tree)


class FLTrainer:
    """Thin stateful wrapper over the round program.

    Args:
      loss_fn: ``loss_fn(params, batch) -> (loss, accuracy)``.
      init_fn: ``init_fn(generator) -> params`` for a single client.
      client_data: dict of arrays or tensors with leading dims
        (n_clients, m, ...); moved to ``device``.
      algo: AlgoConfig.
      topo: TopologyConfig (ignored for centralized algorithms).
      seed: seed of the trainer's ``torch.Generator`` (model init, then
        every round's topology and minibatch draws; the link and churn
        streams are generators of their own, seeded from it).
      flat: run rounds on the flat (n, D) bank through the kernels
        (default); ``False`` selects the per-leaf parameter-dict path, the
        equivalence oracle, which mixes with the plain versions.
      gossip: ``"auto"`` (density rule) or force ``"sparse"`` / ``"dense"``.
      link: unreliable-link scenario (``topology.LinkModel``).
      churn: node-failure scenario (``topology.ChurnModel``).
      delta: low-rank delta bank (``flat.DeltaConfig``, or a rank /
        ``"full"``).
      bank_dtype: storage dtype of the bank rows (e.g. ``torch.bfloat16``);
        momentum and the EF residual stay float32.
      paged: virtual client population — the ``(n, D)`` bank lives in a
        disk-backed :class:`repro_torch.store.ClientStore` under
        ``store_dir`` and each round pages in only its fault-in closure
        (the ``k_active`` sampled clients plus their in-neighbors), with
        background prefetch and async write-back; the compact round runs
        on ``device``.  Buffers scale with the closure, not n; the
        checkpoint is the store itself.  Directed push-sum, perfect links
        only.  ``rows_per_chunk``, ``prefetch``, ``lru_rows`` and
        ``faults`` (a :class:`repro_torch.store.FaultInjector`) configure
        the store and its pager.
      mesh: row-shards the bank over the ``"clients"`` axis of a 1-D
        ``torch.distributed`` device mesh
        (:func:`repro_torch.launch.mesh.make_clients_mesh`), one rank a
        shard; every rank builds the same trainer with the same seed.
        ``save`` gathers the bank to rank 0, which writes the reference's
        file; ``restore`` hands each rank its rows.
      device: where the bank lives and the kernels run; ``"cuda"`` by
        default, ``"cpu"`` only when asked (the kernels' plain versions).
    """

    def __init__(
        self,
        loss_fn: Callable,
        init_fn: Callable,
        client_data,
        algo: AlgoConfig,
        topo: topology.TopologyConfig,
        seed: int = 0,
        participation: float = 0.1,
        flat: bool = True,
        gossip: str = "auto",
        link: topology.LinkModel | None = None,
        churn: topology.ChurnModel | None = None,
        mesh=None,
        paged: bool = False,
        store_dir: str | None = None,
        k_active: int = 0,
        rows_per_chunk: int = 256,
        prefetch: bool = True,
        lru_rows: int | None = None,
        faults=None,
        delta=None,
        bank_dtype=None,
        device="cuda",
    ):
        if paged:
            if not flat:
                raise ValueError("paged training runs on the flat bank")
            if mesh is not None:
                raise ValueError("paged training is single-host; drop the "
                                 "mesh (disk, not devices, bounds n)")
            if link is not None and link.active:
                raise ValueError("paged training models perfect links only")
            if not store_dir:
                raise ValueError("paged=True needs store_dir")
            if k_active < 1:
                raise ValueError("paged=True needs k_active >= 1")
        elif faults is not None:
            raise ValueError(
                "faults= injects into the disk-backed store; it needs "
                "paged=True"
            )
        if not flat and mesh is not None:
            raise ValueError("the flat=False oracle path is single-device")
        if not flat and (delta is not None or bank_dtype is not None):
            raise ValueError(
                "the flat=False oracle path keeps full-precision per-leaf "
                "pytrees; delta=/bank_dtype= need the flat bank"
            )
        if not flat and link is not None and link.active:
            raise ValueError(
                "the flat=False oracle path models perfect links only"
            )
        if not flat and churn is not None and churn.active:
            raise ValueError(
                "the flat=False oracle path models an immortal population "
                "only"
            )
        if not flat and (
            algo.solver != "sam_momentum"
            or algo.compressor not in ("identity", "int8_rows")
        ):
            raise ValueError(
                "the flat=False oracle path only supports the "
                "sam_momentum solver with identity/int8_rows compression, "
                f"not solver={algo.solver!r} compressor={algo.compressor!r}"
            )
        self.loss_fn = loss_fn
        self.algo = algo
        self.topo = topo
        self.participation = participation
        self.flat = flat
        self.n = topo.n_clients
        self.device = torch.device(device)
        # Paged mode drives churn host-side in the runner (dead clients
        # leave the sampling pool; the program itself stays churn-free).
        self.program = make_program(
            loss_fn, init_fn, client_data, algo, topo, participation,
            gossip=gossip, link=link, churn=None if paged else churn,
            mesh=mesh, delta=delta, bank_dtype=bank_dtype, device=self.device,
        )
        self.spec = self.program.spec
        self.paged = paged
        self.runner = None
        gen = torch.Generator(device=self.device).manual_seed(seed)
        if paged:
            # The bank never materializes: the store holds the population,
            # the runner pages closures through program.step_active.
            from repro_torch.store import PagedRunner

            self.runner = PagedRunner(
                self.program, store_dir, k_active, seed=seed,
                rows_per_chunk=rows_per_chunk, prefetch=prefetch,
                lru_rows=lru_rows, churn=churn, faults=faults,
            )
            self.state = None
        elif flat:
            self.state = self.program.init(gen)
        else:
            # The same generator in the same order as the flat path: the
            # model first, then each round's operator and minibatches.
            params0 = init_fn(gen)
            w0 = torch.ones((self.n,), dtype=torch.float32, device=self.device)
            losses0 = torch.zeros((self.n,), dtype=torch.float32,
                                  device=self.device)
            if algo.comm != "central":
                params0 = tree_map(
                    lambda x: x.expand((self.n,) + tuple(x.shape)).contiguous(),
                    params0)
            self.state = FLState(params0, None, w0, gen, 0, losses0)

    # -- the flat=False oracle: per-leaf parameter dicts, plain mixes ---------

    def _local_update(self, params, w, batch_idx, data, lr):
        """K iterations of Algorithm 1 lines 4-11 for every client (rows of
        the client-stacked ``params``), ``batch_idx`` (K, rows, B)."""
        algo = self.algo

        def grad_one(x_i, w_i, bx, by):
            z = tree_map(lambda p: p / w_i, x_i)  # line 5: de-bias
            g, (loss, acc) = sam_gradient(self.loss_fn, z, {"x": bx, "y": by},
                                          algo.rho)  # lines 6-8
            return g, loss, acc

        grads = vmap(grad_one)
        x = params
        v = tree_map(lambda t: torch.zeros_like(t, dtype=torch.float32), x)
        losses, accs = [], []
        for k in range(algo.local_steps):
            batch = _sample_batch(data, batch_idx[k])
            g, loss, acc = grads(x, w, batch["x"], batch["y"])
            v = momentum_update(v, g, algo.alpha)  # line 9
            x = apply_update(x, v, lr)  # line 10
            losses.append(loss)
            accs.append(acc)
        return x, torch.stack(losses).mean(dim=0), torch.stack(accs).mean(dim=0)

    def _round_legacy(self, state: FLState, draws: dict):
        prog, algo = self.program, self.algo
        lr = prog.round_lr(state.round)
        if algo.comm == "central":
            return self._fedavg_round_legacy(state, lr, draws)
        P = draws.get("P")
        P = (prog.mixing_matrix(state.key, state) if P is None
             else _as_device(P, self.device))
        idx = draws.get("batch_idx")
        idx = (prog._batch_idx(state.key, self.n) if idx is None
               else torch.as_tensor(idx, device=self.device).long())
        x_half, losses, accs = self._local_update(
            state.params, state.w, idx, prog.data, lr)
        x_send = x_half
        if algo.quantize_gossip or algo.compressor == "int8_rows":
            x_send = _quantize_dequantize(x_half)
        # The oracle mixes with the plain versions by construction: it is
        # what the kernel-backed flat path is held against.
        x_new = pushsum.gossip(P, x_send, use_kernel=False)
        if x_send is not x_half:
            # The self-loop P[ii]·x_i is local memory, never quantized.
            s = _self_weights(P)

            def fresh_self(xn, xh, xq):
                shape = (xn.shape[0],) + (1,) * (xn.ndim - 1)
                return xn + (s.reshape(shape) * (xh - xq)).to(xn.dtype)

            x_new = tree_map(fresh_self, x_new, x_half, x_send)
        w_new = (pushsum.gossip_weights(P, state.w) if algo.comm == "directed"
                 else state.w)
        new_state = FLState(x_new, None, w_new, state.key, state.round + 1,
                            losses)
        return new_state, {"loss": losses.mean(), "acc": accs.mean()}

    def _fedavg_round_legacy(self, state: FLState, lr, draws: dict):
        prog = self.program
        m = max(int(self.participation * self.n), 1)
        sel = draws.get("sel")
        sel = (torch.randperm(self.n, generator=state.key,
                              device=self.device)[:m]
               if sel is None else torch.as_tensor(sel,
                                                   device=self.device).long())
        idx = draws.get("batch_idx")
        idx = (prog._batch_idx(state.key, m) if idx is None
               else torch.as_tensor(idx, device=self.device).long())
        data_sel = {k: v[sel] for k, v in prog.data.items()}
        start = tree_map(
            lambda x: x.expand((m,) + tuple(x.shape)).contiguous(), state.params)
        ones = torch.ones((m,), dtype=torch.float32, device=self.device)
        xs, losses, accs = self._local_update(start, ones, idx, data_sel, lr)
        new_losses = state.losses.clone()
        new_losses[sel] = losses
        new_state = FLState(tree_map(lambda x: x.mean(dim=0), xs), state.mom,
                            state.w, state.key, state.round + 1, new_losses)
        return new_state, {"loss": losses.mean(), "acc": accs.mean()}

    # -- public API -------------------------------------------------------------

    def run_round(self, draws: dict | None = None):
        """One round; ``draws`` as in :meth:`RoundProgram.step` (the oracle
        reads ``P``, ``batch_idx`` and ``sel``; a paged trainer those of
        :meth:`repro_torch.store.PagedRunner.run_round`)."""
        if self.paged:
            return self.runner.run_round(draws)
        if self.flat:
            self.state, metrics = self.program.step(self.state, draws)
        else:
            self.state, metrics = self._round_legacy(self.state, draws or {})
        return metrics

    def average_model(self):
        """Consensus model x̄ (Algorithm 1 output)."""
        if self.paged:
            # Streamed over store chunks; (n, D) never materializes.
            return self.spec.unravel(torch.from_numpy(
                self.runner.mean_params()).to(self.device))
        if self.algo.comm == "central":
            return (self.spec.unravel(self.state.params) if self.flat
                    else self.state.params)
        if self.flat:
            return self.spec.unravel(
                self.program.whole_state(self.state).params.mean(dim=0))
        return tree_map(lambda x: x.mean(dim=0), self.state.params)

    def debiased_models(self):
        """Client-stacked de-biased models z_i = x_i / w_i."""
        if self.paged:
            raise ValueError(
                "debiased_models materializes the full (n, D) bank — the "
                "point of paged mode is that it never exists; stream rows "
                "via trainer.runner.store.iter_chunks() instead"
            )
        if self.flat and self.algo.comm != "central":
            st = self.program.whole_state(self.state)
            if isinstance(self.spec, BoundDeltaSpec):
                # z_i = base + expand(row_i) / w_i: the base is not divided.
                return self.spec.debias_stacked(st.params, st.w)
            z = pushsum.debias_bank(st.params, st.w)
            return self.spec.unravel_stacked(z)
        return pushsum.debias(self.state.params, self.state.w)

    def consensus_error(self):
        """Mean squared distance of de-biased params from the average."""
        if self.paged:
            return self.runner.consensus_error()
        if self.flat and self.algo.comm != "central":
            st = self.program.whole_state(self.state)
            return pushsum.consensus_error_bank(st.params, st.w)
        return pushsum.consensus_error(self.state.params, self.state.w)

    def evaluate(self, test_data, batch: int = 1024):
        """``(test_loss, test_acc)`` of the consensus model.  The flat path
        runs the program's eval (as :meth:`fit` does); the oracle pads every
        chunk to ``batch`` rows and masks the pads out of the sums."""
        if self.flat and not self.paged:
            tl, ta = self.program.make_eval_fn(test_data, batch)(self.state)
            return float(tl), float(ta)
        params = self.average_model()
        test = {k: torch.as_tensor(v, device=self.device)
                for k, v in test_data.items()}
        n = test["x"].shape[0]

        def one(x, y):
            return self.loss_fn(params, {"x": x[None], "y": y[None]})

        zero = torch.zeros((), dtype=torch.float32, device=self.device)
        tot_l, tot_a = 0.0, 0.0
        with torch.no_grad():
            for i in range(0, n, batch):
                chunk = {k: v[i:i + batch] for k, v in test.items()}
                b = chunk["x"].shape[0]
                if b < batch:  # pad to the fixed shape; the mask strips it
                    chunk = {k: torch.cat([v, v.new_zeros(
                        (batch - b,) + tuple(v.shape[1:]))])
                        for k, v in chunk.items()}
                mask = torch.arange(batch, device=self.device) < b
                per_l, per_a = vmap(one)(chunk["x"], chunk["y"])
                # where, not multiply: a non-finite loss on a pad row must
                # not poison the sum through NaN * 0.
                tot_l += float(torch.where(mask, per_l, zero).sum())
                tot_a += float(torch.where(mask, per_a, zero).sum())
        return tot_l / n, tot_a / n

    def fit(self, rounds: int, test_data=None, eval_every: int = 0, log=None,
            superstep: int = 0):
        """Train ``rounds`` rounds; returns per-round history records, with
        the scenario extras (``comm_fraction``, ``w_mass``, ``w_inflight``)
        where the round reports them.  On the flat path the rounds run in
        supersteps of ``superstep`` rounds (``0``: one superstep) with the
        eval at the global-round cadence ``eval_every``; the oracle keeps a
        per-round loop."""
        if not self.flat or self.paged:
            # Paged rounds are host-orchestrated by design (the plan /
            # prefetch / write-back pipeline is the host loop).
            return self._fit_python_loop(rounds, test_data, eval_every, log)
        history = []
        done = 0
        chunk = rounds if superstep <= 0 else superstep
        cadence = eval_every if test_data is not None else 0
        while done < rounds:
            length = min(chunk, rounds - done)
            self.state, hist = self.program.run_superstep(
                self.state, length, cadence, test_data
            )
            hist = {k: v.cpu() for k, v in hist.items()}
            for i in range(length):
                rec = {"round": done + i, "loss": float(hist["loss"][i]),
                       "acc": float(hist["acc"][i])}
                for k in ("comm_fraction", "w_mass", "w_inflight"):
                    if k in hist:
                        rec[k] = float(hist[k][i])
                if "eval_mask" in hist and bool(hist["eval_mask"][i]):
                    rec["test_loss"] = float(hist["test_loss"][i])
                    rec["test_acc"] = float(hist["test_acc"][i])
                history.append(rec)
                if log:
                    log(rec)
            done += length
        return history

    def _fit_python_loop(self, rounds, test_data, eval_every, log):
        """Per-round host loop of the ``flat=False`` oracle and the paged
        runner; paged trainers also stream a full-population eval
        (``PagedRunner.eval_population``) at the same cadence."""
        history = []
        for r in range(rounds):
            metrics = self.run_round()
            rec = {"round": r, **{k: float(v) for k, v in metrics.items()}}
            if eval_every and (r + 1) % eval_every == 0:
                if test_data is not None:
                    tl, ta = self.evaluate(test_data)
                    rec.update(test_loss=tl, test_acc=ta)
                if self.paged:
                    rec.update(self.runner.eval_population(
                        closure_loss=metrics.get("loss")))
            history.append(rec)
            if log:
                log(rec)
        return history

    # -- checkpointing (full FLState) -------------------------------------------

    def save(self, directory: str | None = None, step: int = 0,
             keep: int = 3) -> str:
        """Checkpoint the full ``FLState`` (params and momentum banks,
        push-sum weights, round, random streams, compressor state and the
        link and churn carries) with
        :func:`repro_torch.checkpoint.save_state`.  A row-sharded trainer
        gathers the whole state to every rank, rank 0 writes it (the file
        an unsharded trainer writes), and every rank returns its path.
        Paged trainers ignore
        ``directory`` / ``step`` / ``keep``: the checkpoint is the store —
        ``save`` flushes dirty rows and commits ``(round, key)`` into its
        manifest, returning the store path."""
        from repro_torch import checkpoint

        if self.paged:
            return self.runner.save()
        if not self.flat:
            raise ValueError("full-state checkpointing needs the flat path")
        if directory is None:
            raise ValueError("save() needs a checkpoint directory")
        shard = self.program.shard
        if shard is None:
            return checkpoint.save_state(directory, step, self.state,
                                         self.spec, keep=keep)
        import torch.distributed as dist

        state = self.program.whole_state(self.state)
        path = [checkpoint.save_state(directory, step, state, self.spec,
                                      keep=keep) if shard.rank == 0 else None]
        dist.broadcast_object_list(path, src=dist.get_global_rank(
            shard.group, 0), group=shard.group)
        return path[0]

    def restore(self, path: str, *, key=None, link_key=None,
                churn_key=None) -> FLState:
        """Warm-restart from a full-``FLState`` checkpoint, written by
        either package (paged trainers re-sync to their store's last
        committed manifest).  ``key`` / ``link_key`` / ``churn_key`` supply
        the random streams a file cannot (a reference checkpoint holds
        JAX keys); every mismatch of composition the reference refuses
        raises here too.  A row-sharded trainer keeps its rows of the
        file's state (``RoundProgram.shard_state``), so it resumes sharded
        from its first round."""
        from repro_torch import checkpoint

        if self.paged:
            self.runner.restore(path)
            return None
        if not self.flat:
            raise ValueError("full-state checkpointing needs the flat path")
        # A stream this composition has no use for is not asked of the
        # file: the composition guards below refuse such a file instead.
        if link_key is None and not self.program.linked:
            link_key = torch.Generator(device=self.device)
        if churn_key is None and not self.program.churned:
            churn_key = torch.Generator(device=self.device)
        state = checkpoint.restore_state(path, self.spec, self.device,
                                         key=key, link_key=link_key,
                                         churn_key=churn_key)
        needs = self.program.compressor.stateful
        has = not _is_empty(state.comp)
        if needs and not has:
            raise ValueError(
                f"{path} carries no compressor state, but "
                f"compressor={self.algo.compressor!r} needs its residual "
                "bank — it was saved from a stateless composition"
            )
        if has and not needs:
            raise ValueError(
                f"{path} carries compressor state, but this trainer's "
                f"compressor={self.algo.compressor!r} is stateless"
            )
        has_link = not _is_empty(state.link)
        if self.program.linked != has_link:
            raise ValueError(
                f"{path} {'carries' if has_link else 'carries no'} "
                "unreliable-link state, but this trainer's link scenario "
                f"{'does not use' if has_link else 'needs'} it — restore "
                "with the composition that saved it"
            )
        if has_link:
            # Presence is not enough: compare the buffer structure against
            # what this mixer carries.
            want = self.program.mixer.link_buffers(state.params)
            for field in ("bufx", "bufw", "last"):
                have = getattr(state.link, field)
                exp = want.get(field)
                have_arr = not _is_empty(have)
                if have_arr != (exp is not None) or (
                    have_arr and tuple(have.shape) != tuple(exp.shape)
                ):
                    raise ValueError(
                        f"{path} link carry field {field!r} is "
                        f"{tuple(have.shape) if have_arr else 'absent'}, "
                        "but this trainer's link composition expects "
                        f"{tuple(exp.shape) if exp is not None else 'none'}"
                        " — restore with the composition that saved it"
                    )
        has_churn = not _is_empty(state.churn)
        if self.program.churned != has_churn:
            raise ValueError(
                f"{path} {'carries' if has_churn else 'carries no'} "
                "node-churn state, but this trainer's churn scenario "
                f"{'does not use' if has_churn else 'needs'} it — restore "
                "with the composition that saved it"
            )
        if has_churn:
            cold = self.program.churn_model.resurrect == "cold"
            has_tpl = not _is_empty(state.churn.tpl)
            if cold != has_tpl:
                raise ValueError(
                    f"{path} churn carry "
                    f"{'holds' if has_tpl else 'holds no'} cold-"
                    "resurrection template row, but this trainer's "
                    f"ChurnModel.resurrect="
                    f"{self.program.churn_model.resurrect!r} — restore "
                    "with the composition that saved it"
                )
        self.state = self.program.shard_state(state)
        return self.state

