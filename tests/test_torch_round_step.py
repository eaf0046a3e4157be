"""The port's pods-as-clients round (``launch.steps.make_round_step``)
against the JAX reference's, on the CPU at ``reduced`` glm4-9b (f32, 2
layers, 4 query heads on 2 kv heads, hd 64), 2 pods, K = 2 local steps of
2 x 16 tokens from ``make_lm_stream``; and at ``reduced`` gemma3-12b (the
same widths, qk-norm, tied embeddings, dual rope thetas) with its window
cut to 8 tokens, so that layer 0 is a windowed layer over the 16 tokens
and layer 1 a global one, with the dense mix and the gather.

Each case runs 2 rounds, each restarted from the reference's state (params,
momentum ``v``, push-sum weights ``w``, the compressor carry ``comp`` and
the link carry ``link``), and compares the port's state and metrics after
the round with the reference's.  Cases: the dense ``P_pod`` and the
neighbor-list ``pod_mixing_neighbors`` (the gather), ``identity`` and
``topk_ef`` compressors, the leafwise mix (``flat_mix=False``), and link
drops fed the reference's own drop uniforms (``draws``; the reference
draws them from ``split(split(link.key)[0])[0]``, as ``stages.comm_phase``
splits).

Tolerance: both packages compute in f32, with the matmul, softmax and
gradient sums in their own orders (about 1e-7 relative per sum); two SAM
passes and K = 2 steps carry that into the params and the momentum (a sum
of gradients): measured at most 6.3e-7 of a params leaf's largest
magnitude and 1.0e-6 of a momentum leaf's.  So params, ``v`` and ``comp``
are held to 1e-5 of each leaf's largest magnitude, ``w`` to 1e-6, the loss
to 1e-5 relative, and the accuracy (a mean of argmax hits over 64 tokens a
step) exactly: the logits differ by far less than their gaps.  Top-k keeps
the same coordinates in both packages on these inputs (no value lies near
the k-th magnitude within the noise), which the ``comp`` residual's
tolerance checks.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as ref_registry
from repro.core.stages import LinkState as RefLinkState
from repro.core.topology import NeighborList as RefNeighborList
from repro.data.synthetic import make_lm_stream as ref_make_lm_stream
from repro.launch import steps as ref_steps
from repro.models.registry import get_model_api as ref_get_model_api
from repro_torch.configs import registry
from repro_torch.core.stages import LinkState
from repro_torch.interop import pod_state_from_numpy
from repro_torch.launch import steps
from repro_torch.models.registry import get_model_api

ARCH = "glm4-9b"
N_PODS, K, B, S = 2, 2, 2, 16
GEMMA_WINDOW = 8  # under S: the local layer's window closes keys
ROUNDS = 2

CASES = {
    "dense": dict(),
    "neighbors": dict(neighbors=True),
    "topk_ef": dict(compressor="topk_ef"),
    "leafwise": dict(flat_mix=False),
    # Drop rates high enough that the reference's draws drop a link in
    # these 2 rounds (2 coins a round).
    "drops": dict(link_drop=0.9),
    "drops_delays": dict(link_drop=0.7, link_delay=1),
}

# (arch, case) pairs; glm4-9b's keep their case names as test ids.
ARCH_CASES = ([pytest.param(ARCH, c, id=c) for c in sorted(CASES)]
              + [pytest.param("gemma3-12b", c, id=f"gemma3-12b-{c}")
                 for c in ("dense", "neighbors")])

_CACHE: dict = {}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this file's small tensors: the suite runs
    files in parallel workers, and a thread pool per worker oversubscribes
    the cores (tiny ops then wait on each other's spinning threads)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _configs(arch):
    """(reference config, port config) of ``arch`` at reduced size."""
    if arch == "gemma3-12b":
        from repro.configs.base import reduced as ref_reduced
        from repro_torch.configs.base import reduced

        return (ref_reduced(ref_registry.get_config(arch),
                            sliding_window=GEMMA_WINDOW),
                reduced(registry.get_config(arch), sliding_window=GEMMA_WINDOW))
    return (ref_registry.get_config(arch, smoke=True),
            registry.get_config(arch, smoke=True))


def _setup(arch=ARCH):
    if arch not in _CACHE:
        ref_cfg, cfg = _configs(arch)
        ref_api, api = ref_get_model_api(ref_cfg), get_model_api(cfg)
        p = ref_api.init(jax.random.PRNGKey(0))
        # Two distinct replicas, so that the first mix already moves them.
        params = jax.tree.map(
            lambda x: jnp.stack([x, x * 0.5]), p)
        toks = np.asarray(ref_make_lm_stream(
            ref_api.cfg.vocab_size, S, ROUNDS * N_PODS * K * B))
        _CACHE[arch] = dict(ref_api=ref_api, api=api, params=params,
                            toks=toks.reshape(ROUNDS, N_PODS, K, B, S))
    return _CACHE[arch]


def _empty(x) -> bool:
    return isinstance(x, tuple) and not hasattr(x, "_fields")


def _port_state(ref):
    """The port's carries from the reference's, through
    ``interop.pod_state_from_numpy``."""
    params, v, w, comp, link = jax.device_get(ref)
    dump = {"params": params, "v": v, "w": w,
            "comp": None if _empty(comp) else comp}
    if not _empty(link):
        dump["link"] = {f: None if _empty(getattr(link, f))
                        else getattr(link, f) for f in ("bufx", "bufw", "last")}
    state = pod_state_from_numpy(dump,
                                 link_key=torch.Generator().manual_seed(0))
    assert isinstance(state[4], LinkState) != _empty(link)
    return state


def _link_draws(link, P, drop, delay):
    """This round's drop uniforms and delays from the reference's link key,
    split as ``stages.comm_phase`` splits it."""
    lkey = jax.random.split(link.key)[0]
    draws = {}
    if drop > 0:
        dkey, lkey = jax.random.split(lkey)
        draws["drop"] = np.array(jax.random.uniform(dkey, np.shape(P)))
    if delay:
        draws["delay"] = np.array(jax.random.randint(lkey, np.shape(P), 0,
                                                     delay + 1))
    return draws


def _close(got, want, rel, what):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max()) if want.size else 0.0
    assert err <= rel * scale, f"{what}: max|err| {err:.3e} > {rel} x {scale:.3e}"


@pytest.mark.parametrize("arch,case", ARCH_CASES)
def test_round_step_matches_reference(arch, case):
    kw = CASES[case]
    c = _setup(arch)
    if arch == "gemma3-12b":  # a windowed and a global layer
        assert [c["api"].cfg.window_for_layer(i) for i in range(2)] == [
            GEMMA_WINDOW, 0]
    ref_api, api = c["ref_api"], c["api"]
    step_kw = dict(lr=0.05, alpha=0.9, rho=0.05, local_steps=K,
                   compressor=kw.get("compressor", "identity"),
                   link_drop=kw.get("link_drop", 0.0),
                   link_delay=kw.get("link_delay", 0))
    flat = kw.get("flat_mix", True)
    ref_cfg = ref_steps.StepConfig(**step_kw)
    cfg = steps.StepConfig(**step_kw)
    ref_round = jax.jit(ref_steps.make_round_step(ref_api, ref_cfg,
                                                  flat_mix=flat))
    port_round = steps.make_round_step(api, cfg, flat_mix=flat)
    if kw.get("neighbors"):
        ref_P, P = (ref_steps.pod_mixing_neighbors(N_PODS),
                    steps.pod_mixing_neighbors(N_PODS))
        assert isinstance(ref_P, RefNeighborList)
        np.testing.assert_array_equal(P.idx.numpy(), np.asarray(ref_P.idx))
        np.testing.assert_array_equal(P.wgt.numpy(), np.asarray(ref_P.wgt))
    else:
        ref_P, P = (ref_steps.pod_mixing_matrix(N_PODS),
                    steps.pod_mixing_matrix(N_PODS))
        np.testing.assert_array_equal(P.numpy(), np.asarray(ref_P))

    params = c["params"]
    v = jax.tree.map(jnp.zeros_like, params)
    w = jnp.ones((N_PODS,))
    comp_stage = ref_steps.resolve_compressor(ref_cfg)
    comp = ref_steps.init_pod_comp_state(comp_stage, params)
    link_model = ref_steps.resolve_pod_link(ref_cfg)
    mixer = ref_steps.resolve_pod_mixer(ref_cfg, link_model)
    link = ref_steps.init_pod_link_state(mixer, link_model, params)
    ref = (params, v, w, comp, link)
    dropped = delayed = 0
    for r in range(ROUNDS):
        batch = {"tokens": c["toks"][r]}
        draws = None if _empty(link) else _link_draws(
            ref[4], ref_P, step_kw["link_drop"], step_kw["link_delay"])
        if draws is not None:
            dropped += int(((draws["drop"] < step_kw["link_drop"])
                            & ~np.eye(N_PODS, dtype=bool)).sum())
            delayed += int((np.asarray(draws.get("delay", 0)) > 0).sum())
        out = _port_state(ref)
        got = port_round(*out, {"tokens": torch.from_numpy(batch["tokens"])},
                         P, draws)
        ref_out = ref_round(*ref, {"tokens": jnp.asarray(batch["tokens"])},
                            ref_P)
        ref_params, ref_v, ref_w, ref_comp, ref_link, ref_m = \
            jax.device_get(ref_out)
        g_params, g_v, g_w, g_comp, g_link, g_m = got
        for key in ("embed", "final_norm"):
            _close(g_params[key], ref_params[key], 1e-5, f"{case} r{r} {key}")
        for name, leaf in ref_params["layers"]["attn"].items():
            _close(g_params["layers"]["attn"][name], leaf, 1e-5,
                   f"{case} r{r} attn.{name}")
        for name, leaf in ref_params["layers"]["mlp"].items():
            _close(g_params["layers"]["mlp"][name], leaf, 1e-5,
                   f"{case} r{r} mlp.{name}")
        for name in ("wq", "wo"):
            _close(g_v["layers"]["attn"][name],
                   ref_v["layers"]["attn"][name], 1e-5, f"{case} r{r} v.{name}")
        _close(g_v["embed"], ref_v["embed"], 1e-5, f"{case} r{r} v.embed")
        _close(g_w, ref_w, 1e-6, f"{case} r{r} w")
        if not _empty(ref_comp):
            _close(g_comp, ref_comp, 1e-5, f"{case} r{r} comp")
        if not _empty(ref_link) and not _empty(ref_link.bufx):
            _close(g_link.bufx, ref_link.bufx, 1e-5, f"{case} r{r} bufx")
            _close(g_link.bufw, ref_link.bufw, 1e-6, f"{case} r{r} bufw")
        assert _empty(g_link) == _empty(ref_link)
        assert abs(float(g_m["loss"]) - float(ref_m["loss"])) <= \
            1e-5 * abs(float(ref_m["loss"])), (case, r)
        assert float(g_m["acc"]) == float(ref_m["acc"]), (case, r)
        ref = jax.device_get(ref_out[:5])
        inflight = (0.0 if _empty(ref_link) or _empty(ref_link.bufw)
                    else float(ref_link.bufw.sum()))
        assert float(ref_w.sum()) + inflight == pytest.approx(N_PODS,
                                                              abs=1e-6)
    if not _empty(link):
        assert isinstance(link, RefLinkState)
        assert dropped, "no link dropped in the case's rounds"
        assert delayed or not step_kw["link_delay"], "no payload delayed"


def test_pod_mixers_and_plan_match_reference():
    """The stage resolution and the pod comm plan: the same compressor,
    link model and mixer kinds, and the ring's static shift plan."""
    for kw in (dict(), dict(compressor="int8_rows"),
               dict(link_drop=0.2), dict(link_delay=2),
               dict(event_threshold=0.5)):
        ref_cfg, cfg = ref_steps.StepConfig(**kw), steps.StepConfig(**kw)
        assert (type(steps.resolve_compressor(cfg)).__name__
                == type(ref_steps.resolve_compressor(ref_cfg)).__name__)
        ref_link, link = (ref_steps.resolve_pod_link(ref_cfg),
                          steps.resolve_pod_link(cfg))
        assert (ref_link is None) == (link is None)
        assert (type(steps.resolve_pod_mixer(cfg, link)).__name__
                == type(ref_steps.resolve_pod_mixer(ref_cfg, ref_link)).__name__)
    for n, shards in ((2, 1), (2, 2), (8, 4)):
        ref_plan = ref_steps.pod_comm_plan(n, shards)
        plan = steps.pod_comm_plan(n, shards)
        assert (plan.static, plan.k_in, plan.k_max, plan.m) == (
            ref_plan.static, ref_plan.k_in, ref_plan.k_max, ref_plan.m)
        assert len(plan.legs) == len(ref_plan.legs)
        for a, b in zip(plan.legs, ref_plan.legs):
            assert (a.delta, tuple(a.offsets)) == (b.delta, tuple(b.offsets))
    with pytest.raises(ValueError, match="unknown compressor"):
        steps.resolve_compressor(steps.StepConfig(compressor="nope"))


def test_round_step_refusals():
    api = _setup()["api"]
    cfg = steps.StepConfig()
    with pytest.raises(ValueError, match="auto|xla|halo"):
        steps.make_round_step(api, cfg, gossip="nccl")
    with pytest.raises(ValueError, match="flat_mix"):
        steps.make_round_step(api, steps.StepConfig(compressor="topk_ef"),
                              flat_mix=False)
    with pytest.raises(ValueError, match="flat_mix"):
        steps.make_round_step(api, steps.StepConfig(link_drop=0.1),
                              flat_mix=False)
    from repro_torch.core.stages import SymmetricMixer

    with pytest.raises(ValueError, match="no pod halo form"):
        steps.make_round_step(api, cfg, mixer=SymmetricMixer(), gossip="halo")
    # "xla" runs as "auto" on one device.
    steps.make_round_step(api, cfg, gossip="xla")


def test_halo_without_a_mesh_runs_as_auto():
    """The reference's rule: without a mesh ``gossip="halo"`` builds, and
    its round is the ``"auto"`` round bit for bit (no pod axis to ship
    a halo over)."""
    c = _setup()
    cfg = steps.StepConfig(lr=0.05, alpha=0.9, rho=0.05, local_steps=K)
    P = steps.pod_mixing_neighbors(N_PODS)
    outs = {}
    for gossip in ("auto", "halo"):
        state = _port_state(jax.tree.map(np.asarray, (
            c["params"], jax.tree.map(jnp.zeros_like, c["params"]),
            jnp.ones((N_PODS,)), (), ())))
        round_step = steps.make_round_step(c["api"], cfg, gossip=gossip)
        outs[gossip] = round_step(*state, {"tokens": torch.from_numpy(
            c["toks"][0])}, P)
    from repro_torch.core.flat import tree_flatten

    a, b = outs["auto"], outs["halo"]
    for x, y in zip(tree_flatten(a[0])[1], tree_flatten(b[0])[1]):
        assert torch.equal(x, y)
    assert torch.equal(a[2], b[2])
    assert float(a[5]["loss"]) == float(b[5]["loss"])


def test_halo_refuses_a_dense_pod_graph_on_a_pod_axis():
    """Under a mesh whose pod axis is above 1, ``gossip="halo"`` ships the
    pod ring's halo rows: a dense ``P_pod`` has none, and the round raises
    before its local steps (a fake 2-rank world: no traffic)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from repro_torch.launch import sharding
    from repro_torch.launch.mesh import make_host_mesh

    c = _setup()
    dist.init_process_group("fake", store=FakeStore(), rank=1, world_size=2)
    try:
        mesh = make_host_mesh((2, 1, 1), ("pod", "data", "model"),
                              device="cpu")
        state = _port_state(jax.tree.map(np.asarray, (
            c["params"], jax.tree.map(jnp.zeros_like, c["params"]),
            jnp.ones((N_PODS,)), (), ())))
        rows = steps.pod_rows(mesh, N_PODS)
        params, v, w = (steps.place_pods(c["api"], state[0], mesh),
                        steps.place_pods(c["api"], state[1], mesh),
                        rows.rows(state[2]))
        round_step = steps.make_round_step(c["api"], steps.StepConfig(),
                                           gossip="halo")
        batch = {"tokens": rows.rows(torch.from_numpy(c["toks"][0]))}
        with sharding.use_mesh(mesh):
            with pytest.raises(ValueError, match="dense P_pod"):
                round_step(params, v, w, (), (), batch,
                           steps.pod_mixing_matrix(N_PODS))
    finally:
        dist.destroy_process_group()
