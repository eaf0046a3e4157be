"""The port's mixture of experts (``repro_torch.models.moe``) against the JAX
reference's (``repro.models.moe``), on the CPU at ``reduced`` size (f32,
d = 256, 4 experts of width 512, top 2; deepseek's shared expert of 512),
one layer of parameters from the reference's own ``init``.

``_moe_gshard`` and ``_moe_dense`` get the reference's own ``(w, sel)`` on
both sides, so that the routing choice is not what is compared; the gshard
dispatch runs over both position rules (``moe_pos`` cumsum and sort), both
dispatch dtypes (the combine weights rounded to bf16 or kept in f32) and
capacity factors 8.0 (nothing dropped) and 0.25 (5 slots an expert for 20
assignments: most dropped).  The port scatters token rows into expert slots
and gathers them back where the reference contracts one-hot dispatch and
combine tensors, so each output is held to 1e-6 of its magnitude (f32
sums over d and f in each library's own order).  The positions and the kept
set are integer counts: equal.  The aux loss is the same f32 operations on
the same inputs, but each library takes its means in its own order (XLA's
``mean`` of the one-hot counts and of the probabilities differ from
PyTorch's by an ulp here): 1e-6 of its magnitude.

``_router_probs`` holds the probabilities to 1e-6 of their magnitude (f32
matmul sums in their own orders); its top-k choice must be equal wherever
the k-th and (k+1)-th probabilities of a token are more than 1e-5 apart,
which the test prints the smallest of.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as ref_registry
from repro.models import moe as ref_moe
from repro.models.registry import get_model_api as ref_get_model_api
from repro_torch.configs import registry
from repro_torch.interop import params_from_numpy
from repro_torch.models import moe

ARCHS = ("dbrx-132b", "deepseek-v3-671b")
B, S = 2, 40
GAP = 1e-5  # top-k choices closer than this may flip between libraries

_CACHE: dict = {}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this file's small tensors (the suite runs
    files in parallel workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _setup(arch):
    """(reference config, port config, layer-0 MLP params as numpy, port
    params, x as numpy), built once per arch."""
    if arch not in _CACHE:
        ref_cfg = ref_registry.get_config(arch, smoke=True)
        ref_params = jax.device_get(
            ref_get_model_api(ref_cfg).init(jax.random.PRNGKey(0)))
        p_np = jax.tree.map(lambda a: np.asarray(a[0]),
                            ref_params["layers"]["mlp"])
        x = np.random.default_rng(1).standard_normal(
            (B, S, ref_cfg.d_model)).astype(np.float32)
        _CACHE[arch] = (ref_cfg, registry.get_config(arch, smoke=True), p_np,
                        params_from_numpy(p_np), x)
    return _CACHE[arch]


def _close(got, want, what, rel):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else got
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= rel * scale, f"{what}: max|err| {err:.3e} > {rel} x {scale:.3e}"


def _ref_routing(arch):
    ref_cfg, cfg, p_np, p, x = _setup(arch)
    w, sel, probs = jax.device_get(ref_moe._router_probs(
        jax.tree.map(jnp.asarray, p_np), jnp.asarray(x), ref_cfg))
    return (np.asarray(w), np.asarray(sel), np.asarray(probs))


def test_both_moe_configs_are_ported():
    assert set(ARCHS) <= set(registry.PORTED_ARCH_IDS)
    # The whole zoo: the six transformer decoders of the lm task, xlstm-350m
    # and hymba-1.5b, llava-next-mistral-7b and hubert-xlarge.
    assert len(registry.PORTED_ARCH_IDS) == 10
    for arch in ARCHS:
        cfg = registry.get_config(arch)
        assert cfg.family == "moe" and cfg.n_experts


@pytest.mark.parametrize("arch", ARCHS)
def test_router_probs_match_the_reference(arch):
    ref_cfg, cfg, p_np, p, x = _setup(arch)
    ref_w, ref_sel, ref_probs = _ref_routing(arch)
    w, sel, probs = moe._router_probs(p, torch.from_numpy(x), cfg)
    _close(probs, ref_probs, "probs", 1e-6)
    # The k-th against the (k+1)-th probability of each token.
    top = np.sort(ref_probs, -1)[..., ::-1]
    gap = top[..., cfg.top_k - 1] - top[..., cfg.top_k]
    print(f"{arch}: smallest k-th / (k+1)-th gap {gap.min():.3e}")
    clear = gap > GAP
    assert clear.mean() > 0.9, "too many near-ties to hold the choice"
    got_sets = np.sort(sel.numpy(), -1)[clear]
    want_sets = np.sort(ref_sel, -1)[clear]
    np.testing.assert_array_equal(got_sets, want_sets)
    # The weights in the reference's order of the chosen experts.
    order = np.argsort(sel.numpy(), -1)
    ref_order = np.argsort(ref_sel, -1)
    _close(np.take_along_axis(w.numpy(), order, -1)[clear],
           np.take_along_axis(ref_w, ref_order, -1)[clear], "weights", 1e-6)


@pytest.mark.parametrize("arch", ARCHS)
def test_aux_loss_is_the_references(arch):
    ref_cfg, cfg = _setup(arch)[:2]
    _, sel, probs = _ref_routing(arch)
    got = moe._aux_loss(torch.from_numpy(sel).long(),
                        torch.from_numpy(probs.copy()), cfg)
    want = ref_moe._aux_loss(jnp.asarray(sel), jnp.asarray(probs), ref_cfg)
    assert got.dtype == torch.float32
    assert float(got) == pytest.approx(float(want), rel=1e-6, abs=0)


@pytest.mark.parametrize("e,k", [(16, 4), (256, 8)])
@pytest.mark.parametrize("rule", ["cumsum", "sort"])
def test_positions_are_the_references(rule, e, k):
    """Both position rules, on distinct random top-k choices at the full
    models' expert counts, against the reference's: the rule's own function
    and the other's give the same positions."""
    rng = np.random.default_rng(e + k)
    b, s = 3, 50
    sel = np.argsort(rng.random((b, s, e)), -1)[..., :k].astype(np.int32)
    ref_fn = ref_moe._positions_sort if rule == "sort" else ref_moe._positions_cumsum
    fn = moe._positions_sort if rule == "sort" else moe._positions_cumsum
    want = np.asarray(ref_fn(jnp.asarray(sel), b, s, k, e))
    got = fn(torch.from_numpy(sel).long(), b, s, k, e)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        moe._positions_cumsum(torch.from_numpy(sel).long(), b, s, k, e).numpy(),
        want)


@pytest.mark.parametrize("capacity_factor", [8.0, 0.25])
@pytest.mark.parametrize("ddt", ["f32", "bf16"])
@pytest.mark.parametrize("rule", ["cumsum", "sort"])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_gshard_matches_the_reference(arch, rule, ddt, capacity_factor):
    ref_cfg, cfg, p_np, p, x = _setup(arch)
    over = dict(moe_pos=rule, moe_dispatch_dtype=ddt,
                capacity_factor=capacity_factor)
    ref_cfg = dataclasses.replace(ref_cfg, **over)
    cfg = dataclasses.replace(cfg, **over)
    w, sel, _ = _ref_routing(arch)
    want = ref_moe._moe_gshard(jax.tree.map(jnp.asarray, p_np), jnp.asarray(x),
                               jnp.asarray(w), jnp.asarray(sel), ref_cfg)
    t_sel = torch.from_numpy(sel).long()
    got = moe._moe_gshard(p, torch.from_numpy(x), torch.from_numpy(w), t_sel,
                          cfg)
    _close(got, want, "moe_gshard", 1e-6)
    # The kept set: the reference's positions under its capacity.
    capacity = max(int(S * cfg.top_k / cfg.n_experts * capacity_factor),
                   cfg.top_k)
    assert moe.moe_capacity(S, cfg) == capacity
    ref_fn = ref_moe._positions_sort if rule == "sort" else ref_moe._positions_cumsum
    ref_keep = np.asarray(ref_fn(jnp.asarray(sel), B, S, cfg.top_k,
                                 cfg.n_experts)) < capacity
    pos, keep = moe.moe_positions(t_sel, cfg)
    np.testing.assert_array_equal(keep.numpy(), ref_keep)
    dropped = int((~ref_keep).sum())
    assert (dropped > 0) == (capacity_factor < 1), dropped


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_dense_matches_the_reference(arch):
    ref_cfg, cfg, p_np, p, x = _setup(arch)
    w, sel, _ = _ref_routing(arch)
    want = ref_moe._moe_dense(jax.tree.map(jnp.asarray, p_np), jnp.asarray(x),
                              jnp.asarray(w), jnp.asarray(sel), ref_cfg)
    got = moe._moe_dense(p, torch.from_numpy(x), torch.from_numpy(w),
                         torch.from_numpy(sel).long(), cfg)
    _close(got, want, "moe_dense", 1e-6)


@pytest.mark.parametrize("impl", ["gshard", "dense"])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_forward_matches_the_reference(arch, impl):
    """The whole layer from the router on, shared expert included; each
    side routes by its own probabilities, which choose the same experts
    here (the test above prints the smallest gap)."""
    ref_cfg, cfg, p_np, p, x = _setup(arch)
    ref_cfg = dataclasses.replace(ref_cfg, moe_impl=impl)
    cfg = dataclasses.replace(cfg, moe_impl=impl)
    y, aux = moe.moe_forward(p, torch.from_numpy(x), cfg)
    ry, raux = ref_moe.moe_forward(jax.tree.map(jnp.asarray, p_np),
                                   jnp.asarray(x), ref_cfg)
    _close(y, ry, "moe_forward y", 1e-6)
    _close(aux, raux, "moe_forward aux", 1e-6)


@pytest.mark.parametrize("arch", ARCHS)
def test_lanes_of_a_moe_model_run_each_lane_on_its_own_weights(arch):
    """Per-lane (personalized) weights of the MoE and MLA models: batch row
    b of a laned ``forward`` and ``prefill`` is lane b's model run alone
    (its own router and experts, capacity per row), to 1e-5 of the logits'
    magnitude, and the aux loss is per lane.  The reference's lanes are
    ``tests/test_torch_lanes_moe.py``'s."""
    from repro_torch.models.registry import get_model_api
    from repro_torch.core.flat import tree_map

    api = get_model_api(registry.get_config(arch, smoke=True))
    ps = [api.init(torch.Generator().manual_seed(i)) for i in range(2)]
    lanes = tree_map(lambda *ts: torch.stack(ts), *ps)
    tokens = torch.from_numpy(np.random.default_rng(2).integers(
        0, api.cfg.vocab_size, (2, 8))).to(torch.int32)
    with torch.no_grad():
        logits, aux = api.forward(lanes, {"tokens": tokens})
        pre, _ = api.prefill(lanes, {"tokens": tokens}, 10)
        assert tuple(aux["moe_aux"].shape) == (2,)
        for b in range(2):
            one, one_aux = api.forward(ps[b], {"tokens": tokens[b:b + 1]})
            _close(logits[b:b + 1], one, f"lane {b} forward", 1e-5)
            _close(aux["moe_aux"][b], one_aux["moe_aux"], f"lane {b} aux",
                   1e-6)
            _close(pre[b:b + 1], api.prefill(ps[b], {"tokens": tokens[b:b + 1]},
                                             10)[0], f"lane {b} prefill", 1e-5)
