"""The port's hybrid block kind (hymba-1.5b) against the JAX reference on
the CPU, at ``reduced`` size (f32, 2 layers: layer 0 global, layer 1 a
32-token window; 8 meta tokens; d_inner 2 d_model, SSM state 16) with 4
query heads on 2 kv heads (``smoke``) and with hymba's GQA group 5 (5 query
heads on 1 kv head, d_model 320, hd 64: ``group5``): the SSM scan over a
sequence and as one step, ``forward``, ``loss`` and its gradient,
``prefill`` and ``decode_step`` with the reference's cache tree, decode
against ``forward``, the serving entry point and a pods-as-clients round.
The meta tokens and a prompt of 40 tokens make 48 positions, so the window
closes the meta tokens to the last text rows of layer 1.

Parameters come from the reference's own ``init`` through
``repro_torch.interop.params_from_numpy``; inputs from the same numpy
draws.  The port's attention core is ``ops.flash_attention`` (on the CPU,
the kernel's plain version), the reference's ``_dot_attn``.

Tolerances: both sides compute in f32 with their sums in their own orders.
The SSM scan sums in a tree order on both sides but not the same tree
(Hillis-Steele against ``associative_scan``'s), with decays in (0, 1):
its outputs and states to 1e-5 of their magnitude.  Logits, caches and
decode to 1e-4 (as the other model files); the loss to 1e-6 relative.
Each gradient leaf, and a pod round's params and momentum, to 1e-5 of the
leaf's largest magnitude or to twice what the reference's own leaf moves
when its parameters take f32-scale noise (``_torch_blocks.drifts``),
whichever is larger: the two packages measured up to 1.2e-5 apart on a
gradient leaf (the MLP's ``wo``) and on a round's momentum; the round's
loss to 1e-5 relative and its accuracy to one token a step.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_blocks import (  # noqa: F401  (one_thread is an autouse fixture)
    apis,
    close,
    grad_parity,
    one_thread,
    pod_round_parity,
    rel_err,
    run_module,
    tokens,
)

from repro.configs import base as ref_base
from repro.configs import registry as ref_registry
from repro.models import hymba as ref_hymba
from repro.models.registry import get_model_api as ref_get_model_api
from repro_torch.configs import base, registry
from repro_torch.core.flat import tree_map
from repro_torch.kernels import flash_attention as fa
from repro_torch.launch import serve
from repro_torch.models import hymba
from repro_torch.models.registry import get_model_api

ARCH = "hymba-1.5b"
B, S, NEW = 2, 40, 5
SHAPES = {"smoke": {},
          "group5": dict(n_heads=5, n_kv_heads=1, d_model=320)}

_CACHE: dict = {}
_DECODES: dict = {}


def _setup(shape="smoke"):
    if shape not in _CACHE:
        kw = SHAPES[shape]
        ref_cfg = ref_base.reduced(ref_registry.get_config(ARCH), **kw)
        cfg = base.reduced(registry.get_config(ARCH), **kw)
        _CACHE[shape] = apis(ref_cfg, cfg) + (tokens(ref_cfg, B, S),)
    return _CACHE[shape]


def _fields(cfg):
    return {k: v for k, v in dataclasses.asdict(cfg).items() if k != "dtype"}


@pytest.mark.parametrize("smoke", [False, True])
def test_config_and_parameter_count_match_the_reference(smoke):
    ref_cfg = ref_registry.get_config(ARCH, smoke=smoke)
    cfg = registry.get_config(ARCH, smoke=smoke)
    assert _fields(cfg) == _fields(ref_cfg)
    assert str(cfg.dtype).split(".")[-1] == jnp.dtype(ref_cfg.dtype).name
    n = get_model_api(cfg).num_params()
    assert n == ref_get_model_api(ref_cfg).num_params()
    if not smoke:
        assert n == 1_968_436_800
        windows = [cfg.window_for_layer(i) for i in range(cfg.n_layers)]
        assert [i for i, w in enumerate(windows) if w == 0] == [0, 15, 31]
        assert cfg.n_heads // cfg.n_kv_heads == 5


def test_group5_config_keeps_the_window_shorter_than_the_prompt():
    cfg = _setup("group5")[1].cfg
    assert (cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim) == (5, 1, 64)
    assert [cfg.window_for_layer(i) for i in range(2)] == [0, 32]
    assert cfg.sliding_window < cfg.n_meta_tokens + S


@pytest.mark.parametrize("mode", ["sequence", "step", "handoff"])
def test_ssm_scan_matches_the_reference(mode):
    """Over a sequence from h = 0 (a ragged length, 37), as one step from a
    state, and the handoff: the scan of the first 20 positions, then 17
    single steps from its final state, against the scan of all 37."""
    ref_api, api, ref_params, params, _ = _setup()
    cfg, ref_cfg = api.cfg, ref_api.cfg
    rng = np.random.default_rng(4)
    s = 1 if mode == "step" else 37
    xn = rng.standard_normal((B, s, cfg.d_model)).astype(np.float32)
    ref_pl = jax.tree.map(lambda t: t[0], ref_params["layers"]["ssm"])
    pl = {k: t[0] for k, t in params["layers"]["ssm"].items()}
    if mode == "step":
        st = rng.standard_normal((B, 2 * cfg.d_model,
                                  cfg.ssm_state)).astype(np.float32)
        want, want_h = jax.jit(lambda p, x, h: ref_hymba._ssm_scan(
            p, x, ref_cfg, h))(ref_pl, jnp.asarray(xn), jnp.asarray(st))
        got, got_h = hymba._ssm_scan(pl, torch.from_numpy(xn), cfg,
                                     torch.from_numpy(st))
    else:
        want, want_h = jax.jit(lambda p, x: ref_hymba._ssm_scan(
            p, x, ref_cfg))(ref_pl, jnp.asarray(xn))
        if mode == "sequence":
            got, got_h = hymba._ssm_scan(pl, torch.from_numpy(xn), cfg)
        else:
            x = torch.from_numpy(xn)
            y0, got_h = hymba._ssm_scan(pl, x[:, :20], cfg)
            ys = [y0]
            for t in range(20, s):
                y, got_h = hymba._ssm_scan(pl, x[:, t:t + 1], cfg, got_h)
                ys.append(y)
            got = torch.cat(ys, 1)
    assert tuple(got_h.shape) == (B, 2 * cfg.d_model, cfg.ssm_state)
    close(got, want, f"ssm y ({mode})", 1e-5)
    close(got_h, want_h, f"ssm final state ({mode})", 1e-5)


def test_scan_is_the_recurrence():
    """Hillis-Steele against the time loop h_t = a_t h_{t-1} + b_t, at
    lengths around the powers of two."""
    rng = np.random.default_rng(5)
    for s in (1, 2, 3, 4, 5, 8, 9, 16, 17):
        a = torch.from_numpy(rng.uniform(0.1, 1.0, (2, s, 3)))
        b = torch.from_numpy(rng.standard_normal((2, s, 3, 4)))
        h, want = torch.zeros(2, 3, 4, dtype=b.dtype), []
        for t in range(s):
            h = a[:, t, :, None] * h + b[:, t]
            want.append(h)
        torch.testing.assert_close(hymba._scan(a, b), torch.stack(want, 1),
                                   rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_forward_and_loss_match_the_reference(shape):
    ref_api, api, ref_params, params, toks = _setup(shape)
    before = fa.launches
    with torch.no_grad():
        logits, aux = api.forward(params, {"tokens": torch.from_numpy(toks)})
        loss, (ce, acc) = api.loss(params, {"tokens": torch.from_numpy(toks)})
    assert fa.launches == before  # the CPU runs the plain version
    ref_logits, _ = ref_api.forward(ref_params, {"tokens": jnp.asarray(toks)})
    ref_loss, (_, ref_acc) = ref_api.loss(ref_params,
                                          {"tokens": jnp.asarray(toks)})
    assert tuple(logits.shape) == (B, S, api.cfg.padded_vocab) and aux == {}
    close(logits, ref_logits, "forward logits", 1e-4)
    assert float(loss) == pytest.approx(float(ref_loss), rel=1e-6)
    assert float(ce) == float(loss) and float(acc) == float(ref_acc)


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_loss_gradient_matches_jax_value_and_grad(shape):
    ref_api, api, ref_params, _, toks = _setup(shape)
    grads = grad_parity(ref_api, api, ref_params, {"tokens": toks}, 1e-5)
    for path in (("meta_tokens",), ("layers", "attn", "wk"),
                 ("layers", "ssm", "A_log"), ("layers", "ssm", "w_B")):
        assert float(grads[path].abs().max()) > 0, path


def _ref_decode(ref_api, ref_params, toks, new):
    """The reference's prefill on S + new positions and ``new`` - 1 greedy
    decode steps -> (the logits each token was picked from, the tokens,
    the final cache, the prefill's logits), computed once a config."""
    key = (id(ref_params), new)
    if key not in _DECODES:
        _DECODES[key] = _ref_decode_run(ref_api, ref_params, toks, new)
    return _DECODES[key]


def _ref_decode_run(ref_api, ref_params, toks, new):
    logits, cache = ref_api.prefill(ref_params, {"tokens": jnp.asarray(toks)},
                                    toks.shape[1] + new)
    last = [np.asarray(logits)[:, -1]]
    toks_out = [np.argmax(last[0], -1).astype(np.int32)]
    for i in range(new - 1):
        lg, cache = ref_api.decode_step(ref_params, cache,
                                        jnp.asarray(toks_out[-1]),
                                        jnp.int32(toks.shape[1] + i))
        last.append(np.asarray(lg))
        toks_out.append(np.argmax(last[-1], -1).astype(np.int32))
    return (np.stack(last, 1), np.stack(toks_out, 1), jax.device_get(cache),
            np.asarray(logits))


def _port_decode(api, params, toks, new, pos_shift=0):
    with torch.no_grad():
        logits, cache = api.prefill(params, {"tokens": torch.from_numpy(toks)},
                                    toks.shape[1] + new)
        last = [logits[:, -1]]
        tok = last[0].argmax(-1).to(torch.int32)
        for i in range(new - 1):
            lg, cache = api.decode_step(params, cache, tok,
                                        toks.shape[1] + i + pos_shift)
            last.append(lg)
            tok = lg.argmax(-1).to(torch.int32)
    return torch.stack(last, 1), cache, logits


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_prefill_and_decode_match_the_reference(shape):
    ref_api, api, ref_params, params, toks = _setup(shape)
    want, want_toks, ref_cache, ref_pre = _ref_decode(ref_api, ref_params,
                                                      toks, NEW)
    got, cache, pre = _port_decode(api, params, toks, NEW)
    close(pre, ref_pre, "prefill logits", 1e-4)
    close(got, want, "decode logits", 1e-4)
    np.testing.assert_array_equal(got.argmax(-1).numpy(), want_toks)
    cfg = api.cfg
    defs = ref_api.cache_defs(B, S + NEW)
    assert list(cache) == ["k", "v", "ssm_h"]
    assert sorted(ref_cache) == sorted(defs) == sorted(cache)
    for k, d in defs.items():
        assert tuple(cache[k].shape) == tuple(d.shape), k
        close(cache[k], ref_cache[k], f"cache {k}", 1e-4)
    assert cache["k"].shape[2] == cfg.n_meta_tokens + S + NEW


def test_decode_follows_forward_on_the_extended_sequence():
    """``serve.generate`` (cache of prompt + new tokens, decode at S + i,
    the meta offset added by the module): the logits each new token was
    picked from are ``forward``'s on the prompt extended by the new
    tokens, at group 5 with the window closing the meta tokens."""
    _, api, _, params, toks = _setup("group5")
    out = serve.generate(api, params, {"tokens": torch.from_numpy(toks)},
                         NEW)
    assert out["n_prefix"] == 0 and out["finite"]
    ext = torch.cat([torch.from_numpy(toks), out["tokens"][:, :-1]], 1)
    with torch.no_grad():
        want = api.forward(params, {"tokens": ext})[0][:, S - 1:]
    close(out["logits"], want.numpy(), "generate against forward", 1e-4)


def test_decode_without_the_meta_offset_misses_the_tolerance():
    """The mutant: decode at the text position without the meta offset
    (the cache written and read n_meta positions early, the rope too).
    It still gives finite logits, far outside the tolerance."""
    ref_api, api, ref_params, params, toks = _setup("group5")
    want = _ref_decode(ref_api, ref_params, toks, NEW)[0]
    got = _port_decode(api, params, toks, NEW,
                       pos_shift=-api.cfg.n_meta_tokens)[0]
    assert torch.isfinite(got).all()
    err = rel_err(got[:, 1:], want[:, 1:])
    assert err > 100 * 1e-4, err


def test_prefill_refuses_a_cache_shorter_than_the_prompt():
    _, api, _, params, toks = _setup()
    with torch.no_grad(), pytest.raises(ValueError, match="cache_len"):
        api.prefill(params, {"tokens": torch.from_numpy(toks)}, S - 1)


def test_the_serving_cli_serves_hymba():
    """``python -m repro_torch.launch.serve --arch hymba-1.5b --smoke
    --device cpu``: 4 prompts of 12 tokens, 8 new tokens."""
    out = run_module("repro_torch.launch.serve", "--arch", ARCH, "--smoke",
                     "--device", "cpu")
    assert "[serve] prefill 4x12" in out and "[serve] 7 steps" in out


def test_pod_round_matches_the_reference():
    """Two rounds of 2 pods, K = 2 local steps of 2 x 16 tokens (24
    positions with the meta tokens), each restarted from the reference's
    state, at group 5."""
    ref_api, api, ref_params = _setup("group5")[:3]
    toks = tokens(ref_api.cfg, 2 * 2 * 2 * B, 16, seed=5)
    losses = pod_round_parity(ref_api, api, ref_params,
                              toks.reshape(2, 2, 2, B, 16), 1e-5)
    assert all(np.isfinite(losses))


def test_personalized_lanes_run_each_lane_on_its_own_weights():
    """Lane b of a laned ``prefill`` (its own meta tokens, SSM and
    attention) is lane b's model run alone, to 1e-5 of the logits'
    magnitude; ``serve.main --clients`` serves hymba.  The reference's
    lanes are ``tests/test_torch_lanes_blocks.py``'s."""
    _, api, _, params, toks = _setup()
    other = tree_map(lambda t: t * 0.9, params)
    stacked = tree_map(lambda *ts: torch.stack(ts), params, other)
    tk = torch.from_numpy(toks)
    with torch.no_grad():
        pre, _ = api.prefill(stacked, {"tokens": tk}, S)
        for b, p in enumerate((params, other)):
            close(pre[b:b + 1], api.prefill(p, {"tokens": tk[b:b + 1]},
                                            S)[0].numpy(),
                  f"lane {b} prefill", 1e-5)
    rec = serve.main(["--device", "cpu", "--arch", ARCH, "--clients", "2",
                      "--rank", "2", "--prompt-len", "6", "--new-tokens", "2"])
    assert tuple(rec["tokens"].shape) == (2, 2) and rec["finite"]
