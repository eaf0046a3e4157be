"""The port's xLSTM block kind (xlstm-350m) against the JAX reference on the
CPU, at ``reduced`` size (f32, d_model 256, 4 heads: mLSTM hd 128, sLSTM
hd 64) as 1 group of [1 mLSTM, 1 sLSTM] (``smoke``) and as 2 groups of
[2 mLSTM, 1 sLSTM] (``n_layers=6, slstm_every=3``, so that the ``(groups,
n_m)`` stacking of the parameters and the decode state is exercised):
the mLSTM cell in its parallel and recurrent forms, the sLSTM block over a
sequence and as one step, ``forward``, ``loss`` and its gradient,
``prefill`` and ``decode_step`` with the reference's cache tree, the
serving and training entry points, and a pods-as-clients round.

Parameters come from the reference's own ``init`` through
``repro_torch.interop.params_from_numpy``; inputs from the same numpy
draws.

Tolerances: both sides compute in f32 with their sums in their own orders.
The cells' outputs and states to 1e-5 of their magnitude; logits and
decode states to 1e-4 (as the other model files); the loss to 1e-6
relative.  The gradient and the pod round are ill-conditioned at random
init: the mLSTM denominator ``max(|q . n|, exp(-m))`` takes its floor on
about half the rows, so near-ties switch branch, and the reference's own
gradient moves by 1.6e-4 of a leaf's magnitude when its parameters are
scaled by 1 + 1e-7 (2 groups), its round's params and momentum by up to
2% under 1e-6 noise.  So each gradient, params and momentum leaf is held
to 1e-5 of its largest magnitude or to twice what the reference's own leaf
moves under 1e-6 noise, whichever is larger
(``_torch_blocks.drifts``; the port measured at most 0.6 of that drift),
the round's loss to 1e-5 relative and its accuracy to one token a step.
``prefill`` (the recurrent form from the zero state) and ``forward`` (the
parallel form) differ by design where the exp(-m) floor binds; on these
inputs they agree to 1e-4.
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
from repro.models import xlstm as ref_xlstm
from repro.models.registry import get_model_api as ref_get_model_api
from repro_torch.configs import base, registry
from repro_torch.core.flat import tree_map
from repro_torch.launch import serve, train
from repro_torch.models import xlstm
from repro_torch.models.registry import get_model_api

ARCH = "xlstm-350m"
B, S, NEW = 2, 24, 4
# (n_layers, slstm_every) of the reduced configs: 1 group of [1 mLSTM,
# 1 sLSTM], and 2 groups of [2 mLSTM, 1 sLSTM].
SHAPES = {"smoke": {}, "two_groups": dict(n_layers=6, slstm_every=3)}

_CACHE: dict = {}


def _configs(shape):
    kw = SHAPES[shape]
    ref_cfg = ref_base.reduced(ref_registry.get_config(ARCH), **kw)
    cfg = base.reduced(registry.get_config(ARCH), **kw)
    return ref_cfg, cfg


def _setup(shape="smoke"):
    if shape not in _CACHE:
        ref_cfg, cfg = _configs(shape)
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
        assert n == 519_430_304
        assert xlstm._groups(cfg) == (5, 4, 1)


def _cell_inputs(case, seed=0):
    """q, k, v (B, S, H, hd) and gate pre-activations (B, S, H).  "plain":
    input gates near 3, so the exp(-m) floor of the denominator rarely
    binds; "floor": near -6, so it binds on most rows; "overflow": near
    -100, so exp(-m) overflows f32 and the output is 0."""
    rng = np.random.default_rng(seed)
    b, s, h, hd = 2, 9, 3, 16
    q, k, v = (rng.standard_normal((b, s, h, hd)).astype(np.float32)
               for _ in range(3))
    i_pre = rng.standard_normal((b, s, h)).astype(np.float32)
    f_pre = (rng.standard_normal((b, s, h)) + 2.0).astype(np.float32)
    if case == "plain":
        i_pre += 3.0
    elif case == "floor":
        i_pre -= 6.0
    elif case == "overflow":
        i_pre -= 100.0
    return q, k, v, i_pre, f_pre


@pytest.mark.parametrize("case", ["plain", "floor", "overflow"])
def test_mlstm_parallel_matches_the_reference(case):
    args = _cell_inputs(case)
    want = np.asarray(ref_xlstm.mlstm_parallel(*map(jnp.asarray, args)))
    got = xlstm.mlstm_parallel(*(torch.from_numpy(a) for a in args))
    assert got.dtype == torch.float32
    if case == "overflow":
        assert not want.any() and not got.any()
        return
    close(got, want, "mlstm_parallel", 1e-5)
    # The share of rows where the floor binds (both packages then take it).
    q, k, _, i_pre, f_pre = args
    lf = -np.log1p(np.exp(-f_pre))
    F_cum = np.cumsum(lf, 1)
    D = F_cum[:, :, None] - F_cum[:, None] + i_pre[:, None]
    D = np.where(np.tril(np.ones((9, 9), bool))[None, :, :, None], D, -np.inf)
    m = D.max(2)
    sw = np.einsum("bthd,bshd->btsh", q, k) / 4.0 * np.exp(D - m[:, :, None])
    share = float((np.exp(-m) > np.abs(sw.sum(2))).mean())
    assert share >= 0.9 if case == "floor" else share <= 0.1, share


@pytest.mark.parametrize("case", ["plain", "floor"])
def test_mlstm_step_matches_the_reference(case):
    q, k, v, i_pre, f_pre = (a[:, 0] for a in _cell_inputs(case, seed=1))
    rng = np.random.default_rng(2)
    b, h, hd = q.shape
    state = (rng.standard_normal((b, h, hd, hd)).astype(np.float32),
             rng.standard_normal((b, h, hd)).astype(np.float32),
             rng.standard_normal((b, h)).astype(np.float32))
    (rC, rn, rm), want = ref_xlstm.mlstm_step(
        tuple(map(jnp.asarray, state)),
        *map(jnp.asarray, (q, k, v, i_pre, f_pre)))
    (C, n, m), got = xlstm.mlstm_step(
        tuple(torch.from_numpy(a) for a in state),
        *(torch.from_numpy(a) for a in (q, k, v, i_pre, f_pre)))
    for g, w, what in ((got, want, "h"), (C, rC, "C"), (n, rn, "n"),
                       (m, rm, "m")):
        close(g, w, f"mlstm_step {what}", 1e-5)
    if case == "floor":  # exp(-m_new) is the denominator somewhere
        q32 = q.astype(np.float64)
        qn = np.abs(np.einsum("bhd,bhd->bh", q32, np.asarray(rn)))
        assert (np.exp(-np.asarray(rm)) > qn).any()


@pytest.mark.parametrize("mode", ["sequence", "step"])
def test_slstm_block_matches_the_reference(mode):
    ref_api, api, ref_params, params, _ = _setup()
    cfg, ref_cfg = api.cfg, ref_api.cfg
    rng = np.random.default_rng(3)
    s = 17 if mode == "sequence" else 1
    x = rng.standard_normal((B, s, cfg.d_model)).astype(np.float32)
    ref_pl = jax.tree.map(lambda t: t[0, 0], ref_params["slstm"])
    pl = {k: t[0, 0] for k, t in params["slstm"].items()}
    state = ref_state = None
    if mode == "step":
        h, hd = cfg.n_heads, cfg.d_model // cfg.n_heads
        st = [rng.standard_normal((B, h, hd)).astype(np.float32)
              for _ in range(4)]
        st[1] = np.abs(st[1]) + 0.5  # n > 0
        ref_state = tuple(map(jnp.asarray, st))
        state = tuple(torch.from_numpy(a) for a in st)
    want, want_st = jax.jit(lambda p, x, st: ref_xlstm._slstm_block(
        p, x, ref_cfg, st))(ref_pl, jnp.asarray(x), ref_state)
    got, got_st = xlstm._slstm_block(pl, torch.from_numpy(x), cfg, state)
    close(got, want, f"sLSTM block ({mode})", 1e-5)
    if mode == "step":
        for g, w, name in zip(got_st, want_st, "cnmh"):
            close(g, w, f"sLSTM state {name}", 1e-5)


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_forward_and_loss_match_the_reference(shape):
    ref_api, api, ref_params, params, toks = _setup(shape)
    with torch.no_grad():
        logits, aux = api.forward(params, {"tokens": torch.from_numpy(toks)})
        loss, (ce, acc) = api.loss(params, {"tokens": torch.from_numpy(toks)})
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
    # Every block of every group gets a gradient of its own.
    g = grads["mlstm", "wq"]
    n_m, groups, _ = xlstm._groups(api.cfg)
    assert tuple(g.shape[:2]) == (groups, n_m)
    assert all(float(g[i, j].abs().max()) > 0 for i in range(groups)
               for j in range(n_m))
    assert float(grads["slstm", "r"].abs().max()) > 0


def _decode(api, params, toks, new):
    """Prefill, then ``new`` decode steps on the reference's greedy tokens
    -> (the logits of each, the cache)."""
    with torch.no_grad():
        logits, cache = api.prefill(params, {"tokens": torch.from_numpy(toks)},
                                    toks.shape[1] + len(new))
        out = [logits]
        for i, tok in enumerate(new):
            lg, cache = api.decode_step(params, cache, torch.from_numpy(tok),
                                        toks.shape[1] + i)
            out.append(lg[:, None])
    return torch.cat(out, 1), cache


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_prefill_and_decode_match_the_reference(shape):
    ref_api, api, ref_params, params, toks = _setup(shape)
    ref_logits, ref_cache = ref_api.prefill(
        ref_params, {"tokens": jnp.asarray(toks)}, S + NEW)
    want, new = [np.asarray(ref_logits)], []
    for i in range(NEW):
        tok = jnp.argmax(want[-1][:, -1], -1).astype(jnp.int32)
        new.append(np.asarray(tok))
        lg, ref_cache = ref_api.decode_step(ref_params, ref_cache, tok,
                                            jnp.int32(S + i))
        want.append(np.asarray(lg)[:, None])
    got, cache = _decode(api, params, toks, new)
    close(got, np.concatenate(want, 1), "prefill and decode logits", 1e-4)
    ref_cache = jax.device_get(ref_cache)
    defs = ref_api.cache_defs(B, S + NEW)
    assert list(cache) == list(defs) and sorted(ref_cache) == sorted(defs)
    for k, d in defs.items():
        assert tuple(cache[k].shape) == tuple(d.shape), k
        assert cache[k].dtype == torch.float32
        close(cache[k], ref_cache[k], f"cache {k}", 1e-4)


def test_prefill_agrees_with_forward():
    """The recurrent prefill from the zero state against the parallel
    forward: the reference's own test allows 1e-4 / 1e-5 on the cell; the
    logits here agree to 1e-4 of their magnitude."""
    _, api, _, params, toks = _setup("two_groups")
    with torch.no_grad():
        fwd, _ = api.forward(params, {"tokens": torch.from_numpy(toks)})
        pre, _ = api.prefill(params, {"tokens": torch.from_numpy(toks)}, S)
    close(pre, fwd.numpy(), "prefill against forward", 1e-4)


def _block_order(t, h, hd):
    """The mutant: the four gates read as four contiguous blocks."""
    return t.reshape(t.shape[:-1] + (4, h, hd)).movedim(-3, -1)


def test_gates_read_in_block_order_miss_the_tolerance(monkeypatch):
    """A port that splits the sLSTM's 4d gates into four contiguous blocks
    runs, but computes another model: its logits leave the reference's by
    far more than the tolerance."""
    ref_api, api, ref_params, params, toks = _setup()
    want = np.asarray(ref_api.forward(ref_params,
                                      {"tokens": jnp.asarray(toks)})[0])
    monkeypatch.setattr(xlstm, "_gates", _block_order)
    with torch.no_grad():
        got, _ = api.forward(params, {"tokens": torch.from_numpy(toks)})
    err = rel_err(got, want)
    assert err > 100 * 1e-4, err


def test_serve_main_runs_on_the_cpu(capsys):
    rec = serve.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                      "--batch", "2", "--prompt-len", "10", "--new-tokens",
                      "4"])
    assert rec["finite"] and tuple(rec["tokens"].shape) == (2, 4)
    assert rec["n_prefix"] == 0 and rec["steps"] == 3
    assert "[serve] prefill 2x10" in capsys.readouterr().out
    # The logits each token was picked from are the parallel forward's.
    batch = rec["batch"]
    ext = torch.cat([batch["tokens"], rec["tokens"][:, :-1]], 1)
    with torch.no_grad():
        want = rec["api"].forward(rec["params"], {"tokens": ext})[0][:, 9:]
    close(rec["logits"], want.numpy(), "generate against forward", 1e-4)


def test_pod_round_matches_the_reference():
    """Two rounds of 2 pods, K = 2 local steps of 2 x 16 tokens, each
    restarted from the reference's state."""
    ref_api, api, ref_params = _setup()[:3]
    toks = tokens(ref_api.cfg, 2 * 2 * 2 * B, 16, seed=5)
    losses = pod_round_parity(ref_api, api, ref_params,
                              toks.reshape(2, 2, 2, B, 16), 1e-5)
    assert all(np.isfinite(losses))


def test_a_bare_training_cli_run_trains_xlstm():
    """``python -m repro_torch.launch.train --smoke --device cpu --rounds
    1``: the launcher's default arch is xlstm-350m, as the reference's."""
    assert train.build_parser().parse_args([]).arch == ARCH
    out = run_module("repro_torch.launch.train", "--smoke", "--device", "cpu",
                     "--rounds", "1")
    assert "[train] xlstm-350m | 2 pods on cpu" in out
    assert "w_mass=2.0000" in out


def test_personalized_lanes_run_each_lane_on_its_own_weights():
    """Lane b of a laned ``prefill`` and ``forward`` is lane b's model run
    alone, to 1e-5 of the logits' magnitude.  The reference's lanes are
    ``tests/test_torch_lanes_blocks.py``'s."""
    _, api, _, params, toks = _setup()
    other = tree_map(lambda t: t * 0.9, params)
    stacked = tree_map(lambda *ts: torch.stack(ts), params, other)
    tk = torch.from_numpy(toks)
    with torch.no_grad():
        pre, _ = api.prefill(stacked, {"tokens": tk}, S)
        fwd, _ = api.forward(stacked, {"tokens": tk})
        for b, p in enumerate((params, other)):
            one = {"tokens": tk[b:b + 1]}
            close(pre[b:b + 1], api.prefill(p, one, S)[0].numpy(),
                  f"lane {b} prefill", 1e-5)
            close(fwd[b:b + 1], api.forward(p, one)[0].numpy(),
                  f"lane {b} forward", 1e-5)
