"""The port's ``masked_lm`` task (hubert-xlarge's encoder) against the JAX
reference on the CPU, at ``reduced`` size widened to hubert's head dim:
``dataclasses.replace(reduced(cfg), d_model=320)`` gives 4 heads of hd 80
on 2 kv heads (``reduced`` alone gives hd 64), f32, 2 layers, a GELU MLP,
frames of dim 64.  Checked: the config and its parameter count (the full
0.945 B too), ``make_batch``'s arrays (features, then the 0.3 frame mask,
then the targets, from one numpy stream), ``sinusoidal_positions``,
``embed_inputs`` (``feats @ in_proj``, masked frames replaced by
``mask_emb``, positions added), ``forward``, ``loss`` (cross entropy at the
masked frames) and its gradient with respect to every leaf; that the
encoder attends both ways, as the reference's
``tests/test_models.py::test_encoder_attends_bidirectionally`` checks; and
that ``serve`` refuses it, as the reference does.

The attention core runs through ``ops.flash_attention`` at hd 80,
non-causal (on the CPU, the kernel's plain version; under autograd its
plain backward), the reference's through ``_dot_attn`` without a mask.

Tolerance: both sides compute in f32 with their sums in their own orders:
activations and logits to 1e-4 of their magnitude, the loss to 1e-6
relative, every gradient to 1e-5 of its leaf's largest magnitude (as
``tests/test_torch_train_step.py``); the position table to 4 f32 ulps of
its largest angle (each library's ``exp`` may put a frequency one ulp
apart, and positions up to 1500 carry that into angles of up to 1500 rad:
measured 1.2e-4); 80^-0.5 is no power of two, so the port's f32 scaling
of q and the reference's give scores a few f32 roundings apart, far
inside these.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as ref_base
from repro.configs import registry as ref_registry
from repro.models import layers as ref_layers
from repro.models import transformer as ref_transformer
from repro.models.registry import get_model_api as ref_get_model_api
from repro_torch.configs import base, registry
from repro_torch.core.flat import tree_flatten
from repro_torch.interop import params_from_numpy
from repro_torch.kernels import flash_attention as fa
from repro_torch.launch import serve
from repro_torch.models import layers, transformer
from repro_torch.models.registry import get_model_api

ARCH = "hubert-xlarge"
B, S = 2, 40

_CACHE: dict = {}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this file's small tensors (the suite runs
    files in parallel workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _configs():
    """(reference config, port config) at reduced size with hd 80."""
    return (dataclasses.replace(ref_base.reduced(ref_registry.get_config(ARCH)),
                                d_model=320),
            dataclasses.replace(base.reduced(registry.get_config(ARCH)),
                                d_model=320))


def _setup():
    """(reference api, port api, reference params as numpy, port params,
    the batch as numpy), built once."""
    if not _CACHE:
        ref_cfg, cfg = _configs()
        ref_api, api = ref_get_model_api(ref_cfg), get_model_api(cfg)
        ref_params = jax.device_get(ref_api.init(jax.random.PRNGKey(0)))
        batch = {k: np.asarray(v) for k, v in ref_registry.make_batch(
            ref_cfg, B, S, seed=1).items()}
        _CACHE["v"] = (ref_api, api, ref_params, params_from_numpy(ref_params),
                       batch)
    return _CACHE["v"]


def _torch_batch(batch):
    return {k: torch.from_numpy(v.copy()) for k, v in batch.items()}


def _jax_batch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _close(got, want, what, rel=1e-4):
    if isinstance(got, torch.Tensor):
        got = got.detach().float().numpy()
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= rel * scale, f"{what}: max|err| {err:.3e} > {rel} * {scale:.3e}"


def _fields(cfg):
    return {k: v for k, v in dataclasses.asdict(cfg).items() if k != "dtype"}


@pytest.mark.parametrize("size", ["full", "reduced", "hd80"])
def test_config_and_parameter_count_match_the_reference(size):
    if size == "hd80":
        ref_cfg, cfg = _configs()
    else:
        ref_cfg = ref_registry.get_config(ARCH, smoke=size == "reduced")
        cfg = registry.get_config(ARCH, smoke=size == "reduced")
    assert _fields(cfg) == _fields(ref_cfg)
    assert str(cfg.dtype).split(".")[-1] == jnp.dtype(ref_cfg.dtype).name
    assert cfg.task == "masked_lm" and not cfg.causal
    api = get_model_api(cfg)
    assert api.num_params() == ref_get_model_api(ref_cfg).num_params()
    assert "embed" not in api.param_defs()
    assert sorted(api.param_defs()) == sorted(
        ref_get_model_api(ref_cfg).param_defs())
    hd = {"full": 80, "reduced": 64, "hd80": 80}[size]
    assert cfg.resolved_head_dim == hd and hd in fa.HEAD_DIMS
    if size == "full":  # 48 layers of d_model 1280: 0.945 B parameters
        assert 0.94e9 < api.num_params() < 0.95e9


@pytest.mark.parametrize("seq", [1, 8, 40, 1500])
def test_make_batch_draws_the_reference_arrays(seq):
    """Features (f32), then the frame mask (``random() < 0.3``), then the
    targets (int32 below the vocabulary), from one numpy stream."""
    smoke = seq != 1500
    cfg = registry.get_config(ARCH, smoke=smoke)
    ref_cfg = ref_registry.get_config(ARCH, smoke=smoke)
    b = 3 if smoke else 1
    got = registry.make_batch(cfg, b, seq, seed=9)
    want = ref_registry.make_batch(ref_cfg, b, seq, seed=9)
    assert list(got) == list(want) == ["features", "mask", "targets"]
    assert tuple(got["features"].shape) == (b, seq, cfg.frontend_dim)
    assert got["features"].dtype == torch.float32
    assert got["mask"].dtype == torch.bool
    assert got["targets"].dtype == torch.int32
    assert int(got["targets"].max()) < cfg.vocab_size
    for k in got:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


@pytest.mark.parametrize("dim", [64, 320, 1280])
def test_sinusoidal_positions_match_the_reference(dim):
    pos = np.arange(1500)
    got = layers.sinusoidal_positions(torch.from_numpy(pos), dim)
    want = ref_layers.sinusoidal_positions(jnp.asarray(pos), dim)
    assert got.dtype == torch.float32 and tuple(got.shape) == (1500, dim)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=4 * np.finfo(np.float32).eps * 1500)


def test_embed_inputs_replace_masked_frames_and_add_positions():
    ref_api, api, ref_params, params, batch = _setup()
    x, mask = transformer.embed_inputs(params, _torch_batch(batch), api.cfg)
    rx, rmask = ref_transformer.embed_inputs(ref_params, _jax_batch(batch),
                                             ref_api.cfg)
    _close(x, rx, "embed_inputs")
    np.testing.assert_array_equal(mask.numpy(), np.asarray(rmask))
    np.testing.assert_array_equal(mask.numpy(), batch["mask"].astype(np.float32))
    # A masked frame's row is mask_emb plus its position, whatever its
    # features.
    b, t = map(int, np.argwhere(batch["mask"])[0])
    pos = layers.sinusoidal_positions(torch.arange(S), api.cfg.d_model)
    torch.testing.assert_close(x[b, t], params["mask_emb"] + pos[t])


def test_forward_and_loss_match_the_reference():
    ref_api, api, ref_params, params, batch = _setup()
    with torch.no_grad():
        logits, aux = api.forward(params, _torch_batch(batch))
        loss, (ce, acc) = api.loss(params, _torch_batch(batch))
    ref_logits, _ = ref_api.forward(ref_params, _jax_batch(batch))
    ref_loss, (ref_ce, ref_acc) = ref_api.loss(ref_params, _jax_batch(batch))
    assert tuple(logits.shape) == (B, S, api.cfg.padded_vocab)
    _close(logits, ref_logits, "forward logits")
    assert float(loss) == pytest.approx(float(ref_loss), rel=1e-6)
    assert float(ce) == pytest.approx(float(ref_ce), rel=1e-6)
    assert float(acc) == float(ref_acc)


def test_loss_is_the_cross_entropy_at_the_masked_frames():
    _, api, _, params, batch = _setup()
    tb = _torch_batch(batch)
    with torch.no_grad():
        logits, _ = api.forward(params, tb)
        loss, _ = api.loss(params, tb)
    lp = torch.log_softmax(logits.float(), -1)
    ll = lp.gather(-1, tb["targets"][..., None].long())[..., 0]
    want = -ll[tb["mask"]].mean()
    assert float(loss) == pytest.approx(float(want), rel=1e-6)


def test_loss_gradient_matches_jax_value_and_grad():
    """Every leaf: in_proj, mask_emb, lm_head, the encoder's layers (the
    attention core's gradient through the plain backward at hd 80)."""
    ref_api, api, ref_params, _, batch = _setup()
    (ref_l, _), ref_g = jax.value_and_grad(ref_api.loss, has_aux=True)(
        ref_params, _jax_batch(batch))
    params = params_from_numpy(ref_params)
    paths, leaves = tree_flatten(params)
    for x in leaves:
        x.requires_grad_(True)
    before = fa.backward_launches
    loss, _ = api.loss(params, _torch_batch(batch))
    grads = torch.autograd.grad(loss, leaves)
    assert fa.backward_launches == before  # the CPU runs the plain backward
    assert float(loss.detach()) == pytest.approx(float(ref_l), rel=1e-6)
    ref_g = jax.device_get(ref_g)
    for path, g in zip(paths, grads):
        want = ref_g
        for k in path:
            want = want[k]
        _close(g, want, f"grad {'.'.join(path)}", rel=1e-5)
    by_path = {tuple(p): g for p, g in zip(paths, grads)}
    assert float(by_path[("mask_emb",)].abs().max()) > 0


def test_the_encoder_attends_bidirectionally():
    """Changing the last frame moves the first position's logits (the
    reference's check); under a causal mask, the mutant that
    ``chip_smoke.py`` phase 14 runs, the same weights give other logits
    and the first position no longer sees the last frame."""
    _, api, _, params, batch = _setup()
    tb = _torch_batch(batch)
    moved = dict(tb, features=tb["features"].clone())
    moved["features"][:, -1] += 10.0
    causal = get_model_api(dataclasses.replace(api.cfg, causal=True))
    with torch.no_grad():
        logits = api.forward(params, tb)[0]
        logits2 = api.forward(params, moved)[0]
        logits_c = causal.forward(params, tb)[0]
        logits_c2 = causal.forward(params, moved)[0]
    assert not torch.allclose(logits[:, 0], logits2[:, 0])
    assert float((logits_c - logits).abs().max()) > 1e-2 * float(
        logits.abs().max())
    torch.testing.assert_close(logits_c2[:, 0], logits_c[:, 0])


def test_serve_refuses_the_encoder():
    """The reference's launcher exits for an encoder-only model, as
    ``tests/test_cli_drivers.py`` expects; so does the port's."""
    with pytest.raises(SystemExit, match="encoder-only"):
        serve.main(["--device", "cpu", "--arch", ARCH])


def test_personalized_lanes_of_the_encoder_run_each_lane_on_its_own_weights():
    """Lane b of a laned ``forward`` (its own ``in_proj``, ``mask_emb`` and
    encoder) is lane b's model run alone, to 1e-5 of the logits'
    magnitude.  The reference's lanes are
    ``tests/test_torch_lanes_tasks.py``'s."""
    _, api, _, params, batch = _setup()
    from repro_torch.core.flat import tree_map
    other = tree_map(lambda t: t * 0.9, params)
    stacked = tree_map(lambda *ts: torch.stack(ts), params, other)
    tb = _torch_batch(batch)
    with torch.no_grad():
        logits, _ = api.forward(stacked, tb)
        for b, p in enumerate((params, other)):
            one, _ = api.forward(p, {k: v[b:b + 1] for k, v in tb.items()})
            _close(logits[b:b + 1], one, f"lane {b} forward", 1e-5)
