"""The port's ``vlm`` task (llava-next-mistral-7b) against the JAX reference
on the CPU, at ``reduced`` size (f32, 2 layers, d_model 256, 4 heads on 2
kv heads of hd 64, 16 image embeddings of dim 64 at most): the config and
its parameter count, ``make_batch``'s arrays, ``embed_inputs`` (the
projector MLP's image rows before the text embeddings), ``forward``,
``loss`` (next-token over the text only) and its gradient with respect to
every leaf, projector and decoder alike; then prefill with the image
prefix and greedy decode on a cache sized to prefix + prompt + new tokens,
against the reference's own ``prefill`` / ``decode_step`` on a cache of the
same size, and ``serve.generate`` against the reference's ``forward`` on
the extended sequence.

The last test shows the reference's serving defect (ROADMAP §3): its
``launch/serve.py`` sizes the cache as prompt + new tokens, leaving out the
image prefix, yet decodes at prefix + prompt + i, so every decode position
lies past the cache and ``dynamic_update_slice`` clamps it onto the last
slot.  On such a cache the reference's own decode leaves its ``forward``
on the extended sequence; on a prefix-sized cache it follows it.

Parameters come from the reference's own ``init`` and cross by
``repro_torch.interop.params_from_numpy``; inputs come from the same numpy
draws in both packages.

Tolerance: both sides compute in f32 with their sums in their own orders:
activations and logits to 1e-4 of their magnitude, the loss to 1e-6
relative, every gradient to 1e-5 of its leaf's largest magnitude (as
``tests/test_torch_train_step.py``); greedy tokens equal.
"""
import dataclasses
import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as ref_registry
from repro.models import transformer as ref_transformer
from repro.models.registry import get_model_api as ref_get_model_api
from repro_torch.configs import registry
from repro_torch.core.flat import tree_flatten, tree_map
from repro_torch.interop import params_from_numpy
from repro_torch.kernels import flash_attention as fa
from repro_torch.launch import serve
from repro_torch.models import transformer
from repro_torch.models.registry import get_model_api

ARCH = "llava-next-mistral-7b"
B, SEQ, NEW = 2, 40, 5  # 16 image embeddings (the reduced cap) + 24 tokens

_CACHE: dict = {}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this file's small tensors (the suite runs
    files in parallel workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _setup():
    """(reference api, port api, reference params as numpy, port params,
    the batch as numpy), built once."""
    if not _CACHE:
        ref_api = ref_get_model_api(ref_registry.get_config(ARCH, smoke=True))
        api = get_model_api(registry.get_config(ARCH, smoke=True))
        ref_params = jax.device_get(ref_api.init(jax.random.PRNGKey(0)))
        batch = {k: np.asarray(v) for k, v in ref_registry.make_batch(
            ref_api.cfg, B, SEQ, seed=1).items()}
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


@pytest.mark.parametrize("smoke", [False, True])
def test_config_and_parameter_count_match_the_reference(smoke):
    ref_cfg = ref_registry.get_config(ARCH, smoke=smoke)
    cfg = registry.get_config(ARCH, smoke=smoke)
    assert _fields(cfg) == _fields(ref_cfg)
    assert str(cfg.dtype).split(".")[-1] == jnp.dtype(ref_cfg.dtype).name
    assert cfg.task == "vlm" and ARCH in registry.PORTED_ARCH_IDS
    assert (get_model_api(cfg).num_params()
            == ref_get_model_api(ref_cfg).num_params())
    if not smoke:  # 7.26 B parameters at full width
        assert 7.2e9 < get_model_api(cfg).num_params() < 7.3e9


@pytest.mark.parametrize("seq", [1, 2, 9, 40, 5760])
def test_make_batch_draws_the_reference_arrays(seq):
    """The image prefix takes min(n_frontend_tokens, max(seq // 2, 1))
    positions: all 2880 anyres embeddings at the full config's 5760."""
    smoke = seq != 5760
    cfg = registry.get_config(ARCH, smoke=smoke)
    ref_cfg = ref_registry.get_config(ARCH, smoke=smoke)
    b = 3 if smoke else 1
    got = registry.make_batch(cfg, b, seq, seed=7)
    want = ref_registry.make_batch(ref_cfg, b, seq, seed=7)
    assert list(got) == list(want) == ["tokens", "image_feats"]
    n_img = min(cfg.n_frontend_tokens, max(seq // 2, 1))
    assert tuple(got["image_feats"].shape) == (b, n_img, cfg.frontend_dim)
    assert tuple(got["tokens"].shape) == (b, seq - n_img)
    assert got["tokens"].dtype == torch.int32
    assert got["image_feats"].dtype == torch.float32
    for k in got:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


def test_embed_inputs_put_the_projected_image_before_the_text():
    ref_api, api, ref_params, params, batch = _setup()
    x, mask = transformer.embed_inputs(params, _torch_batch(batch), api.cfg)
    rx, rmask = ref_transformer.embed_inputs(ref_params, _jax_batch(batch),
                                             ref_api.cfg)
    n_img = batch["image_feats"].shape[1]
    assert tuple(x.shape) == (B, SEQ, api.cfg.d_model)
    _close(x, rx, "embed_inputs")
    np.testing.assert_array_equal(mask.numpy(), np.asarray(rmask))
    assert float(mask[:, :n_img].sum()) == 0.0
    assert float(mask[:, n_img:].min()) == 1.0


def test_forward_and_loss_match_the_reference():
    ref_api, api, ref_params, params, batch = _setup()
    with torch.no_grad():
        logits, aux = api.forward(params, _torch_batch(batch))
        loss, (ce, acc) = api.loss(params, _torch_batch(batch))
    ref_logits, ref_aux = ref_api.forward(ref_params, _jax_batch(batch))
    ref_loss, (ref_ce, ref_acc) = ref_api.loss(ref_params, _jax_batch(batch))
    assert tuple(logits.shape) == (B, SEQ, api.cfg.padded_vocab)
    _close(logits, ref_logits, "forward logits")
    np.testing.assert_array_equal(aux["loss_mask"].numpy(),
                                  np.asarray(ref_aux["loss_mask"]))
    assert float(loss) == pytest.approx(float(ref_loss), rel=1e-6)
    assert float(ce) == pytest.approx(float(ref_ce), rel=1e-6)
    assert float(acc) == float(ref_acc)


def test_loss_skips_the_image_positions():
    """Next-token cross entropy over the text alone: the logits at text
    positions 0..St-2 against text tokens 1..St-1."""
    _, api, _, params, batch = _setup()
    tb = _torch_batch(batch)
    n_img = batch["image_feats"].shape[1]
    with torch.no_grad():
        logits, _ = api.forward(params, tb)
        loss, _ = api.loss(params, tb)
    lp = torch.log_softmax(logits[:, n_img:-1].float(), -1)
    want = -lp.gather(-1, tb["tokens"][:, 1:, None].long()).mean()
    assert float(loss) == pytest.approx(float(want), rel=1e-6)


def test_loss_gradient_matches_jax_value_and_grad():
    """Every leaf, the projector's w1 and w2 as the decoder's."""
    ref_api, api, ref_params, _, batch = _setup()
    (ref_l, _), ref_g = jax.value_and_grad(ref_api.loss, has_aux=True)(
        ref_params, _jax_batch(batch))
    params = params_from_numpy(ref_params)
    paths, leaves = tree_flatten(params)
    for x in leaves:
        x.requires_grad_(True)
    loss, _ = api.loss(params, _torch_batch(batch))
    grads = torch.autograd.grad(loss, leaves)
    assert float(loss.detach()) == pytest.approx(float(ref_l), rel=1e-6)
    ref_g = jax.device_get(ref_g)
    for path, g in zip(paths, grads):
        want = ref_g
        for k in path:
            want = want[k]
        _close(g, want, f"grad {'.'.join(path)}", rel=1e-5)
    by_path = {tuple(p): g for p, g in zip(paths, grads)}
    assert float(by_path["projector", "w1"].abs().max()) > 0


def _ref_decode(ref_api, ref_params, batch, cache_len, new, pos0):
    """The reference's prefill on ``cache_len``, then ``new - 1`` greedy
    decode steps at pos0 + i -> (logits each token was picked from (B, new,
    V), tokens (B, new), the final cache)."""
    logits, cache = jax.jit(lambda p, b: ref_api.prefill(p, b, cache_len))(
        ref_params, _jax_batch(batch))
    step = jax.jit(ref_api.decode_step)
    last = [logits[:, -1]]
    tok = jnp.argmax(last[0], -1).astype(jnp.int32)
    toks = [tok]
    for i in range(new - 1):
        lg, cache = step(ref_params, cache, tok, jnp.int32(pos0 + i))
        last.append(lg)
        tok = jnp.argmax(lg, -1).astype(jnp.int32)
        toks.append(tok)
    return (np.asarray(jnp.stack(last, 1)), np.asarray(jnp.stack(toks, 1)),
            jax.device_get(cache))


def test_prefill_and_decode_on_a_prefix_sized_cache_match_the_reference():
    ref_api, api, ref_params, params, batch = _setup()
    n_img, s = batch["image_feats"].shape[1], batch["tokens"].shape[1]
    cache_len = n_img + s + NEW
    want, want_toks, ref_cache = _ref_decode(ref_api, ref_params, batch,
                                             cache_len, NEW, n_img + s)
    with torch.no_grad():
        logits, cache = api.prefill(params, _torch_batch(batch), cache_len)
        assert tuple(cache["k"].shape[:3]) == (api.cfg.n_layers, B, cache_len)
        last = [logits[:, -1]]
        tok = last[0].argmax(-1).to(torch.int32)
        toks = [tok]
        for i in range(NEW - 1):
            lg, cache = api.decode_step(params, cache, tok, n_img + s + i)
            last.append(lg)
            tok = lg.argmax(-1).to(torch.int32)
            toks.append(tok)
    _close(torch.stack(last, 1), want, "prefill and decode logits")
    np.testing.assert_array_equal(torch.stack(toks, 1).numpy(), want_toks)
    for n in ("k", "v"):
        _close(cache[n], ref_cache[n], f"cache {n}")


def test_prefill_refuses_a_cache_without_room_for_the_prefix():
    _, api, _, params, batch = _setup()
    s = batch["tokens"].shape[1]
    with torch.no_grad(), pytest.raises(ValueError, match="image prefix"):
        api.prefill(params, _torch_batch(batch), s + NEW)


def test_generate_follows_the_reference_forward_on_the_extended_sequence(
        capsys):
    """``serve.generate`` sizes the cache to the prefix and decodes after
    it: the logits each new token was picked from are the reference's
    ``forward`` on the image prefix, the prompt and the new tokens."""
    ref_api, api, ref_params, params, batch = _setup()
    before = fa.launches
    out = serve.generate(api, params, _torch_batch(batch), NEW)
    assert fa.launches == before  # the CPU runs the plain version
    n_img, s = batch["image_feats"].shape[1], batch["tokens"].shape[1]
    assert out["n_prefix"] == n_img and out["steps"] == NEW - 1
    assert f"after {n_img} image embeddings" in capsys.readouterr().out
    ext = dict(batch, tokens=np.concatenate(
        [batch["tokens"], out["tokens"][:, :-1].numpy()], 1))
    ref_logits, _ = ref_api.forward(ref_params, _jax_batch(ext))
    _close(out["logits"], np.asarray(ref_logits)[:, n_img + s - 1:],
           "generated logits against forward")


def test_serve_main_serves_the_vlm_with_eight_image_embeddings(capsys):
    """The reference launcher's batch: 8 image embeddings per request
    beside ``--prompt-len`` tokens, here drawn with numpy from seed + 2."""
    rec = serve.main(["--device", "cpu", "--arch", ARCH, "--batch", "2",
                      "--prompt-len", "12", "--new-tokens", "3", "--seed", "4"])
    cfg = rec["api"].cfg
    assert tuple(rec["batch"]["image_feats"].shape) == (2, serve.N_IMAGE,
                                                        cfg.frontend_dim)
    assert tuple(rec["batch"]["tokens"].shape) == (2, 12)
    np.testing.assert_array_equal(
        rec["batch"]["image_feats"].numpy(),
        np.random.default_rng(6).standard_normal((2, 8, cfg.frontend_dim))
        .astype(np.float32))
    assert rec["n_prefix"] == 8 and rec["finite"]
    assert tuple(rec["tokens"].shape) == (2, 3)
    assert "[serve] prefill 2x12 after 8 image embeddings" in capsys.readouterr().out


def test_personalized_lanes_of_the_vlm_run_each_lane_on_its_own_weights():
    """Lane b of a laned prefill (its own projector and decoder, its image
    prefix in the cache) is lane b's model run alone, to 1e-5 of the
    logits' magnitude; ``serve.main --clients`` serves the vlm.  The
    reference's lanes are ``tests/test_torch_lanes_tasks.py``'s."""
    _, api, _, params, batch = _setup()
    other = tree_map(lambda t: t * 0.9, params)
    stacked = tree_map(lambda *ts: torch.stack(ts), params, other)
    tb = _torch_batch(batch)
    with torch.no_grad():
        logits, _ = api.prefill(stacked, tb, SEQ + NEW)
        for b, p in enumerate((params, other)):
            one, _ = api.prefill(p, {k: v[b:b + 1] for k, v in tb.items()},
                                 SEQ + NEW)
            _close(logits[b:b + 1], one, f"lane {b} prefill", 1e-5)
    rec = serve.main(["--device", "cpu", "--arch", ARCH, "--clients", "2",
                      "--rank", "2", "--prompt-len", "6", "--new-tokens", "2"])
    assert rec["n_prefix"] == 8 and rec["finite"]
    assert tuple(rec["tokens"].shape) == (2, 2)


def test_the_reference_serve_sized_cache_diverges():
    """The reference's defect, on its own functions, at the reference
    launcher's proportions (8 image embeddings before 8 prompt tokens, 8
    new tokens): a cache of prompt + new tokens holds the prefill's 16
    positions exactly, and decoding at prefix + prompt + i clamps every
    step onto the last slot, so the decoded logits leave the reference's
    ``forward`` on the extended sequence; the prefix-sized cache follows
    it."""
    ref_api, _, ref_params = _setup()[:3]
    batch = {k: np.asarray(v) for k, v in ref_registry.make_batch(
        ref_api.cfg, B, 16, seed=3).items()}
    n_img, s, new = batch["image_feats"].shape[1], batch["tokens"].shape[1], 8
    assert (n_img, s) == (8, 8)
    errs = {}
    for name, cache_len in (("serve", s + new), ("prefix", n_img + s + new)):
        got, toks, _ = _ref_decode(ref_api, ref_params, batch, cache_len, new,
                                   n_img + s)
        ext = dict(batch, tokens=np.concatenate([batch["tokens"],
                                                 toks[:, :-1]], 1))
        want = np.asarray(ref_api.forward(ref_params, _jax_batch(ext))[0])
        want = want[:, n_img + s - 1:]
        errs[name] = float(np.abs(got - want).max()) / float(np.abs(want).max())
    assert errs["prefix"] <= 1e-4, errs
    assert errs["serve"] > 1e-2, errs


def _example():
    path = pathlib.Path(__file__).resolve().parents[1] / "examples" / \
        "serve_decode_torch.py"
    spec = importlib.util.spec_from_file_location("serve_decode_torch", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("arch", [None, ARCH])
def test_the_serve_decode_example_runs_on_the_cpu(arch, capsys):
    """``examples/serve_decode_torch.py`` at its default, reduced size, and
    with the vlm, whose cache holds its 8 image embeddings too."""
    argv = ["--device", "cpu"] + ([] if arch is None else ["--arch", arch])
    rec = _example().main(argv)
    out = capsys.readouterr().out
    assert tuple(rec["tokens"].shape) == (4, 8) and rec["finite"]
    n_prefix = 8 if arch else 0
    assert rec["n_prefix"] == n_prefix
    assert f"cache {n_prefix + 12 + 8} positions" in out
