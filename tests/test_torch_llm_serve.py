"""The port's serving path of the decoders against the JAX reference, on
the CPU at ``reduced`` size (f32, 2 layers, hd = 64): the four dense GQA
decoders, and the MoE decoders dbrx-132b (GQA, 4 experts top 2 of the
reduced config) and deepseek-v3-671b (MLA, sigmoid top 2 of 4 and a shared
expert), whose every layer routes each side by its own f32 router.

Parameters come from the reference's own ``init`` and cross by
``repro_torch.interop.params_from_numpy``; prompts come from the same numpy
draw in both packages.  The port's prefill runs its attention through
``ops.flash_attention`` (on the CPU, the kernel's plain version); the
reference's runs ``_dot_attn`` with its additive mask.  gemma3-12b's reduced
config keeps what the full one exercises: a sliding window (32, shorter than
the 40-token prompt) on layer 0 and a global layer 1, qk-norm, dual rope
thetas and tied embeddings.

Tolerance: both sides compute in f32 with matmul and softmax sums in their
own orders, so each output is held to 1e-4 of its magnitude (1e-5 for the
norm and the rope tables); greedy tokens must be equal.  At
hd = 64 the scale hd^-0.5 is a power of two, so scaling q before or inside
the product rounds the same.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as ref_base
from repro.configs import registry as ref_registry
from repro.models import attention as ref_attn
from repro.models import layers as ref_layers
from repro.models.registry import get_model_api as ref_get_model_api
from repro_torch.configs import base, registry
from repro_torch.interop import params_from_numpy, tensor_from_numpy
from repro_torch.kernels import flash_attention as fa
from repro_torch.launch import serve
from repro_torch.models import attention, layers, transformer
from repro_torch.models.registry import get_model_api
from _torch_threads import one_thread  # noqa: F401,E402  (an autouse fixture)

ARCHS = ("codeqwen1.5-7b", "gemma3-12b", "glm4-9b", "phi3-medium-14b",
         "dbrx-132b", "deepseek-v3-671b")
GQA_ARCHS = tuple(a for a in ARCHS if a != "deepseek-v3-671b")
# The vlm and masked_lm archs, xlstm-350m and hymba-1.5b have their own
# files (tests/test_torch_{vlm,masked_lm,xlstm,hymba}.py).
B, S, NEW = 2, 40, 5  # 4 decode steps after the prefill's token

_CACHE: dict = {}


def _setup(arch):
    """(reference api, port api, reference params as numpy, port params,
    prompt tokens as numpy), built once per arch."""
    if arch not in _CACHE:
        ref_api = ref_get_model_api(ref_registry.get_config(arch, smoke=True))
        api = get_model_api(registry.get_config(arch, smoke=True))
        ref_params = jax.device_get(ref_api.init(jax.random.PRNGKey(0)))
        tokens = np.array(
            ref_registry.make_batch(ref_api.cfg, B, S, seed=1)["tokens"])
        _CACHE[arch] = (ref_api, api, ref_params, params_from_numpy(ref_params),
                        tokens)
    return _CACHE[arch]


def _close(got, want, what, rel=1e-4):
    if isinstance(got, torch.Tensor):
        got = got.float().numpy()
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= rel * scale, f"{what}: max|err| {err:.3e} > {rel} * {scale:.3e}"


def _fields(cfg):
    return {k: v for k, v in dataclasses.asdict(cfg).items() if k != "dtype"}


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_match_the_reference(arch):
    for smoke in (False, True):
        ref_cfg = ref_registry.get_config(arch, smoke=smoke)
        cfg = registry.get_config(arch, smoke=smoke)
        assert _fields(cfg) == _fields(ref_cfg)
        assert str(cfg.dtype).split(".")[-1] == jnp.dtype(ref_cfg.dtype).name
    assert base.INPUT_SHAPES == {
        k: base.InputShape(*dataclasses.astuple(v))
        for k, v in ref_base.INPUT_SHAPES.items()}
    ref_api, api = _setup(arch)[:2]
    assert api.num_params() == ref_api.num_params()


def test_every_reference_arch_resolves_in_the_port():
    assert registry.ARCH_IDS == tuple(ref_registry.ARCH_IDS)
    assert registry.PORTED_ARCH_IDS == registry.ARCH_IDS
    for arch in ref_registry.ARCH_IDS:
        for smoke in (False, True):
            cfg = registry.get_config(arch, smoke=smoke)
            assert cfg.name == arch
            assert (cfg.block_kind
                    == ref_registry.get_config(arch, smoke=smoke).block_kind)
            assert get_model_api(cfg).cfg is cfg


def test_make_batch_draws_the_reference_tokens():
    cfg = registry.get_config("gemma3-12b", smoke=True)
    ref_cfg = ref_registry.get_config("gemma3-12b", smoke=True)
    got = registry.make_batch(cfg, 3, 17, seed=5)["tokens"]
    want = np.asarray(ref_registry.make_batch(ref_cfg, 3, 17, seed=5)["tokens"])
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_norm_rope_and_xent_match_the_reference():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 3, 64)).astype(np.float32)
    scale = (0.1 * rng.standard_normal(64)).astype(np.float32)
    _close(layers.rms_norm(torch.from_numpy(x), torch.from_numpy(scale), 1e-6),
           ref_layers.rms_norm(jnp.asarray(x), jnp.asarray(scale), 1e-6),
           "rms_norm", rel=1e-5)
    pos = np.broadcast_to(np.arange(5), (2, 5)).copy()
    for theta in (10_000.0, 1_000_000.0):
        sin, cos = layers.rope(torch.from_numpy(pos), 64, theta)
        rsin, rcos = ref_layers.rope(jnp.asarray(pos), 64, theta)
        _close(sin, rsin, "rope sin", rel=1e-5)
        _close(cos, rcos, "rope cos", rel=1e-5)
        _close(layers.apply_rope(torch.from_numpy(x), sin, cos),
               ref_layers.apply_rope(jnp.asarray(x), rsin, rcos),
               "apply_rope", rel=1e-5)
    logits = rng.standard_normal((2, 5, 11)).astype(np.float32)
    labels = rng.integers(0, 11, (2, 5)).astype(np.int32)
    mask = (rng.random((2, 5)) < 0.6).astype(np.float32)
    for m in (None, mask):
        got = layers.softmax_xent(torch.from_numpy(logits),
                                  torch.from_numpy(labels),
                                  None if m is None else torch.from_numpy(m))
        want = ref_layers.softmax_xent(jnp.asarray(logits), jnp.asarray(labels),
                                       None if m is None else jnp.asarray(m))
        for g, w in zip(got, want):
            _close(g, w, "softmax_xent", rel=1e-5)


@pytest.mark.parametrize("arch", GQA_ARCHS)
def test_gqa_forward_and_decode_match_the_reference(arch):
    ref_api, api, ref_params, params, _ = _setup(arch)
    cfg, ref_cfg = api.cfg, ref_api.cfg
    rng = np.random.default_rng(1)
    x = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    windows, thetas = transformer._layer_meta(cfg)
    for i, (win, th) in enumerate(zip(windows, thetas)):
        ref_p = jax.tree.map(lambda a, i=i: a[i], ref_params["layers"]["attn"])
        p = transformer._layer(params["layers"]["attn"], i)
        before = fa.launches
        out, (k, v) = attention.gqa_forward(p, torch.from_numpy(x), cfg,
                                            window=win, theta=th,
                                            return_kv=True)
        assert fa.launches == before  # the CPU runs the plain version
        ref_out, (rk, rv) = ref_attn.gqa_forward(
            ref_p, jnp.asarray(x), ref_cfg, window=win, theta=th,
            return_kv=True)
        _close(out, ref_out, f"layer {i} gqa_forward")
        _close(k, rk, f"layer {i} k")
        _close(v, rv, f"layer {i} v")
        # One decode step at position S on a cache holding the S keys.
        cache_np = {n: np.zeros((B, S + 3, cfg.n_kv_heads,
                                 cfg.resolved_head_dim), np.float32)
                    for n in ("k", "v")}
        cache_np["k"][:, :S], cache_np["v"][:, :S] = np.asarray(rk), np.asarray(rv)
        x1 = x[:, :1] * 0.5
        ref_o, ref_c = ref_attn.gqa_decode(
            ref_p, jnp.asarray(x1), {n: jnp.asarray(a) for n, a in cache_np.items()},
            ref_cfg, S, window=win, theta=th)
        cache = {n: torch.from_numpy(a.copy()) for n, a in cache_np.items()}
        o, c = attention.gqa_decode(p, torch.from_numpy(x1), cache, cfg, S,
                                    window=win, theta=th)
        assert c["k"] is cache["k"]  # written in place
        _close(o, ref_o, f"layer {i} gqa_decode")
        for n in ("k", "v"):
            _close(c[n], ref_c[n], f"layer {i} decode cache {n}")


@pytest.mark.parametrize("hd", [64, 128, 256])
@pytest.mark.parametrize("arch", ["codeqwen1.5-7b", "gemma3-12b"])
def test_gqa_forward_matches_the_reference_in_bf16(arch, hd):
    """The full-width dtype at every head size the kernel takes.  Both sides
    round the projections, the attention output and the out-projection to
    bf16 in their own places, and at hd = 128 the reference also rounds
    q * hd^-0.5 to bf16 before its f32 product (not a power of two), where
    the port's attention scales in f32: four bf16 ulps of the output's
    magnitude (2^-6)."""
    ref_cfg = ref_base.reduced(ref_registry.get_config(arch), head_dim=hd,
                               dtype=jnp.bfloat16)
    cfg = base.reduced(registry.get_config(arch), head_dim=hd,
                       dtype=torch.bfloat16)
    ref_params = jax.device_get(
        ref_get_model_api(ref_cfg).init(jax.random.PRNGKey(2)))
    params = params_from_numpy(ref_params)
    x = jnp.asarray(np.random.default_rng(3).standard_normal(
        (B, S, cfg.d_model)), jnp.bfloat16)
    for i, (win, th) in enumerate(zip(*transformer._layer_meta(cfg))):
        ref_out = ref_attn.gqa_forward(
            jax.tree.map(lambda a, i=i: a[i], ref_params["layers"]["attn"]),
            x, ref_cfg, window=win, theta=th)
        out = attention.gqa_forward(
            transformer._layer(params["layers"]["attn"], i),
            tensor_from_numpy(np.asarray(x)), cfg, window=win, theta=th)
        assert out.dtype == torch.bfloat16
        _close(out, ref_out, f"layer {i} bf16 gqa_forward", rel=2.0 ** -6)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_the_reference(arch):
    ref_api, api, ref_params, params, tokens = _setup(arch)
    cache_len = S + NEW
    ref_logits, ref_cache = jax.jit(
        lambda p, b: ref_api.prefill(p, b, cache_len))(
            ref_params, {"tokens": jnp.asarray(tokens)})
    with torch.no_grad():
        logits, cache = api.prefill(
            params, {"tokens": torch.from_numpy(tokens)}, cache_len)
    assert logits.shape == (B, S, api.cfg.padded_vocab)
    _close(logits, ref_logits, "prefill logits")
    with torch.no_grad():
        _close(api.forward(params, {"tokens": torch.from_numpy(tokens)})[0],
               ref_logits, "forward logits")
    assert sorted(cache) == sorted(ref_cache)  # k, v or ckv, kpe
    for n in cache:
        _close(cache[n], ref_cache[n], f"prefill cache {n}")
    ref_step = jax.jit(ref_api.decode_step)
    ref_tok = jnp.argmax(ref_logits[:, -1], -1).astype(jnp.int32)
    tok = logits[:, -1].argmax(-1).to(torch.int32)
    np.testing.assert_array_equal(tok.numpy(), np.asarray(ref_tok))
    for i in range(NEW - 1):
        ref_l, ref_cache = ref_step(ref_params, ref_cache, ref_tok,
                                    jnp.int32(S + i))
        with torch.no_grad():
            step_logits, cache = api.decode_step(params, cache, tok, S + i)
        _close(step_logits, ref_l, f"decode step {i} logits")
        for n in cache:
            _close(cache[n], ref_cache[n], f"decode step {i} cache {n}")
        ref_tok = jnp.argmax(ref_l, -1).astype(jnp.int32)
        tok = step_logits.argmax(-1).to(torch.int32)
        np.testing.assert_array_equal(tok.numpy(), np.asarray(ref_tok))


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_main_runs_on_the_cpu(arch, capsys):
    before = fa.launches
    out = serve.main(["--device", "cpu", "--smoke", "--arch", arch,
                      "--batch", "2", "--prompt-len", "40", "--new-tokens", "3"])
    assert fa.launches == before
    assert out["tokens"].shape == (2, 3) and out["steps"] == 2
    assert out["finite"]
    assert out["api"].cfg.name == registry.get_config(arch).name
    assert out["batch"]["tokens"].shape == (2, 40)
    printed = capsys.readouterr().out
    assert "[serve] prefill 2x40:" in printed and "[serve] 2 steps:" in printed


@pytest.mark.parametrize("arch", ARCHS)
def test_generated_logits_are_the_reference_forward_on_the_extended_prompt(
        arch, capsys):
    """The logits each new token was picked from, prefill's last row and
    one row per decode step, are the reference's ``forward`` on the prompt
    extended by the new tokens, at positions S-1 .. S+NEW-2.

    A MoE layer's capacity grows with the sequence (25 slots an expert at
    the prompt's 40 tokens, 27 at the extended 44) and a decode step never
    drops, so the prefill and the longer forward drop different
    assignments, in the reference as in the port.  For the MoE models both
    sides here run with ``capacity_factor = n_experts / top_k``, a capacity
    of every token, so that the statement holds; ``chip_smoke.py`` phase
    13 holds the full-width models at their own capacity instead, up to
    the first position whose kept assignments differ."""
    ref_api, api, ref_params, params, tokens = _setup(arch)
    if api.cfg.n_experts:
        fit = api.cfg.n_experts / api.cfg.top_k
        api = get_model_api(dataclasses.replace(api.cfg, capacity_factor=fit))
        ref_api = ref_get_model_api(dataclasses.replace(ref_api.cfg,
                                                        capacity_factor=fit))
    out = serve.generate(api, params, {"tokens": torch.from_numpy(tokens)}, NEW)
    capsys.readouterr()
    assert out["logits"].shape == (B, NEW, api.cfg.padded_vocab)
    assert torch.equal(out["logits"].argmax(-1).to(torch.int32), out["tokens"])
    ext = np.concatenate([tokens, out["tokens"][:, :-1].numpy()], axis=1)
    ref_logits, _ = ref_api.forward(ref_params, {"tokens": jnp.asarray(ext)})
    _close(out["logits"], np.asarray(ref_logits)[:, S - 1:],
           "generated logits against forward")


def test_serve_refuses_clients_until_the_delta_bank_is_ported():
    """The delta bank and personalized serving are ported (queue 1 items 9
    and 13.6): ``--clients`` now serves one lane per client
    (``tests/test_torch_serve_personalized.py`` holds it to the
    reference)."""
    rec = serve.main(["--device", "cpu", "--clients", "4", "--rank", "2",
                      "--prompt-len", "6", "--new-tokens", "2"])
    assert tuple(rec["tokens"].shape) == (4, 2) and rec["finite"]
    assert rec["bank"].shape == (4, rec["spec"].dim)


def test_params_cross_bf16_bit_for_bit():
    """The nested, layer-stacked LLM tree crosses from the reference with
    bf16 leaves unchanged, bit for bit."""
    ref_cfg = ref_base.reduced(ref_registry.get_config("gemma3-12b"),
                               dtype=jnp.bfloat16)
    ref_params = jax.device_get(
        ref_get_model_api(ref_cfg).init(jax.random.PRNGKey(3)))
    params = params_from_numpy(ref_params)
    flat_ref = jax.tree_util.tree_flatten_with_path(ref_params)[0]
    for path, leaf in flat_ref:
        node = params
        for key in path:
            node = node[key.key]
        leaf = np.asarray(leaf)
        assert node.dtype == (torch.bfloat16 if leaf.dtype.name == "bfloat16"
                              else tensor_from_numpy(leaf).dtype)
        assert tuple(node.shape) == leaf.shape
        if leaf.dtype.name == "bfloat16":
            np.testing.assert_array_equal(node.view(torch.int16).numpy(),
                                          leaf.view(np.int16))
        else:
            np.testing.assert_array_equal(node.numpy(), leaf)
    assert params["layers"]["attn"]["wq"].dtype == torch.bfloat16
