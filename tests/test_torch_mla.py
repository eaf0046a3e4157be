"""The port's multi-head latent attention (``repro_torch.models.attention``
``mla_*``) against the JAX reference's, on the CPU at ``reduced``
deepseek-v3-671b size (d = 256, 4 heads, q rank 64, kv rank 32, no-rope 32
+ rope 16 query/key widths, values of 32), parameters from the reference's
own ``init``.

Held: ``mla_forward``'s output and its latent cache entries (``ckv``,
``kpe``) for a 40-token sequence, then one ``mla_decode`` step at position
40 against a cache holding those 40 entries: its output and the whole
updated cache (the port writes it in place, the reference returns a copy).

Tolerance: in f32 both sides compute the same operations with matmul and
softmax sums in their own orders, 1e-4 of each output's magnitude (the
serving tests' bound), 1e-5 for the cache entries (one projection, a norm
and a rotation).  In bf16 both round the projections and the attention
output to bf16 in the same places, and both scale q by 192^-0.5 (here
48^-0.5) in bf16 before the f32 scores; their f32 sums in their own orders
can still round a bf16 output one ulp apart, which the projection after it
carries: four bf16 ulps of the output's magnitude (2^-6), as the GQA bf16
test.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as ref_base
from repro.configs import registry as ref_registry
from repro.models import attention as ref_attn
from repro.models.registry import get_model_api as ref_get_model_api
from repro_torch.configs import base, registry
from repro_torch.interop import params_from_numpy, tensor_from_numpy
from repro_torch.models import attention

ARCH = "deepseek-v3-671b"
B, S = 2, 40


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want, what, rel):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= rel * scale, f"{what}: max|err| {err:.3e} > {rel} x {scale:.3e}"


def _layers(dtype):
    """(reference config, port config, per-layer reference params, per-layer
    port params) of reduced deepseek in ``dtype``."""
    ref_cfg = ref_base.reduced(ref_registry.get_config(ARCH),
                               dtype=getattr(jnp, dtype))
    cfg = base.reduced(registry.get_config(ARCH), dtype=getattr(torch, dtype))
    ref_params = jax.device_get(
        ref_get_model_api(ref_cfg).init(jax.random.PRNGKey(2)))
    attn = ref_params["layers"]["attn"]
    ref_layers = [jax.tree.map(lambda a, i=i: a[i], attn)
                  for i in range(ref_cfg.n_layers)]
    return ref_cfg, cfg, ref_layers, [params_from_numpy(p) for p in ref_layers]


def test_mla_defs_and_cache_defs_match_the_reference():
    ref_cfg = ref_registry.get_config(ARCH)
    cfg = registry.get_config(ARCH)
    for stacked in ((), (3,)):
        want = ref_attn.mla_defs(ref_cfg, stacked)
        got = attention.mla_defs(cfg, stacked)
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].shape == want[k].shape and got[k].axes == want[k].axes
            assert got[k].fan_in == want[k].fan_in and got[k].init == want[k].init
        want_c = ref_attn.mla_cache_defs(ref_cfg, 4, 2064, stacked)
        got_c = attention.mla_cache_defs(cfg, 4, 2064, stacked)
        assert {k: d.shape for k, d in got_c.items()} == {
            k: d.shape for k, d in want_c.items()}


def test_mla_forward_and_decode_match_the_reference():
    ref_cfg, cfg, ref_layers, layers = _layers("float32")
    x = np.random.default_rng(1).standard_normal(
        (B, S, cfg.d_model)).astype(np.float32)
    for i, (ref_p, p) in enumerate(zip(ref_layers, layers)):
        out, (ckv, kpe) = attention.mla_forward(p, torch.from_numpy(x), cfg,
                                                return_kv=True)
        ref_out, (rckv, rkpe) = ref_attn.mla_forward(
            ref_p, jnp.asarray(x), ref_cfg, return_kv=True)
        _close(out, ref_out, f"layer {i} mla_forward", 1e-4)
        _close(ckv, rckv, f"layer {i} ckv", 1e-5)
        _close(kpe, rkpe, f"layer {i} kpe", 1e-5)
        # One decode step at position S on a cache holding the S entries.
        cache_np = {"ckv": np.zeros((B, S + 3, cfg.kv_lora_rank), np.float32),
                    "kpe": np.zeros((B, S + 3, cfg.qk_rope_head_dim),
                                    np.float32)}
        cache_np["ckv"][:, :S] = np.asarray(rckv)
        cache_np["kpe"][:, :S] = np.asarray(rkpe)
        x1 = x[:, :1] * 0.5
        ref_o, ref_c = ref_attn.mla_decode(
            ref_p, jnp.asarray(x1),
            {n: jnp.asarray(a) for n, a in cache_np.items()}, ref_cfg, S)
        cache = {n: torch.from_numpy(a.copy()) for n, a in cache_np.items()}
        o, c = attention.mla_decode(p, torch.from_numpy(x1), cache, cfg, S)
        assert c["ckv"] is cache["ckv"]  # written in place
        _close(o, ref_o, f"layer {i} mla_decode", 1e-4)
        for n in ("ckv", "kpe"):
            _close(c[n], ref_c[n], f"layer {i} decode cache {n}", 1e-5)


def test_mla_forward_matches_the_reference_in_bf16():
    ref_cfg, cfg, ref_layers, layers = _layers("bfloat16")
    x = jnp.asarray(np.random.default_rng(3).standard_normal(
        (B, S, cfg.d_model)), jnp.bfloat16)
    for i, (ref_p, p) in enumerate(zip(ref_layers, layers)):
        want = ref_attn.mla_forward(ref_p, x, ref_cfg)
        got = attention.mla_forward(p, tensor_from_numpy(np.asarray(x)), cfg)
        assert got.dtype == torch.bfloat16
        _close(got, want, f"layer {i} bf16 mla_forward", 2.0 ** -6)
