"""The port's flash attention on the CPU against the JAX reference.

The port's oracle ``repro_torch.kernels.ref.flash_attention_ref`` and its
public op ``repro_torch.kernels.ops.flash_attention`` (on a CPU tensor, the
kernel's plain version: no launch) take the same numpy inputs as the
reference's ``repro.kernels.ref.flash_attention_ref`` and its Pallas kernel
``repro.kernels.ops.flash_attention``, which runs in interpret mode here
(S = 128 in 64-row blocks, so the window closes whole tiles there too).

Tolerances: in f32 both sides sum in their own orders, 2e-5 absolute on
outputs of magnitude about 1 (the reference's own kernel tests allow
2e-4).  hd^-0.5 is a power of two at hd = 64 and 256, so scaling q before
or after the product rounds the same.  In bf16 both compute in f32 from
the same bf16 inputs and round the output once, so a result may land one
bf16 ulp apart: 2^-7 of its magnitude, plus the f32 2e-5.

At hd 80 (hubert-xlarge) the plain version is held to the reference's
oracle and to its Pallas kernel in interpret mode, causal and not, in both
dtypes; 80^-0.5 is no power of two, but every side scales in f32 here
(the port's plain version q before the product, the reference's oracle the
scores after it), a few f32 roundings of the scores apart, well inside
2e-5.  Its plain backward is held to ``jax.vjp`` of the reference's
``_dot_attn`` (the models' attention core) within
``flash_attention.backward_tolerance``.  The CUDA backward is built at hd
80 too (``BACKWARD_HEAD_DIMS``: bf16 on the tensor cores, f32 on the SIMT
passes); it runs only on the card (``tests/test_torch_gpu.py``,
``chip_smoke.py`` phases 12, 14 and 16).

The CUDA kernel for bf16 inputs also rounds P to bf16 before P.V on the
tensor cores.  No CUDA kernel runs here, so ``_emulate_bf16_kernel`` redoes
its arithmetic tile by tile in PyTorch, and the tests hold it to
``flash_attention.bf16_tolerance`` (2e-5 + 2^-8 max|v| over the row's open
keys + 2^-7 |out|) against the plain version; a mask one key off must miss
that tolerance.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as ref_ops
from repro.kernels import ref as ref_ref
from repro.models import attention as ref_attn
from repro_torch.interop import tensor_from_numpy
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops, ref
from _torch_threads import one_thread  # noqa: F401,E402  (an autouse fixture)

MODES = [(True, 0), (True, 64), (False, 0)]
BQ, BK = 128, 64  # the bf16 kernel's query and key tiles
HEADS = [(4, 4), (4, 2), (8, 1)]
F32_TOL = 2e-5
BF16_RTOL = 2.0 ** -7


def _inputs(b, h, kv, s, hd, dtype, seed=0):
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(shape).astype(np.float32)
            for shape in ((b, h, s, hd), (b, kv, s, hd), (b, kv, s, hd))]
    jx = [jnp.asarray(a, dtype) for a in arrs]
    th = [tensor_from_numpy(np.asarray(a)) for a in jx]  # same bits
    return jx, th


def _assert_close(got, want, bf16):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(
        np.asarray(got, np.float32), np.asarray(want, np.float32),
        rtol=BF16_RTOL if bf16 else 0.0, atol=F32_TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hd", [64, 256])
@pytest.mark.parametrize("h,kv", HEADS)
@pytest.mark.parametrize("causal,window", MODES)
def test_flash_attention_matches_the_reference(causal, window, h, kv, hd, dtype):
    (jq, jk, jv), (q, k, v) = _inputs(2, h, kv, 128, hd, getattr(jnp, dtype))
    bf16 = dtype == "bfloat16"
    want = ref_ref.flash_attention_ref(jq, jk, jv, causal=causal, window=window)
    want_kernel = ref_ops.flash_attention(jq, jk, jv, causal=causal,
                                          window=window, block_q=64, block_k=64)
    before = fa.launches
    got = ops.flash_attention(q, k, v, causal=causal, window=window)
    got_ref = ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    assert fa.launches == before  # a CPU tensor takes the plain version
    assert got.dtype == q.dtype and got.shape == q.shape
    assert got_ref.dtype == q.dtype
    _assert_close(got_ref, want, bf16)
    _assert_close(got, want, bf16)
    _assert_close(got, want_kernel, bf16)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("h,kv", HEADS)
@pytest.mark.parametrize("causal,window", MODES)
def test_flash_attention_matches_the_reference_at_hd_80(causal, window, h, kv,
                                                        dtype):
    (jq, jk, jv), (q, k, v) = _inputs(2, h, kv, 128, 80, getattr(jnp, dtype),
                                      seed=4)
    bf16 = dtype == "bfloat16"
    want = ref_ref.flash_attention_ref(jq, jk, jv, causal=causal, window=window)
    want_kernel = ref_ops.flash_attention(jq, jk, jv, causal=causal,
                                          window=window, block_q=64, block_k=64)
    before = fa.launches
    got = ops.flash_attention(q, k, v, causal=causal, window=window)
    assert fa.launches == before
    assert got.dtype == q.dtype and got.shape == q.shape
    _assert_close(ref.flash_attention_ref(q, k, v, causal=causal,
                                          window=window), want, bf16)
    _assert_close(got, want, bf16)
    _assert_close(got, want_kernel, bf16)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("h,kv", [(4, 4), (4, 2)])
def test_plain_backward_at_hd_80_matches_the_reference_dot_attn(causal, h, kv):
    """The gradient of the models' attention core at hubert-xlarge's head
    dim: ``jax.vjp`` of the reference's ``_dot_attn`` (with its additive
    causal mask, or none for an encoder) against the port's plain
    backward, f32."""
    b, s, hd = 2, 37, 80
    rng = np.random.default_rng(5)
    qn, kn, vn, don = (rng.standard_normal(sh).astype(np.float32)
                       for sh in ((b, h, s, hd), (b, kv, s, hd),
                                  (b, kv, s, hd), (b, h, s, hd)))
    pos = jnp.broadcast_to(jnp.arange(s), (b, s))
    bias = (ref_attn._full_mask(pos, pos, 0, True)[:, None, None] if causal
            else None)

    def core(q, k, v):  # (B,H,S,hd), (B,KV,S,hd) in the kernel's layout
        out = ref_attn._dot_attn(
            q.transpose(0, 2, 1, 3).reshape(b, s, kv, h // kv, hd),
            k.transpose(0, 2, 1, 3), v.transpose(0, 2, 1, 3), bias, hd ** -0.5)
        return out.reshape(b, s, h, hd).transpose(0, 2, 1, 3)

    ref_o, vjp = jax.vjp(core, jnp.asarray(qn), jnp.asarray(kn),
                         jnp.asarray(vn))
    want = [np.asarray(g) for g in vjp(jnp.asarray(don))]
    q, k, v, do = (torch.from_numpy(a) for a in (qn, kn, vn, don))
    o = fa.flash_attention_plain(q, k, v, causal, 0)
    _assert_close(o, ref_o, False)
    got = fa.flash_attention_backward(q, k, v, o, do, causal, 0)
    tol = fa.backward_tolerance(q, k, v, o, do, got, causal, 0)
    for g, w, t in zip(got, want, tol):
        assert float(((g - torch.from_numpy(w.copy())).abs() / t).max()) <= 1.0


def test_the_backward_is_built_at_every_forward_head_dim():
    """The backward kernel is built at every head dim of the forward, hd
    80 (hubert-xlarge) included: bf16 there and at hd 256 runs the
    tensor-core passes (``backward_tolerance`` adds their 2^-8 term), f32
    the SIMT ones.  A
    head dim outside the tuple is refused on the card
    (``tests/test_torch_gpu.py``)."""
    assert fa.BACKWARD_HEAD_DIMS == fa.HEAD_DIMS
    assert 80 in fa.BACKWARD_HEAD_DIMS
    assert fa.on_tensor_cores(torch.bfloat16, 80)
    assert not fa.on_tensor_cores(torch.float32, 80)
    assert fa.on_tensor_cores(torch.bfloat16, 256)
    assert set(fa.backward_head_dim_launches) == set(fa.BACKWARD_HEAD_DIMS)


@pytest.mark.parametrize("s", [12, 100])
@pytest.mark.parametrize("causal,window", MODES)
def test_flash_attention_takes_a_ragged_length(s, causal, window):
    """Any S, not only multiples of a block: the reference oracle is the
    yardstick (its kernel needs block multiples)."""
    (jq, jk, jv), (q, k, v) = _inputs(1, 4, 2, s, 64, jnp.float32, seed=1)
    want = ref_ref.flash_attention_ref(jq, jk, jv, causal=causal,
                                       window=min(window, 7) if window else 0)
    got = ops.flash_attention(q, k, v, causal=causal,
                              window=min(window, 7) if window else 0)
    _assert_close(got, want, False)


def test_flash_attention_reads_transposed_views():
    """gqa_forward passes the (B,S,H,hd) projections as their
    ``transpose(1, 2)`` views: the same values as contiguous inputs."""
    _, (q, k, v) = _inputs(2, 4, 2, 40, 64, jnp.float32, seed=2)
    qt, kt, vt = (t.transpose(1, 2).contiguous().transpose(1, 2)
                  for t in (q, k, v))
    assert not qt.is_contiguous()
    for causal, window in MODES:
        torch.testing.assert_close(
            ops.flash_attention(qt, kt, vt, causal, window),
            ops.flash_attention(q, k, v, causal, window), rtol=0, atol=0)


def test_flash_attention_refuses_inputs_that_require_grad():
    """Checks that inputs which require grad are differentiated, no longer
    refused: they go through the autograd Function, whose CPU backward is
    the plain one (``tests/test_torch_flash_backward.py`` holds it to the
    reference), and no kernel is launched.  The name is the one this test
    had while the kernel had no backward and the wrapper refused them; it
    is kept so that the test's record carries on."""
    _, (q, k, v) = _inputs(1, 2, 1, 8, 64, jnp.float32)
    out = ops.flash_attention(q.requires_grad_(), k, v)
    assert out.grad_fn is not None
    before = fa.backward_launches
    (dq,) = torch.autograd.grad(out.sum(), q)
    want = fa.flash_attention_backward_plain(
        q.detach(), k, v, out.detach(), torch.ones_like(out))[0]
    assert torch.equal(dq, want)
    assert fa.backward_launches == before  # a CPU tensor launches nothing


def _emulate_bf16_kernel(q, k, v, causal, window, diagonal=0):
    """The bf16 CUDA kernel's arithmetic in PyTorch on the CPU: 128-row
    query tiles, the 64-key tiles that the masks leave partly open for the
    tile, f32 scores of the bf16 inputs, masked scores -1e30, the online
    max, p = 2^((s - m) hd^-0.5 log2 e), P rounded to bf16 per tile before
    P.V, f32 accumulators, the denominator clamped at 1e-20.  ``diagonal``
    moves the causal diagonal that many keys later: a mask fault."""
    b, h, s, hd = q.shape
    group = h // k.shape[1]
    pad = (0, 0, 0, BQ + BK)  # zero rows past S, as TMA fills them
    qf = torch.nn.functional.pad(q.float(), pad)
    kf = torch.nn.functional.pad(k.float(), pad).repeat_interleave(group, 1)
    vf = torch.nn.functional.pad(v.float(), pad).repeat_interleave(group, 1)
    c = hd ** -0.5 * math.log2(math.e)
    out = torch.empty(b, h, s, hd)
    for q0 in range(0, s, BQ):
        rows = torch.arange(q0, q0 + BQ)[:, None]
        k_end = min(q0 + BQ, s) if causal else s
        k_begin = max(0, q0 - window + 1) if window else 0
        m = torch.full((b, h, BQ), -1e30)
        l = torch.zeros(b, h, BQ)
        acc = torch.zeros(b, h, BQ, hd)
        for k0 in range(k_begin // BK * BK, k_end, BK):
            keys = torch.arange(k0, k0 + BK)[None, :]
            x = qf[:, :, q0:q0 + BQ] @ kf[:, :, k0:k0 + BK].transpose(-1, -2)
            ok = keys < s
            if causal:
                ok = ok & (keys <= rows + diagonal)
            if window:
                ok = ok & (rows - keys < window)
            x = x.masked_fill(~ok, -1e30)
            mx = torch.maximum(m, x.amax(-1))
            alpha = torch.exp2((m - mx) * c)
            p = torch.exp2((x - mx[..., None]) * c)
            l = alpha * l + p.sum(-1)
            acc = alpha[..., None] * acc + p.bfloat16().float() @ vf[:, :, k0:k0 + BK]
            m = mx
        o = acc / l.clamp_min(1e-20)[..., None]
        out[:, :, q0:q0 + BQ] = o[:, :, :min(BQ, s - q0)]
    return out.to(q.dtype)


# (B, H, KV, S, hd), causal, window: gemma3's hd 256 with a window; a causal
# GQA group of 4 at hd 128 and a ragged S; hd 64, non-causal, windowed;
# hubert-xlarge's hd 80, non-causal (its encoder) and causal.
EMULATED = [((1, 4, 2, 300, 256), True, 64), ((1, 8, 2, 200, 128), True, 0),
            ((2, 4, 4, 150, 64), False, 50), ((2, 4, 4, 150, 80), False, 0),
            ((1, 8, 2, 200, 80), True, 0)]


def _beyond_tolerance(got, want, v, causal, window):
    """The largest |got - want| over its bf16 tolerance."""
    tol = fa.bf16_tolerance(v, want, causal, window)
    return float(((got.float() - want.float()).abs() / tol).max())


@pytest.mark.parametrize("shape,causal,window", EMULATED)
def test_bf16_kernel_arithmetic_lies_within_the_stated_tolerance(shape, causal,
                                                                  window):
    _, (q, k, v) = _inputs(*shape, jnp.bfloat16, seed=3)
    want = fa.flash_attention_plain(q, k, v, causal, window)
    got = _emulate_bf16_kernel(q, k, v, causal, window)
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    assert _beyond_tolerance(got, want, v, causal, window) <= 1.0


@pytest.mark.parametrize("shape,causal,window",
                         [c for c in EMULATED if c[1]])
def test_bf16_tolerance_sees_a_diagonal_one_key_off(shape, causal, window):
    """A mask fault that moves the rows with few open keys (each row also
    sees the next key) misses the tolerance: it is not too loose."""
    _, (q, k, v) = _inputs(*shape, jnp.bfloat16, seed=3)
    want = fa.flash_attention_plain(q, k, v, causal, window)
    mutant = _emulate_bf16_kernel(q, k, v, causal, window, diagonal=1)
    assert _beyond_tolerance(mutant, want, v, causal, window) > 1.0
