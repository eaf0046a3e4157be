"""The flash attention backward's plain version
(``repro_torch.kernels.flash_attention.flash_attention_backward_plain``,
which the CPU path runs and the CUDA kernel is held to) against autograd of
the port's plain forward and against ``jax.vjp`` of the reference's
``repro.kernels.ref.flash_attention_ref``, on the same numpy inputs, f32,
causal with and without a window and non-causal with and without one, GQA
groups 1, 2 and 4, hd 64, 80 (hubert-xlarge's), 128 and 256 (gemma3-12b's);
the dispatch, tolerance and share rule of bf16 at hd 256; an f64
``gradcheck`` of the plain twin
through the autograd Function; and the mask fault that the card's check
uses, which must miss the tolerance.

Tolerance: ``flash_attention.backward_tolerance``: both sides compute in
f32 in their own orders, within 2 u n of the gradient formulas evaluated on
magnitudes (u = 2^-24, n = 2 S + hd (1 + 2 s_max) + 8; its docstring
derives it), plus 2u |ref| for the f32 outputs' roundings.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as ref_ref
from repro_torch.interop import tensor_from_numpy
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops

MODES = [(True, 0), (True, 9), (False, 0), (False, 9)]
SHAPES = [(2, 4, 4, 40, 64), (1, 4, 2, 33, 128), (2, 8, 2, 40, 64),
          (2, 4, 4, 30, 80), (1, 8, 2, 33, 80), (1, 4, 2, 33, 256),
          (1, 2, 2, 40, 256)]
# gemma3-12b's attention at S = 2048 (phase 12) and 4096 (its pod round).
GEMMA_SHAPES = [(1, 16, 8, 2048, 256), (1, 16, 8, 4096, 256)]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this file's small tensors: the suite runs
    files in parallel workers, and a thread pool per worker oversubscribes
    the cores (tiny ops then wait on each other's spinning threads)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(shape, seed=0):
    b, h, kv, s, hd = shape
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(sh).astype(np.float32)
            for sh in ((b, h, s, hd), (b, kv, s, hd), (b, kv, s, hd),
                       (b, h, s, hd))]


def _within(got, want, tol):
    for a, b, t in zip(got, want, tol):
        a = torch.as_tensor(np.asarray(a)) if not isinstance(a, torch.Tensor) else a
        b = torch.as_tensor(np.asarray(b)) if not isinstance(b, torch.Tensor) else b
        assert a.shape == b.shape
        ratio = float(((a.float() - b.float()).abs() / t).max())
        assert ratio <= 1.0, ratio


@pytest.mark.parametrize("causal,window", MODES)
@pytest.mark.parametrize("shape", SHAPES)
def test_plain_backward_matches_autograd_and_the_reference(shape, causal,
                                                           window):
    qn, kn, vn, don = _inputs(shape)
    q, k, v, do = (torch.from_numpy(a) for a in (qn, kn, vn, don))
    qg, kg, vg = (t.clone().requires_grad_() for t in (q, k, v))
    o = fa.flash_attention_plain(qg, kg, vg, causal, window)
    auto = torch.autograd.grad(o, (qg, kg, vg), do)
    got = fa.flash_attention_backward_plain(q, k, v, o.detach(), do, causal,
                                            window)
    tol = fa.backward_tolerance(q, k, v, o.detach(), do, got, causal, window)
    _within(got, auto, tol)

    ref_o, vjp = jax.vjp(
        lambda a, b, c: ref_ref.flash_attention_ref(a, b, c, causal, window),
        jnp.asarray(qn), jnp.asarray(kn), jnp.asarray(vn))
    np.testing.assert_allclose(np.asarray(ref_o), o.detach().numpy(),
                               rtol=0, atol=2e-5)
    ref_grads = [np.asarray(x) for x in vjp(jnp.asarray(don))]
    _within(got, ref_grads, tol)


def test_the_function_differentiates_through_the_plain_backward():
    """On the CPU the op's autograd Function runs the plain forward and the
    plain backward: the same gradients as :func:`flash_attention_backward`,
    the forward's output saved, no kernel launched."""
    qn, kn, vn, don = _inputs((2, 4, 2, 30, 64), seed=1)
    q, k, v = (tensor_from_numpy(a).requires_grad_() for a in (qn, kn, vn))
    do = torch.from_numpy(don)
    before = (fa.launches, fa.backward_launches)
    o = ops.flash_attention(q, k, v, True, 7)
    grads = torch.autograd.grad(o, (q, k, v), do)
    want = fa.flash_attention_backward(q.detach(), k.detach(), v.detach(),
                                       o.detach(), do, True, 7)
    for a, b in zip(grads, want):
        assert torch.equal(a, b)
    assert (fa.launches, fa.backward_launches) == before
    with torch.no_grad():
        assert ops.flash_attention(q, k, v).grad_fn is None


@pytest.mark.parametrize("causal,window", MODES)
def test_gradcheck_of_the_plain_twin_in_f64(causal, window):
    g = torch.Generator().manual_seed(2)
    q = torch.randn(1, 4, 9, 16, generator=g, dtype=torch.float64)
    k, v = (torch.randn(1, 2, 9, 16, generator=g, dtype=torch.float64)
            for _ in range(2))
    assert torch.autograd.gradcheck(
        lambda a, b, c: fa.flash_attention(a, b, c, causal, window),
        tuple(t.requires_grad_() for t in (q, k, v)))


def test_a_mask_one_key_late_misses_the_tolerance():
    """The card's mask fault: the backward on q, o and dO moved down one row
    attends each row with its mask one key late; its dq must miss the
    tolerance by far."""
    qn, kn, vn, don = _inputs((1, 4, 2, 64, 128), seed=3)
    q, k, v, do = (torch.from_numpy(a) for a in (qn, kn, vn, don))
    for causal, window in ((True, 0), (True, 16)):
        o = fa.flash_attention_plain(q, k, v, causal, window)
        want = fa.flash_attention_backward_plain(q, k, v, o, do, causal,
                                                 window)
        tol = fa.backward_tolerance(q, k, v, o, do, want, causal, window)
        roll = [torch.roll(t, 1, 2) for t in (q, o, do)]
        fault = fa.flash_attention_backward_plain(roll[0], k, v, roll[1],
                                                  roll[2], causal, window)
        miss = float(((fault[0][:, :, 1:] - want[0][:, :, :-1]).abs()
                      / tol[0][:, :, :-1]).max())
        assert miss > 10.0, miss


@pytest.mark.parametrize("causal,window", MODES)
def test_the_tolerance_covers_an_o_off_by_o_err(causal, window):
    """The card holds the kernel's backward, given the forward kernel's o,
    against the plain backward given the plain forward's o: ``o_err`` (the
    forward's bound, ``bf16_tolerance`` here) widens the tolerance by what
    that difference can move.  An o moved by the whole bound, each element
    up or down at random, stays within it; without ``o_err`` it does
    not."""
    qn, kn, vn, don = _inputs((1, 8, 2, 48, 64), seed=4)
    q, k, v, do = (torch.from_numpy(a) for a in (qn, kn, vn, don))
    o = fa.flash_attention_plain(q, k, v, causal, window)
    want = fa.flash_attention_backward_plain(q, k, v, o, do, causal, window)
    err = fa.bf16_tolerance(v, o, causal, window)
    sign = torch.from_numpy(np.sign(
        np.random.default_rng(5).standard_normal(o.shape)).astype(np.float32))
    got = fa.flash_attention_backward_plain(q, k, v, o + sign * err, do,
                                            causal, window)
    _within(got, want, fa.backward_tolerance(q, k, v, o, do, want, causal,
                                             window, o_err=err))
    tol = fa.backward_tolerance(q, k, v, o, do, want, causal, window)
    assert float(((got[0] - want[0]).abs() / tol[0]).max()) > 1.0
    assert torch.equal(got[2], want[2])  # dv does not read o


@pytest.mark.parametrize("shape", [(1, 4, 2, 24, 256), (1, 2, 2, 40, 256)])
def test_bf16_at_hd_256_runs_the_tensor_core_passes(shape):
    """bf16 at hd 256 runs the tensor-core passes, so its bound carries
    their rounding term, 2^-8 of the magnitudes (P^T and dS in bf16), on
    top of the f32 bound of the same values: the excess is proportional to
    the f32 bound's own magnitude term, 2 u n mag, in every element (their
    ratio 2^-8 / (2 u n) is one number).  f32 at hd 256 stays on the SIMT
    passes, whose bound has no such term."""
    assert fa.on_tensor_cores(torch.bfloat16, 256)
    assert not fa.on_tensor_cores(torch.float32, 256)
    qb, kb, vb, dob = (torch.from_numpy(a).bfloat16()
                       for a in _inputs(shape, seed=7))
    ob = fa.flash_attention_plain(qb, kb, vb)
    ref = fa.flash_attention_backward_plain(qb, kb, vb, ob, dob)
    wide = fa.backward_tolerance(qb, kb, vb, ob, dob, ref)
    narrow = fa.backward_tolerance(*(t.float() for t in (qb, kb, vb, ob, dob)),
                                   ref)
    for w, n, r in zip(wide, narrow, ref):
        term = n - 2.0 ** -7 * r.float().abs()  # 2 u n mag
        live = term > 1e-3 * float(term.max())
        ratio = ((w - n)[live] / term[live]).double()
        assert float(ratio.min()) > 1.0  # 2^-8 against 2 u n ~ 2^-14
        assert float(ratio.max() / ratio.min()) < 1.0 + 1e-3


@pytest.mark.parametrize("shape", GEMMA_SHAPES)
def test_gemma_shapes_sum_no_shares(shape):
    """At gemma3-12b's shapes the dK / dV pass's 64-key tiles give 256 and
    512 blocks (B = 1, 8 kv heads) for 132 SMs: one run a group, no f32
    shares to sum; f32 sums the group's 2 heads."""
    b, h, kv, s, hd = shape
    assert fa.backward_shares(torch.bfloat16, hd, b, h, kv, s) == 1
    assert fa.backward_shares(torch.float32, hd, b, h, kv, s) == h // kv
    # Under a block per SM the group is split: 2 runs at S = 512 (64
    # blocks of one run).
    assert fa.backward_shares(torch.bfloat16, hd, b, h, kv, 512) == 2
