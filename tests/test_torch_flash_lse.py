"""The flash forward's logsumexp and what the backward does with it, on the
CPU (plain versions; the kernels are held to them on the card by
``chip_smoke.py`` phase 12 and ``tests/test_torch_gpu.py``):

- the plain forward's lse (``flash_attention_plain(..., return_lse=True)``)
  is ``torch.logsumexp`` of the masked scores, its output unchanged, and
  within ``lse_tolerance`` of the same in f64;
- the plain backward given that lse equals the one that recomputes it;
- the autograd Function saves the forward's lse and hands it to the
  backward;
- a plain emulation of the tensor-core passes' roundings (P^T and dS cast
  to bf16 and back before their products, on bf16 inputs) lies within the
  widened bf16 ``backward_tolerance``, and the row-shifted mask fault still
  misses it.

Inputs are made with numpy from a seed; the reference's ``jax.vjp`` of
``flash_attention_ref`` holds the emulation's gradients too.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as ref_ref
from repro_torch.kernels import flash_attention as fa

MODES = [(True, 0), (True, 9), (False, 0), (False, 9)]
SHAPES = [(2, 4, 4, 40, 64), (1, 4, 2, 33, 128), (2, 8, 2, 40, 64)]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this file's small tensors (the suite runs
    files in parallel workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(shape, seed=0, dtype=torch.float32):
    b, h, kv, s, hd = shape
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(sh).astype(np.float32)).to(dtype)
            for sh in ((b, h, s, hd), (b, kv, s, hd), (b, kv, s, hd),
                       (b, h, s, hd))]


def _masked_scores(q, k, causal, window):
    """The scores written out independently of the module: k repeated over
    each GQA group, f64."""
    b, h, s, hd = q.shape
    kr = k.double().repeat_interleave(h // k.shape[1], dim=1)
    scores = q.double() @ kr.transpose(-1, -2) * hd ** -0.5
    qi = torch.arange(s)[:, None]
    ki = torch.arange(s)[None, :]
    ok = (ki <= qi) if causal else torch.ones(s, s, dtype=torch.bool)
    if window:
        ok = ok & (qi - ki < window)
    return scores.masked_fill(~ok, fa.NEG)


@pytest.mark.parametrize("causal,window", MODES)
@pytest.mark.parametrize("shape", SHAPES)
def test_plain_lse_is_the_logsumexp_of_the_masked_scores(shape, causal,
                                                         window):
    q, k, v, _ = _inputs(shape)
    o, lse = fa.flash_attention_plain(q, k, v, causal, window, return_lse=True)
    assert torch.equal(o, fa.flash_attention_plain(q, k, v, causal, window))
    assert lse.shape == q.shape[:3] and lse.dtype == torch.float32
    exact = torch.logsumexp(_masked_scores(q, k, causal, window), -1)
    tol = fa.lse_tolerance(q, k, exact.float(), causal, window)
    ratio = float(((lse.double() - exact).abs() / tol).max())
    assert ratio <= 1.0, ratio


@pytest.mark.parametrize("causal,window", MODES)
@pytest.mark.parametrize("shape", SHAPES)
def test_plain_backward_given_the_lse_equals_the_recomputed_one(shape, causal,
                                                                window):
    q, k, v, do = _inputs(shape, seed=1)
    o, lse = fa.flash_attention_plain(q, k, v, causal, window, return_lse=True)
    given = fa.flash_attention_backward_plain(q, k, v, o, do, causal, window,
                                              lse=lse)
    recomputed = fa.flash_attention_backward_plain(q, k, v, o, do, causal,
                                                   window)
    for a, b in zip(given, recomputed):
        assert torch.equal(a, b)


def test_the_function_saves_the_forward_lse_and_the_backward_uses_it(
        monkeypatch):
    q, k, v, do = _inputs((2, 4, 2, 30, 64), seed=2)
    qg, kg, vg = (t.clone().requires_grad_() for t in (q, k, v))
    o = fa.flash_attention(qg, kg, vg, True, 7)
    saved = o.grad_fn.saved_tensors
    _, want_lse = fa.flash_attention_plain(q, k, v, True, 7, return_lse=True)
    assert len(saved) == 5 and torch.equal(saved[4], want_lse)
    seen = []
    plain = fa.flash_attention_backward_plain

    def spy(q, k, v, o, do, causal, window, lse=None):
        seen.append(lse)
        return plain(q, k, v, o, do, causal, window, lse)

    monkeypatch.setattr(fa, "flash_attention_backward_plain", spy)
    grads = torch.autograd.grad(o, (qg, kg, vg), do)
    assert len(seen) == 1 and torch.equal(seen[0], want_lse)
    for a, b in zip(grads, plain(q, k, v, o.detach(), do, True, 7)):
        assert torch.equal(a, b)


def _emulated_tensor_core_backward(q, k, v, o, do, causal, window,
                                   lse=None):
    """The plain backward with the tensor-core passes' two roundings: P^T
    to bf16 before P^T dO, dS to bf16 before dS k and dS^T q; f32
    arithmetic otherwise, outputs in the inputs' dtype.  ``lse`` (B, H, S)
    where given, as the kernels read the forward's."""
    b, h, s, hd = q.shape
    kv = k.shape[1]
    scale = hd ** -0.5
    bf = lambda t: t.to(torch.bfloat16).float()  # noqa: E731
    qf = (q.float() * scale).unflatten(1, (kv, h // kv))
    dof = do.float().unflatten(1, (kv, h // kv))
    scores = torch.einsum("bkgqd,bksd->bkgqs", qf, k.float())
    scores = scores.masked_fill(~fa._mask(s, causal, window, q.device), fa.NEG)
    if lse is None:
        lse = torch.logsumexp(scores, -1, keepdim=True)
    else:
        lse = lse.float().unflatten(1, (kv, h // kv))[..., None]
    p = torch.exp(scores - lse)
    dsum = (dof * o.float().unflatten(1, (kv, h // kv))).sum(-1, keepdim=True)
    dv = torch.einsum("bkgqs,bkgqd->bksd", bf(p), dof)
    ds = bf(p * (torch.einsum("bkgqd,bksd->bkgqs", dof, v.float()) - dsum))
    dq = torch.einsum("bkgqs,bksd->bkgqd", ds, k.float()) * scale
    dk = torch.einsum("bkgqs,bkgqd->bksd", ds, qf)
    return dq.flatten(1, 2).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _ratios(got, want, tol):
    return [float(((a.float() - b.float()).abs() / t).max())
            for a, b, t in zip(got, want, tol)]


@pytest.mark.parametrize("causal,window", MODES)
@pytest.mark.parametrize("shape", SHAPES)
def test_the_kernel_roundings_lie_within_the_widened_bf16_tolerance(
        shape, causal, window):
    q, k, v, do = _inputs(shape, seed=3, dtype=torch.bfloat16)
    o = fa.flash_attention_plain(q, k, v, causal, window)
    want = fa.flash_attention_backward_plain(q, k, v, o, do, causal, window)
    tol = fa.backward_tolerance(q, k, v, o, do, want, causal, window)
    got = _emulated_tensor_core_backward(q, k, v, o, do, causal, window)
    assert max(_ratios(got, want, tol)) <= 1.0
    # The reference's gradient of the same bf16-representable inputs.
    _, vjp = jax.vjp(
        lambda a, b, c: ref_ref.flash_attention_ref(a, b, c, causal, window),
        *(jnp.asarray(t.float().numpy()) for t in (q, k, v)))
    ref = [torch.from_numpy(np.array(x)).to(torch.bfloat16)
           for x in vjp(jnp.asarray(do.float().numpy()))]
    assert max(_ratios(got, ref, tol)) <= 1.0


def test_the_mask_fault_misses_the_widened_bf16_tolerance():
    """The card's mask fault: q, o, dO and lse moved down one row, so each
    row attends with its mask one key late; the emulated kernel's dq must
    miss the widened tolerance by far."""
    q, k, v, do = _inputs((1, 4, 2, 64, 128), seed=4, dtype=torch.bfloat16)
    for causal, window in ((True, 0), (True, 16)):
        o, lse = fa.flash_attention_plain(q, k, v, causal, window,
                                          return_lse=True)
        want = fa.flash_attention_backward_plain(q, k, v, o, do, causal,
                                                 window)
        tol = fa.backward_tolerance(q, k, v, o, do, want, causal, window)
        roll = [torch.roll(t, 1, 2) for t in (q, o, do, lse)]
        fault = _emulated_tensor_core_backward(roll[0], k, v, roll[1],
                                               roll[2], causal, window,
                                               lse=roll[3])[0]
        miss = float(((fault[:, :, 1:].float() - want[0][:, :, :-1].float())
                      .abs() / tol[0][:, :, :-1]).max())
        assert miss > 10.0, miss


def test_the_widening_is_for_bf16_inputs_alone():
    """bf16 inputs on the tensor-core passes add 2^-8 of the magnitudes to
    each gradient's bound; the same values given in f32 keep the f32 bound
    (same reference, so the output-rounding term is the same on both
    sides)."""
    qb, kb, vb, dob = _inputs((1, 4, 2, 24, 64), seed=5, dtype=torch.bfloat16)
    ob = fa.flash_attention_plain(qb, kb, vb)
    ref = fa.flash_attention_backward_plain(qb, kb, vb, ob, dob)
    wide = fa.backward_tolerance(qb, kb, vb, ob, dob, ref)
    narrow = fa.backward_tolerance(*(t.float() for t in (qb, kb, vb, ob, dob)),
                                   ref)
    for w, n in zip(wide, narrow):
        assert bool((w >= n).all()) and float((w - n).max()) > 0
