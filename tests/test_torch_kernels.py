"""The port's kernel layer against the JAX reference's, on shared numpy inputs.

Each plain PyTorch version (what a CPU tensor gets from a wrapper) is held
against both the reference's Pallas kernel in interpret mode
(``repro.kernels.ops``) and its oracle (``repro.kernels.ref``), over f32 and
bf16 banks, ragged D and zero-weight pad slots.  Tolerances, by reason:

* the plain versions do the oracle's unfused f32 operations in the same
  order, so X' and V' of the fused update equal the oracle's bit for bit;
* the interpret kernel runs under ``jit``, where XLA contracts a multiply
  and an add into one FMA: each contraction moves a result by at most an
  ulp of the terms it combined, so the bound is a few f32 ulp of the sum
  of the terms' magnitudes (elementwise), not of the result;
* a bf16 output may round the other way where the f32 values differ by
  an ulp: 1 bf16 ulp of the result (2^-7 relative) on top;
* the dense mix and the oracle's einsum sum n products in an order each
  library picks: 1e-6 of the output's magnitude in f32;
* Z' = X'·(1/w) (the kernels' multiply form) against X' / w (the oracle's
  divide form): 2 f32 ulp relative (the reciprocal rounds once more).

The CUDA kernels themselves are checked on the card (``gpu`` marker).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as ref_ops
from repro.kernels import ref as ref_ref
from repro_torch.interop import tensor_from_numpy
from repro_torch.kernels import ops, ref
from repro_torch.kernels import fused_update as fu
from repro_torch.kernels import gossip_gather as gg
from repro_torch.kernels import gossip_matmul as gm
from _torch_threads import one_thread  # noqa: F401,E402  (an autouse fixture)

F32_ULP = 2.0 ** -23
BF16_ULP = 2.0 ** -7
DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16,
                                                        torch.bfloat16)}


def _np(t):
    t = t.detach()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy()


def _close(port, want, rel, what):
    want = np.asarray(want, dtype=np.float32)
    port = np.asarray(port, dtype=np.float32)
    tol = rel * np.maximum(np.abs(want), np.float32(1e-30))
    bad = np.abs(port - want) > tol
    assert not bad.any(), (
        f"{what}: {int(bad.sum())} of {bad.size} beyond {rel:.1e} relative,"
        f" max |diff| {np.abs(port - want).max():.3e}")


def _terms(port, want, mag, dt, ulps, what):
    """|port - want| <= ulps f32-ulp of ``mag`` (the terms' magnitudes),
    plus one bf16 ulp of the result for a bf16 output."""
    want = np.asarray(want, dtype=np.float32)
    port = np.asarray(port, dtype=np.float32)
    tol = ulps * F32_ULP * mag
    if dt == "bf16":
        tol = tol + BF16_ULP * np.abs(want)
    bad = np.abs(port - want) > tol
    assert not bad.any(), (
        f"{what}: {int(bad.sum())} of {bad.size} beyond the FMA bound,"
        f" max |diff| {np.abs(port - want).max():.3e}")


def _bank_inputs(n, d, dt, seed=0):
    rng = np.random.default_rng(seed)
    jdt, _ = DTYPES[dt]
    X = np.asarray(jnp.asarray(rng.standard_normal((n, d)), jdt))
    V = rng.standard_normal((n, d)).astype(np.float32)
    G = np.asarray(jnp.asarray(rng.standard_normal((n, d)), jdt))
    w = rng.uniform(0.3, 2.0, n).astype(np.float32)
    return X, V, G, w


def _out_rel(dt):
    return BF16_ULP if dt == "bf16" else F32_ULP


# -- fused update -------------------------------------------------------------

@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("n,d", [(8, 512), (5, 1001), (3, 7)])
def test_fused_update_bank_plain_matches_reference(dt, n, d):
    X, V, G, w = _bank_inputs(n, d, dt)
    alpha, eta = 0.9, 0.05
    want_kernel = ref_ops.fused_update_bank(
        jnp.asarray(X), jnp.asarray(V), jnp.asarray(G), alpha, eta,
        jnp.asarray(w))
    want_oracle = ref_ref.fused_update_bank_ref(
        jnp.asarray(X), jnp.asarray(V), jnp.asarray(G), alpha, eta,
        jnp.asarray(w))
    got = fu.fused_update_bank_plain(
        tensor_from_numpy(X), tensor_from_numpy(V), tensor_from_numpy(G),
        alpha, eta, tensor_from_numpy(w))
    assert got[0].dtype == DTYPES[dt][1] and got[1].dtype == torch.float32
    assert got[2].dtype == DTYPES[dt][1]
    # X' and V': the oracle's unfused order, bit for bit.
    np.testing.assert_array_equal(_np(got[0]), np.asarray(want_oracle[0],
                                                           np.float32))
    np.testing.assert_array_equal(_np(got[1]), np.asarray(want_oracle[1]))
    # Against the jitted kernel (FMA-contracted): bound by the terms.
    Xf, Gf = (np.asarray(a, np.float32) for a in (X, G))
    mag_v = np.abs(alpha * V) + np.abs(Gf)
    mag_x = np.abs(Xf) + eta * mag_v
    _terms(_np(got[1]), want_kernel[1], mag_v, "f32", 2, "V' vs kernel")
    _terms(_np(got[0]), want_kernel[0], mag_x, dt, 4, "X' vs kernel")
    w_col = w[:, None]
    _terms(_np(got[2]), want_kernel[2], mag_x / w_col, dt, 6, "Z' vs kernel")
    # Z': the divide form of the oracle is one rounding away.
    _close(_np(got[2]), want_oracle[2], _out_rel(dt) if dt == "bf16"
           else 2 * F32_ULP, "Z' vs oracle (x / w)")


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_fused_update_bank_ref_is_the_divide_oracle(dt):
    X, V, G, w = _bank_inputs(6, 333, dt, seed=1)
    want = ref_ref.fused_update_bank_ref(
        jnp.asarray(X), jnp.asarray(V), jnp.asarray(G), 0.5, 0.1,
        jnp.asarray(w))
    got = ref.fused_update_bank_ref(
        tensor_from_numpy(X), tensor_from_numpy(V), tensor_from_numpy(G),
        0.5, 0.1, tensor_from_numpy(w))
    rel = _out_rel(dt)
    for i in range(3):
        _close(_np(got[i]), want[i], F32_ULP if i == 1 else rel, f"out {i}")


def test_single_row_fused_update_is_the_n1_bank_case():
    rng = np.random.default_rng(2)
    x, v, g = (rng.standard_normal(1025).astype(np.float32) for _ in range(3))
    want_kernel = ref_ops.fused_update(jnp.asarray(x), jnp.asarray(v),
                                       jnp.asarray(g), 0.9, 0.1, 0.7)
    want_oracle = ref_ref.fused_update_ref(jnp.asarray(x), jnp.asarray(v),
                                           jnp.asarray(g), 0.9, 0.1, 0.7)
    got = ops.fused_update(torch.from_numpy(x), torch.from_numpy(v),
                           torch.from_numpy(g), 0.9, 0.1, 0.7)
    assert got[0].shape == (1025,)
    np.testing.assert_array_equal(_np(got[0]), np.asarray(want_oracle[0]))
    np.testing.assert_array_equal(_np(got[1]), np.asarray(want_oracle[1]))
    mag_v = np.abs(0.9 * v) + np.abs(g)
    mag_x = np.abs(x) + 0.1 * mag_v
    for i, mag in ((0, mag_x), (1, mag_v), (2, mag_x / 0.7)):
        _terms(_np(got[i]), want_kernel[i], mag, "f32", 6, f"out {i}")
    _close(_np(got[2]), want_oracle[2], 2 * F32_ULP, "Z' vs oracle")
    port_oracle = ref.fused_update_ref(torch.from_numpy(x), torch.from_numpy(v),
                                       torch.from_numpy(g), 0.9, 0.1, 0.7)
    _close(_np(port_oracle[2]), want_oracle[2], F32_ULP, "port oracle Z'")


def test_cpu_updates_count_no_launch():
    """On the CPU both update entry points take the plain version: neither
    the bank count nor the one-row count moves."""
    x = torch.ones(7)
    before = (fu.launches, fu.row_launches)
    ops.fused_update(x, x, x, 0.9, 0.1, 0.7)
    ops.fused_update_bank(x[None], x[None], x[None], 0.9, 0.1, torch.ones(1))
    assert (fu.launches, fu.row_launches) == before


def test_ops_fused_update_bank_casts_g_to_the_bank_dtype():
    """G is cast to the bank dtype before the kernel, as the reference's
    gridded ``pallas_call`` path does (``pad(G, X.dtype)``).  Explicit
    block sizes force that path in interpret mode: the reference's
    single-block interpret shortcut skips the cast (a reference-only
    discrepancy, logged in ROADMAP.md)."""
    X, V, G, w = _bank_inputs(4, 64, "bf16", seed=3)
    G32 = np.random.default_rng(4).standard_normal((4, 64)).astype(np.float32)
    want = ref_ops.fused_update_bank(jnp.asarray(X), jnp.asarray(V),
                                     jnp.asarray(G32), 0.9, 0.1,
                                     jnp.asarray(w), block_n=4, block_d=32)
    got = ops.fused_update_bank(tensor_from_numpy(X), tensor_from_numpy(V),
                                torch.from_numpy(G32), 0.9, 0.1,
                                tensor_from_numpy(w))
    G16 = np.asarray(jnp.asarray(G32).astype(jnp.bfloat16), np.float32)
    oracle = ref_ref.fused_update_bank_ref(
        jnp.asarray(X), jnp.asarray(V), jnp.asarray(G32).astype(jnp.bfloat16),
        0.9, 0.1, jnp.asarray(w))
    for i in range(2):
        np.testing.assert_array_equal(_np(got[i]),
                                      np.asarray(oracle[i], np.float32))
    mag_v = np.abs(0.9 * V) + np.abs(G16)
    mag_x = np.abs(np.asarray(X, np.float32)) + 0.1 * mag_v
    _terms(_np(got[1]), want[1], mag_v, "f32", 2, "V'")
    _terms(_np(got[0]), want[0], mag_x, "bf16", 4, "X'")
    _terms(_np(got[2]), want[2], mag_x / w[:, None], "bf16", 6, "Z'")


# -- dense mix ----------------------------------------------------------------

def _column_stochastic(n, seed):
    P = np.random.default_rng(seed).uniform(size=(n, n)).astype(np.float32)
    return P / P.sum(axis=0, keepdims=True)


# Shapes the CUDA kernels' tilings straddle: n = 1, 9 (rows padded to 8),
# 100 (the paper's), 129 (the first past the dense mix's resident kernel);
# D = 3, 4097 and 4099 (1 and 3 mod 4: rows that start off 16 bytes).
BOUNDARY_SHAPES = [(n, d) for n in (1, 9, 100, 129) for d in (3, 4097, 4099)]


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("n,d", [(8, 256), (13, 999), *BOUNDARY_SHAPES])
def test_gossip_matmul_plain_matches_reference(dt, n, d):
    P = _column_stochastic(n, 5)
    X, _, _, _ = _bank_inputs(n, d, dt, seed=6)
    want_kernel = ref_ops.gossip_mix(jnp.asarray(P), jnp.asarray(X),
                                     use_kernel=True)
    want_oracle = ref_ref.gossip_matmul_ref(jnp.asarray(P), jnp.asarray(X))
    got = gm.gossip_matmul_plain(torch.from_numpy(P), tensor_from_numpy(X))
    got_ops = ops.gossip_mix(torch.from_numpy(P), tensor_from_numpy(X))
    assert got.dtype == DTYPES[dt][1]
    scale = float(np.abs(np.asarray(want_oracle, np.float32)).max())
    for want, what in ((want_kernel, "interpret kernel"),
                       (want_oracle, "oracle")):
        want = np.asarray(want, np.float32)
        if dt == "bf16" and (n, d) in BOUNDARY_SHAPES:
            # Some outputs at these shapes come near 0 by cancellation: the
            # sum order's 1e-6 of the output's magnitude, and one bf16 ulp of
            # the result on top.
            np.testing.assert_allclose(_np(got), want, rtol=BF16_ULP,
                                       atol=1e-6 * scale, err_msg=what)
        elif dt == "bf16":
            _close(_np(got), want, BF16_ULP, what)
        else:
            np.testing.assert_allclose(_np(got), want, rtol=0,
                                       atol=1e-6 * scale, err_msg=what)
    np.testing.assert_array_equal(_np(got_ops), _np(got))
    np.testing.assert_array_equal(
        _np(ref.gossip_matmul_ref(torch.from_numpy(P), tensor_from_numpy(X))),
        _np(got))


# -- sparse mix ---------------------------------------------------------------

def _neighbor_lists(n, k_max, seed):
    """Receiver-side lists with a self slot, duplicates and zero-weight pad
    slots, weights column-normalised over the real edges."""
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, n, size=(n, k_max)).astype(np.int32)
    idx[:, 0] = np.arange(n)
    wgt = rng.uniform(0.1, 1.0, size=(n, k_max)).astype(np.float32)
    wgt[:, -2:] = 0.0  # pad slots
    idx[:, -2:] = np.arange(n)[:, None]
    return idx, wgt


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("n,k_max,d", [(8, 5, 256), (11, 7, 1001),
                                       *((n, 11, d) for n, d in BOUNDARY_SHAPES)])
def test_gossip_gather_plain_matches_reference(dt, n, k_max, d):
    idx, wgt = _neighbor_lists(n, k_max, 7)
    X, _, _, _ = _bank_inputs(n, d, dt, seed=8)
    want_kernel = ref_ops.gossip_mix_sparse(
        jnp.asarray(idx), jnp.asarray(wgt), jnp.asarray(X), use_kernel=True)
    want_oracle = ref_ref.gossip_gather_ref(jnp.asarray(idx), jnp.asarray(wgt),
                                            jnp.asarray(X))
    got = gg.gossip_gather_plain(torch.from_numpy(idx), torch.from_numpy(wgt),
                                 tensor_from_numpy(X))
    rel = _out_rel(dt)
    # Same slot order as the interpret kernel, which contracts each
    # multiply-add: bound by the magnitudes of the k_max terms.
    mag = gg.gossip_gather_plain(torch.from_numpy(idx),
                                 torch.from_numpy(np.abs(wgt)),
                                 tensor_from_numpy(X).float().abs()).numpy()
    _terms(_np(got), want_kernel, mag, dt, 2 * k_max, "vs interpret kernel")
    # The oracle's einsum sums the k_max products in its own order.
    scale = float(np.abs(np.asarray(want_oracle, np.float32)).max())
    np.testing.assert_allclose(_np(got), np.asarray(want_oracle, np.float32),
                               rtol=rel, atol=1e-6 * scale)
    got_ops = ops.gossip_mix_sparse(torch.from_numpy(idx),
                                    torch.from_numpy(wgt),
                                    tensor_from_numpy(X))
    np.testing.assert_array_equal(_np(got_ops), _np(got))
    got_oracle = ref.gossip_gather_ref(torch.from_numpy(idx),
                                       torch.from_numpy(wgt),
                                       tensor_from_numpy(X))
    np.testing.assert_allclose(_np(got_oracle),
                               np.asarray(want_oracle, np.float32),
                               rtol=rel, atol=1e-6 * scale)


def test_gossip_gather_pad_slots_add_exactly_zero():
    idx, wgt = _neighbor_lists(6, 4, 9)
    X = np.random.default_rng(10).standard_normal((6, 50)).astype(np.float32)
    full = gg.gossip_gather_plain(torch.from_numpy(idx), torch.from_numpy(wgt),
                                  torch.from_numpy(X))
    trimmed = gg.gossip_gather_plain(torch.from_numpy(idx[:, :-2].copy()),
                                     torch.from_numpy(wgt[:, :-2].copy()),
                                     torch.from_numpy(X))
    np.testing.assert_array_equal(full.numpy(), trimmed.numpy())


# -- dispatch -----------------------------------------------------------------

@pytest.mark.parametrize("n,k_max", [(8, 2), (127, 11), (128, 11), (128, 33),
                                     (512, 128), (512, 129)])
def test_density_rule_on_cpu_matches_reference(n, k_max):
    assert ops.use_sparse_gossip(n, k_max, "cpu") == ref_ops.use_sparse_gossip(
        n, k_max)


def test_density_rule_on_cuda_uses_its_own_floor():
    floor = ops._SPARSE_GOSSIP_MIN_CLIENTS_CUDA
    density = ops._SPARSE_GOSSIP_MAX_DENSITY_CUDA
    assert ops.use_sparse_gossip(floor, max(1, int(density * floor)), "cuda")
    assert not ops.use_sparse_gossip(floor - 1, 1, "cuda")
    n = 4 * floor
    assert ops.use_sparse_gossip(n, int(density * n), "cuda")
    assert not ops.use_sparse_gossip(n, int(density * n) + 1, "cuda")


@pytest.mark.parametrize("wrapper,args", [
    (fu.fused_update_bank, lambda t: (t, t, t, 0.9, 0.1, t[:, 0])),
    (gm.gossip_matmul, lambda t: (t[:, :4], t)),
    (gg.gossip_gather, lambda t: (t[:, :2].int(), t[:, :2], t)),
])
def test_wrappers_refuse_devices_without_a_kernel(wrapper, args):
    class Elsewhere:  # a tensor on a device with neither kernel nor plan
        device = torch.device("xpu")

        def __getitem__(self, _):
            return self

        def int(self):
            return self

    with pytest.raises(ValueError, match="no .* kernel for device"):
        wrapper(*args(Elsewhere()))


@pytest.mark.parametrize("wrapper,args,shapes", [
    (fu.fused_update_bank, lambda t: (t, t, t, 0.9, 0.1,
                                      t[:, 0].contiguous()), [(4, 8)] * 3),
    (gm.gossip_matmul, lambda t: (t[:, :4].contiguous(), t), [(4, 8)]),
    (gg.gossip_gather, lambda t: (t[:, :2].int().contiguous(),
                                  t[:, :2].contiguous(), t), [(4, 8)]),
])
def test_wrappers_give_meta_tensors_the_kernels_outputs(wrapper, args, shapes):
    t = torch.empty((4, 8), device="meta")
    out = wrapper(*args(t))
    out = out if isinstance(out, tuple) else (out,)
    assert [tuple(o.shape) for o in out] == shapes
    assert all(o.device.type == "meta" for o in out)


def test_wrappers_build_nothing_on_import():
    from repro_torch.kernels import build

    assert build._lib is None
