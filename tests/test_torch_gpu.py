"""The port's CUDA kernels on the card (``gpu`` marker; each test skips
without one).  This file imports neither ``jax`` nor ``repro``, so it also
runs on a machine with only PyTorch:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

Tolerances: the fused update and the gather do the plain versions' IEEE
operations in the same order, so they must match bit for bit; the dense
mix sums its n products in its own order (ascending k, one FMA each), 1e-6
of the output's magnitude in f32 and one bf16 ulp of it with a bf16 bank.  Flash attention sums scores,
its softmax denominator and P.V in its own order (online, tile by tile):
2e-5 absolute in f32 on outputs of magnitude about 1.  In bf16 the kernel
also rounds P to bf16 before P.V on the tensor cores:
``flash_attention.bf16_tolerance`` (2e-5 + 2^-8 max|v| over the row's open
keys + 2^-7 |out|; its docstring derives it).  The flash backward computes
in f32 from the same values as its plain version, in another order, and in
bf16 at hd 64, 80 and 128 rounds P^T and dS to bf16 before the tensor-core
products: ``flash_attention.backward_tolerance`` (derived in its
docstring).
"""
import pytest
import torch

from repro_torch.core import (ChurnModel, FLTrainer, LinkModel,
                              TopologyConfig, make_algo)
from repro_torch.data.dirichlet import dirichlet_partition, stack_client_data
from repro_torch.data.synthetic import make_dataset
from repro_torch.kernels import build
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import fused_update as fu
from repro_torch.kernels import gossip_gather as gg
from repro_torch.kernels import gossip_matmul as gm
from repro_torch.models.small import mnist_2nn

BF16_ULP = 2.0 ** -7

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels run only there")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
def test_cuda_kernels_match_their_plain_versions(cuda_device, dt):
    g = torch.Generator(device=cuda_device).manual_seed(0)
    for n, d in [(100, 4099), (7, 1001), (5, 3)]:
        X = torch.randn(n, d, generator=g, device=cuda_device).to(dt)
        V = torch.randn(n, d, generator=g, device=cuda_device)
        G = torch.randn(n, d, generator=g, device=cuda_device).to(dt)
        w = torch.rand(n, generator=g, device=cuda_device) + 0.5
        for a, b in zip(fu.fused_update_bank(X, V, G, 0.9, 0.1, w),
                        fu.fused_update_bank_plain(X, V, G, 0.9, 0.1, w)):
            assert torch.equal(a, b)
        P = torch.rand(n, n, generator=g, device=cuda_device)
        P = P / P.sum(0, keepdim=True)
        scale = gm.gossip_matmul_plain(P, X).float().abs().max()
        assert (gm.gossip_matmul(P, X).float()
                - gm.gossip_matmul_plain(P, X).float()).abs().max() <= (
                    1e-6 * scale if dt == torch.float32 else BF16_ULP * scale)
        idx = torch.randint(0, n, (n, 6), generator=g, device=cuda_device,
                            dtype=torch.int32)
        wgt = torch.rand(n, 6, generator=g, device=cuda_device)
        wgt[:, -2:] = 0.0
        assert torch.equal(gg.gossip_gather(idx, wgt, X),
                           gg.gossip_gather_plain(idx, wgt, X))
    torch.cuda.synchronize()


# The mixes' tilings straddle n = 1, 9 (rows padded to 8), 100 (the paper's),
# 128 (the last n of the dense mix's resident kernel) and 129 (the first
# past it); D = 3, 4097, 4098 and 4099 puts the rows' starts at 1, 2 and 3
# (mod 4) elements, so off 16 bytes.  Each shape runs on a bank that
# starts at its allocation and on one that starts a row later (a view).
MIX_SHAPES = [(n, d) for n in (1, 9, 100, 128, 129)
              for d in (3, 4097, 4098, 4099)]


def _banks(g, n, d, dt, device):
    whole = torch.randn(n + 1, d, generator=g, device=device).to(dt)
    return whole[:n], whole[1:]


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,d", MIX_SHAPES + [(512, 4099)])  # 512: tiled
def test_cuda_gossip_matmul_at_tiling_boundaries(cuda_device, dt, n, d):
    g = torch.Generator(device=cuda_device).manual_seed(n * 10007 + d)
    P = torch.rand(n, n, generator=g, device=cuda_device)
    P = P / P.sum(0, keepdim=True)
    for X in _banks(g, n, d, dt, cuda_device):
        want = gm.gossip_matmul_plain(P, X).float()
        scale = want.abs().max()
        err = (gm.gossip_matmul(P, X).float() - want).abs().max()
        assert err <= (1e-6 if dt == torch.float32 else BF16_ULP) * scale


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,d", MIX_SHAPES + [(8192, 64)])  # 8192: row kernel
def test_cuda_gossip_gather_at_tiling_boundaries(cuda_device, dt, n, d):
    g = torch.Generator(device=cuda_device).manual_seed(n * 10007 + d)
    idx = torch.randint(0, n, (n, 11), generator=g, device=cuda_device,
                        dtype=torch.int32)
    wgt = torch.rand(n, 11, generator=g, device=cuda_device)
    wgt[:, -2:] = 0.0
    for X in _banks(g, n, d, dt, cuda_device):
        assert torch.equal(gg.gossip_gather(idx, wgt, X),
                           gg.gossip_gather_plain(idx, wgt, X))


def test_cuda_gather_shapes_select_both_its_kernels(cuda_device):
    """The shapes above reach both kernels of the gather: its panel kernel
    at n = 100 and 129 (a panel width) and its row kernel at n = 8192 (0).
    f32 takes no panel narrower than 32 columns: the paged round's compact
    bank (n = 1280, 5 slots) takes the row kernel, where bf16 keeps its
    8-column panels."""
    lib = build.load_library()
    for dtype in (0, 1):  # f32, bf16
        for n in (100, 129):
            assert lib.gossip_gather_panel_cols(dtype, n, n, 11) >= 32
        assert lib.gossip_gather_panel_cols(dtype, 8192, 8192, 11) == 0
    assert lib.gossip_gather_panel_cols(0, 1280, 1280, 5) == 0
    assert lib.gossip_gather_panel_cols(0, 600, 600, 11) == 0
    assert lib.gossip_gather_panel_cols(1, 1280, 1280, 5) == 8


def test_cuda_wrappers_raise_on_what_their_kernels_do_not_take(cuda_device):
    """A CUDA tensor goes to the kernel or the wrapper raises: it never
    falls back to the plain version, and a refused call launches nothing."""
    X = torch.randn(4, 8, device=cuda_device)
    w = torch.ones(4, device=cuda_device)
    idx = torch.zeros(4, 2, dtype=torch.int32, device=cuda_device)
    wgt = torch.ones(4, 2, device=cuda_device)
    refused = [
        lambda: fu.fused_update_bank(X.double(), X, X, 0.9, 0.1, w),
        lambda: fu.fused_update_bank(X, X, X.bfloat16(), 0.9, 0.1, w),
        lambda: fu.fused_update_bank(X.t(), X.t(), X.t(), 0.9, 0.1,
                                     torch.ones(8, device=cuda_device)),
        lambda: gm.gossip_matmul(torch.eye(4, device=cuda_device).double(), X),
        lambda: gm.gossip_matmul(torch.eye(4), X),
        lambda: gg.gossip_gather(idx.long(), wgt, X),
        lambda: gg.gossip_gather(idx, wgt[:, :1], X),
    ]
    before = (fu.launches, gm.launches, gg.launches)
    for call in refused:
        with pytest.raises((TypeError, ValueError)):
            call()
    assert (fu.launches, gm.launches, gg.launches) == before


def test_cuda_one_row_update_counts_a_row_launch(cuda_device):
    """The one-row update is the (1, D) launch of the bank kernel: it moves
    both counts, a launch over several rows only the bank's."""
    from repro_torch.kernels import ops

    x = torch.randn(1001, device=cuda_device)
    before = (fu.launches, fu.row_launches)
    ops.fused_update(x, x, x, 0.9, 0.1, 0.7)
    assert (fu.launches - before[0], fu.row_launches - before[1]) == (1, 1)
    X = torch.randn(3, 1001, device=cuda_device)
    fu.fused_update_bank(X, X, X, 0.9, 0.1, torch.ones(3, device=cuda_device))
    assert (fu.launches - before[0], fu.row_launches - before[1]) == (2, 1)


@pytest.mark.parametrize("gossip", ["dense", "sparse"])
def test_cuda_round_launches_the_kernels_and_keeps_the_mass(cuda_device,
                                                            gossip):
    train, _ = make_dataset("mnist", 1200, 100, seed=0)
    parts = dirichlet_partition(train["y"], 8, alpha=0.3, seed=0)
    cdata = stack_client_data(train, parts, pad_to=128)
    model = mnist_2nn()
    tr = FLTrainer(model.loss, model.init, cdata,
                   make_algo("dfedsgpsm", local_steps=3),
                   TopologyConfig(kind="kout", n_clients=8, k_out=2), seed=0,
                   gossip=gossip, device=cuda_device)
    mix = gg if gossip == "sparse" else gm
    before = (fu.launches, mix.launches)
    metrics = tr.run_round()
    assert (fu.launches - before[0], mix.launches - before[1]) == (3, 1)
    assert torch.isfinite(metrics["loss"])
    assert abs(float(tr.state.w.sum()) - 8.0) <= 1e-5


@pytest.mark.parametrize("gossip", ["dense", "sparse"])
@pytest.mark.parametrize("scenario", [
    dict(algo=dict(compressor="topk_ef"), link=LinkModel(drop=0.2, delay=2),
         churn=ChurnModel(fail_prob=0.3, recover_prob=0.5,
                          resurrect="cold")),
    dict(algo=dict(compressor="int8_rows", solver="proximal"),
         link=LinkModel(event_threshold=1.0, event_decay=0.9)),
    dict(delta=8, bank_dtype=torch.bfloat16),
], ids=["topk-drop-delay-churn", "int8-event-proximal", "delta-bf16"])
def test_cuda_scenario_round_launches_the_kernels_and_keeps_the_mass(
        cuda_device, gossip, scenario):
    """One round per local step of the fused update and one mix launch per
    delay slice (B + 1 under a delay bound B), push-sum mass n with the
    in-flight shares."""
    train, _ = make_dataset("mnist", 1200, 100, seed=0)
    parts = dirichlet_partition(train["y"], 8, alpha=0.3, seed=0)
    cdata = stack_client_data(train, parts, pad_to=128)
    model = mnist_2nn()
    kw = dict(scenario)
    tr = FLTrainer(model.loss, model.init, cdata,
                   make_algo("dfedsgpsm", local_steps=3, **kw.pop("algo", {})),
                   TopologyConfig(kind="kout", n_clients=8, k_out=2), seed=0,
                   gossip=gossip, device=cuda_device, **kw)
    mix = gg if gossip == "sparse" else gm
    link = kw.get("link")
    mixes = link.delay + 1 if link is not None and link.delay else 1
    for _ in range(2):
        before = (fu.launches, mix.launches)
        metrics = tr.run_round()
        assert (fu.launches - before[0], mix.launches - before[1]) == (3, mixes)
        assert torch.isfinite(metrics["loss"])
        mass = float(metrics.get("w_mass", tr.state.w.sum()))
        assert abs(mass - 8.0) <= 1e-5


def _flash_within_tolerance(q, k, v, causal, window):
    got = fa.flash_attention(q, k, v, causal, window)
    want = fa.flash_attention_plain(q, k, v, causal, window)
    err = (got.float() - want.float()).abs()
    tol = (fa.bf16_tolerance(v, want, causal, window)
           if q.dtype == torch.bfloat16 else 2e-5)
    assert got.dtype == q.dtype and got.shape == q.shape
    return bool((err <= tol).all()), float(err.max())


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd", fa.HEAD_DIMS)
def test_cuda_flash_attention_matches_its_plain_version(cuda_device, dt, hd):
    """Every head dim, GQA groups 1, 2 and 4, causal with and without a
    window and non-causal, at ragged lengths (keys past S closed, rows past
    S not stored) and at block multiples."""
    g = torch.Generator(device=cuda_device).manual_seed(hd)
    for s in (1, 12, 100, 128, 200):
        for h, kv in ((4, 4), (4, 2), (8, 2)):
            q = torch.randn(2, h, s, hd, generator=g, device=cuda_device).to(dt)
            k = torch.randn(2, kv, s, hd, generator=g, device=cuda_device).to(dt)
            v = torch.randn(2, kv, s, hd, generator=g, device=cuda_device).to(dt)
            for causal, window in ((True, 0), (True, 33), (False, 0),
                                   (False, 70)):
                ok, err = _flash_within_tolerance(q, k, v, causal, window)
                assert ok, (s, h, kv, causal, window, err)
    torch.cuda.synchronize()


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
def test_cuda_flash_backward_refuses_an_unbuilt_head_dim(cuda_device, dt):
    """At a head dim the backward is not built for (96) it raises, naming
    what is missing, and launches nothing."""
    q, k, v = (torch.randn(1, 4, 30, 96, device=cuda_device).to(dt)
               for _ in range(3))
    before = fa.backward_launches
    with pytest.raises(NotImplementedError, match="head dim 96"):
        fa.flash_attention_backward(q, k, v, q, q, False, 0)
    assert fa.backward_launches == before


@pytest.mark.parametrize("hd", fa.BACKWARD_HEAD_DIMS)
def test_backward_shares_mirror_the_c_entry_point(cuda_device, hd):
    """:func:`flash_attention.backward_shares` (``BWD_TILE_ROWS``, 132 SMs)
    gives what ``flash_attention_backward_shares`` (``tc::split_for``) gives
    on an H100 SXM, at both dtypes, gemma3-12b's and glm4-9b's training
    shapes and a few small ones."""
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    assert sms == 132, f"the mirror assumes an H100 SXM's 132 SMs, not {sms}"
    lib = build.load_library()
    for dt in (torch.float32, torch.bfloat16):
        for b, h, kv, s in ((1, 16, 8, 2048), (1, 16, 8, 4096), (1, 32, 2, 4096),
                            (2, 16, 1, 200), (1, 8, 4, 33), (4, 25, 5, 2176)):
            with torch.cuda.device(cuda_device):
                want = lib.flash_attention_backward_shares(
                    build.DTYPE_CODES[dt], hd, b, h, kv, s)
            assert fa.backward_shares(dt, hd, b, h, kv, s) == want, (
                dt, b, h, kv, s)


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd", fa.BACKWARD_HEAD_DIMS)
def test_cuda_flash_backward_matches_its_plain_version(cuda_device, dt, hd):
    """The backward kernel (dq, dk, dv from q, k, v, o and dO) against
    :func:`flash_attention_backward_plain` within
    :func:`flash_attention.backward_tolerance`, at every head dim it is
    built for (``BACKWARD_HEAD_DIMS``), GQA
    groups 1, 4 and 16, the four mask modes, ragged lengths; and through
    ``torch.autograd`` on strided views, one backward launch a call.  bf16
    at hd 256 runs the tensor-core passes (64-row tiles split between the
    warpgroups) also at ragged S = 33 and 2049 and GQA groups 1, 2 and 16:
    the lse pass, D, dK / dV, the shares' sum where the group is split,
    dQ."""
    g = torch.Generator(device=cuda_device).manual_seed(hd + 1)
    wide = dt == torch.bfloat16 and hd == 256
    if wide:
        assert fa.on_tensor_cores(dt, hd)
    lib = build.load_library() if wide else None
    for s in (1, 12, 100, 200) + ((33, 2049) if wide else ()):
        groups = ((4, 4), (8, 2), (16, 1)) + (((8, 8), (8, 4))
                                               if wide else ())
        for h, kv in groups:
            q, k, v = (torch.randn(2, n, s, hd, generator=g,
                                   device=cuda_device).to(dt)
                       for n in (h, kv, kv))
            do = torch.randn(2, h, s, hd, generator=g,
                             device=cuda_device).to(dt)
            for causal, window in ((True, 0), (True, 33), (False, 0),
                                   (False, 70)):
                o = fa.flash_attention_plain(q, k, v, causal, window)
                want = fa.flash_attention_backward_plain(q, k, v, o, do,
                                                         causal, window)
                before = fa.backward_launches
                kernels = fa.backward_kernel_launches
                got = fa.flash_attention_backward(q, k, v, o, do, causal,
                                                  window)
                assert fa.backward_launches == before + 1
                if wide:
                    shares = lib.flash_attention_backward_shares(
                        1, hd, 2, h, kv, s)
                    assert (fa.backward_kernel_launches - kernels
                            == 4 + (shares > 1)), (s, h, kv)
                tol = fa.backward_tolerance(q, k, v, o, do, want, causal,
                                            window)
                for a, b, t in zip(got, want, tol):
                    assert a.dtype == dt and a.shape == b.shape
                    assert bool(((a.float() - b.float()).abs() <= t).all()), (
                        s, h, kv, causal, window)
    x = torch.randn(1, 40, 8, hd, generator=g, device=cuda_device).to(dt)
    kx = torch.randn(1, 40, 2, hd, generator=g, device=cuda_device).to(dt)
    q, k, v = (t.transpose(1, 2).requires_grad_() for t in (x, kx, kx * 0.5))
    out = fa.flash_attention(q, k, v, True, 0)
    grads = torch.autograd.grad(out.float().square().sum(), (q, k, v))
    want = fa.flash_attention_backward_plain(
        q.detach(), k.detach(), v.detach(), out.detach(), 2 * out.detach())
    for a, b, t in zip(grads, want, fa.backward_tolerance(
            q.detach(), k.detach(), v.detach(), out.detach(),
            2 * out.detach(), want)):
        assert bool(((a.float() - b.float()).abs() <= t).all())
    torch.cuda.synchronize()


@pytest.mark.parametrize("hd", [64, 128])
def test_cuda_flash_backward_uses_the_forward_lse_through_autograd(
        cuda_device, hd):
    """bf16 through ``torch.autograd`` on the (B, S, H, hd) projections'
    transposed views: the forward kernel's lse within
    :func:`flash_attention.lse_tolerance` of the plain one, the gradients
    within the widened :func:`flash_attention.backward_tolerance` (with the
    forward's bound as ``o_err``), and one backward call launching the
    tensor-core passes with the forward's lse: D, dK / dV, the sum of the
    group's runs, dQ (4 kernels; 5 would mean a recomputed lse)."""
    g = torch.Generator(device=cuda_device).manual_seed(hd + 7)
    x = torch.randn(2, 300, 8, hd, generator=g, device=cuda_device).bfloat16()
    kx = torch.randn(2, 300, 2, hd, generator=g, device=cuda_device).bfloat16()
    do = torch.randn(2, 8, 300, hd, generator=g, device=cuda_device).bfloat16()
    q, k, v = (t.transpose(1, 2).requires_grad_() for t in (x, kx, kx * 0.5))
    qd, kd, vd = (t.detach() for t in (q, k, v))
    for causal, window in ((True, 0), (True, 33), (False, 70)):
        _, lse = fa.flash_attention_with_lse(qd, kd, vd, causal, window)
        o_plain, lse_plain = fa.flash_attention_plain(qd, kd, vd, causal,
                                                      window, return_lse=True)
        assert bool(((lse - lse_plain).abs() <= fa.lse_tolerance(
            qd, kd, lse_plain, causal, window)).all())
        calls, kernels = fa.backward_launches, fa.backward_kernel_launches
        out = fa.flash_attention(q, k, v, causal, window)
        grads = torch.autograd.grad(out, (q, k, v), do)
        assert fa.backward_launches == calls + 1
        assert fa.backward_kernel_launches == kernels + 4
        want = fa.flash_attention_backward_plain(qd, kd, vd, o_plain, do,
                                                 causal, window)
        o_err = fa.bf16_tolerance(vd, o_plain, causal, window)
        for a, b, t in zip(grads, want, fa.backward_tolerance(
                qd, kd, vd, o_plain, do, want, causal, window, o_err=o_err)):
            assert a.dtype == torch.bfloat16 and a.shape == b.shape
            assert bool(((a.float() - b.float()).abs() <= t).all()), (
                causal, window)
    torch.cuda.synchronize()


@pytest.mark.parametrize("s", [300, 1000])
def test_cuda_flash_attention_bf16_group16_ragged(cuda_device, s):
    """glm4-9b's GQA group of 16 at hd 128, at lengths that are no multiple
    of the 128-row query tile, causal with and without a window."""
    g = torch.Generator(device=cuda_device).manual_seed(s)
    q = torch.randn(1, 32, s, 128, generator=g, device=cuda_device).bfloat16()
    k = torch.randn(1, 2, s, 128, generator=g, device=cuda_device).bfloat16()
    v = torch.randn(1, 2, s, 128, generator=g, device=cuda_device).bfloat16()
    for causal, window in ((True, 0), (True, 100), (False, 0)):
        ok, err = _flash_within_tolerance(q, k, v, causal, window)
        assert ok, (s, causal, window, err)
    torch.cuda.synchronize()


@pytest.mark.parametrize("dt,kernel", [(torch.float32, "simt::"),
                                       (torch.bfloat16, "tc::")])
def test_cuda_flash_attention_runs_the_kernel_of_its_dtype(cuda_device, dt,
                                                           kernel):
    """bf16 runs the tensor-core kernel (namespace tc) and f32 the SIMT one,
    by the names of the device kernels that the profiler sees."""
    from torch.autograd import DeviceType

    q = torch.randn(1, 2, 200, 128, device=cuda_device).to(dt)
    with torch.profiler.profile() as prof:
        fa.flash_attention(q, q[:, :1], q[:, :1], True, 0)
        torch.cuda.synchronize()
    names = [e.key for e in prof.key_averages()
             if e.device_type == DeviceType.CUDA
             and "flash_attention_kernel" in e.key]
    assert names and all(kernel + "flash_attention_kernel" in n
                         for n in names), names


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
def test_cuda_flash_attention_reads_strided_views(cuda_device, dt):
    """The (B,S,H,hd) projections' transpose(1, 2) views give the same
    output as contiguous copies, laid out like q's view."""
    g = torch.Generator(device=cuda_device).manual_seed(1)
    q = torch.randn(2, 70, 8, 128, generator=g, device=cuda_device).to(dt)
    kv = torch.randn(2, 70, 2, 128, generator=g, device=cuda_device).to(dt)
    qt, kt = q.transpose(1, 2), kv.transpose(1, 2)
    got = fa.flash_attention(qt, kt, kt, True, 16)
    want = fa.flash_attention(qt.contiguous(), kt.contiguous(),
                              kt.contiguous(), True, 16)
    assert got.stride() == qt.stride()
    assert torch.equal(got, want)


def test_cuda_flash_attention_refuses_what_it_does_not_take(cuda_device):
    """No kernel for other head dims, no bf16 input that TMA cannot load
    (an s-stride that is no multiple of 8 elements, a base off 16 bytes),
    and no backward of an output or gradient of another shape: the wrapper
    raises and launches nothing, it never falls back to the plain version.
    (Inputs that require grad were refused before the backward kernel.)"""
    q = torch.randn(1, 2, 8, 64, device=cuda_device)
    # s-stride 68 elements: hd = 64 contiguous inside rows of 68.
    odd = torch.randn(1, 2, 8, 68, device=cuda_device).bfloat16()[..., :64]
    flat = torch.randn(2 * 8 * 64 + 1, device=cuda_device).bfloat16()
    shifted = flat[1:].view(1, 2, 8, 64)  # starts 2 bytes past 16
    refused = [
        lambda: fa.flash_attention_backward(q, q, q, q, q[:, :, :4]),
        lambda: fa.flash_attention(torch.randn(1, 2, 8, 96, device=cuda_device),
                                   *(torch.randn(1, 2, 8, 96,
                                                 device=cuda_device),) * 2),
        lambda: fa.flash_attention(q, q[:, :1].cpu(), q[:, :1]),
        lambda: fa.flash_attention(q.half(), q.half(), q.half()),
        lambda: fa.flash_attention(q, q[:, :, :4], q[:, :, :4]),
        lambda: fa.flash_attention(torch.randn(1, 3, 8, 64, device=cuda_device),
                                   q, q),
        lambda: fa.flash_attention(odd, odd, odd),
        lambda: fa.flash_attention(shifted, shifted, shifted),
    ]
    before = fa.launches, fa.backward_launches
    for call in refused:
        with pytest.raises((RuntimeError, TypeError, ValueError)):
            call()
    assert (fa.launches, fa.backward_launches) == before


def _mnist_clients(n):
    train, _ = make_dataset("mnist", 1200, 100, seed=0)
    parts = dirichlet_partition(train["y"], n, alpha=0.3, seed=0)
    return stack_client_data(train, parts, pad_to=64)


def _within_flips(got, want, what, rows):
    """Every coordinate within 1e-5 of the bank's largest magnitude but in
    at most ``rows`` rows, and none beyond 2e-2 of that magnitude.  A ReLU
    unit that flips in one client's local steps moves that client's
    momentum row (on an H100 one flip moved 4,550 of its 199,210
    coordinates beyond 1e-5, by at most 1.2e-3 of the magnitude) and,
    through the mix, the params rows it sends to; a wrong update moves
    every active row."""
    scale = float(want.abs().max())
    err = (got - want).abs()
    beyond = (err > 1e-5 * scale).sum(dim=1)
    print(f"{what}: max|err| {float(err.max()):.3e} (scale {scale:.3e}); "
          f"coordinates beyond 1e-5 of it per row: {beyond.tolist()}")
    assert int((beyond > 0).sum()) <= rows, what
    assert float(err.max()) <= 2e-2 * scale, what


def test_cuda_paged_round_matches_the_cpu_on_the_same_draws(cuda_device,
                                                            tmp_path,
                                                            monkeypatch):
    """The paged chain runs on CPU generators, so the card and the CPU
    replay the same schedule.  Each round's compact step gets the CPU's
    slots, active clients' data and minibatch indices bit for bit, and
    round 0's staged params, momentum and w too; each card round launches
    one update per local step and one gather, and that gather is the plain
    gather of the card's own bank on the CPU's slots, bit for bit.  ``w``
    is bit for bit where it is staged in round 1, and within 2^-22 of its
    magnitude (two ulps) in every row after 2 rounds.  The params and
    momentum (staged in round 1, and after 2 rounds) are held to the flip
    bound of ``_within_flips`` for one flipped client, not to rounding
    everywhere: a ReLU unit whose pre-activation lies within rounding of
    zero flips its mask on one device only (phase 4 of ``chip_smoke.py``
    holds a full round to 1e-5 where no unit flips)."""
    import numpy as np

    from repro_torch.core import make_program
    from repro_torch.kernels import ops
    from repro_torch.store import PagedRunner

    n, cdata, model = 16, _mnist_clients(16), mnist_2nn()
    algo = make_algo("dfedsgpsm", local_steps=3, lr=0.01)
    topo = TopologyConfig(kind="kout", n_clients=n, k_out=2)
    # One flipped client: its momentum row, and its params row with the
    # k_out rows it sends to.
    flips = {"mom": 1, "params": 1 + topo.k_out}
    runners, seen, mixes = {}, {}, {}
    mix_sparse = ops.gossip_mix_sparse

    def spy_mix(idx, wgt, M, *executor):
        out = mix_sparse(idx, wgt, M, *executor)
        mixes.setdefault(M.device.type, []).append(
            {"idx": idx.cpu(), "wgt": wgt.cpu(), "M": M.cpu().clone(),
             "out": out.cpu()})
        return out

    monkeypatch.setattr(ops, "gossip_mix_sparse", spy_mix)
    for dev in ("cpu", cuda_device):
        name = torch.device(dev).type
        prog = make_program(model.loss, model.init, cdata, algo, topo,
                            gossip="dense", device=dev)
        step = prog.step_active

        def spy(state, slots, data_active, *, k_active, draws=None,
                _name=name, _step=step):
            g = torch.Generator()
            g.set_state(state.key.get_state())
            seen.setdefault(_name, []).append({
                "params": state.params.cpu().clone(),
                "mom": state.mom.cpu().clone(), "w": state.w.cpu().clone(),
                "idx": slots.idx.cpu(), "wgt": slots.wgt.cpu(),
                "ids": slots.ids.cpu(),
                **{k: v.cpu() for k, v in data_active.items()},
                "batch": torch.randint(
                    0, data_active["x"].shape[1],
                    (algo.local_steps, k_active, algo.batch_size),
                    generator=g)})
            return _step(state, slots, data_active, k_active=k_active,
                         draws=draws)

        object.__setattr__(prog, "step_active", spy)
        runners[name] = PagedRunner(prog, str(tmp_path / name), k_active=4,
                                    seed=2, rows_per_chunk=4)
    for _ in range(2):
        runners["cpu"].run_round()
        before = (fu.launches, gg.launches, gm.launches)
        rec = runners["cuda"].run_round()
        assert (fu.launches - before[0], gg.launches - before[1],
                gm.launches - before[2]) == (3, 1, 0)
        assert rec["w_mass_closure_err"] <= 1e-5
    a = seen["cpu"][0]
    for k, v in seen["cuda"][0].items():
        assert torch.equal(v, a[k]), k
    b, a = seen["cuda"][1], seen["cpu"][1]
    for k in ("idx", "wgt", "ids", "x", "y", "batch", "w"):
        assert torch.equal(b[k], a[k]), k
    for k in ("params", "mom"):
        _within_flips(b[k], a[k], f"round 1's staged {k}", flips[k])
    assert len(mixes["cuda"]) == len(mixes["cpu"]) == 2
    for got, want in zip(mixes["cuda"], mixes["cpu"]):
        for k in ("idx", "wgt"):
            assert torch.equal(got[k], want[k]), k
        assert torch.equal(got["out"], gg.gossip_gather_plain(
            got["idx"], got["wgt"], got["M"])), "the card's mix"
    ids = np.arange(n)
    a = runners["cpu"].read_rows(ids)
    b = runners["cuda"].read_rows(ids)
    # The w mix is a plain torch.sum over each row's k_out + 1 = 3 slot
    # products, which the card sums in another order: one element one ulp
    # apart after 2 rounds on an H100.
    np.testing.assert_allclose(b["w"], a["w"], rtol=0,
                               atol=2.0 ** -22 * float(abs(a["w"]).max()))
    for k in ("params", "mom"):
        _within_flips(torch.from_numpy(b[k]), torch.from_numpy(a[k]),
                      f"{k} after 2 rounds", flips[k])
    assert abs(runners["cuda"].total_mass() - n) <= 1e-5 * n
    for r in runners.values():
        r.close()


def test_cuda_checkpoint_restores_bit_for_bit(cuda_device, tmp_path):
    """A card trainer with the EF residual, the link buffers and the cold
    churn carry: the file holds its arrays bit for bit, a fresh card
    trainer restores them and its three generators exactly and the next
    round is the same; the card's generators do not restore on the CPU
    unless the caller passes CPU ones."""
    import numpy as np

    from repro_torch import checkpoint

    cdata, model = _mnist_clients(8), mnist_2nn()

    def trainer(seed):
        return FLTrainer(
            model.loss, model.init, cdata,
            make_algo("dfedsgpsm", local_steps=2, compressor="topk_ef"),
            TopologyConfig(kind="kout", n_clients=8, k_out=2), seed=seed,
            gossip="sparse", link=LinkModel(drop=0.2, delay=2),
            churn=ChurnModel(fail_prob=0.2, recover_prob=0.5,
                             resurrect="cold"), device=cuda_device)

    tr = trainer(0)
    tr.run_round()
    path = tr.save(str(tmp_path), 1)
    bank, extra, _ = checkpoint.restore_bank(path)
    np.testing.assert_array_equal(bank, tr.state.params.cpu().numpy())
    np.testing.assert_array_equal(extra["link_bufx"],
                                  tr.state.link.bufx.cpu().numpy())
    np.testing.assert_array_equal(extra["comp"], tr.state.comp.cpu().numpy())
    fresh = trainer(5)
    st = fresh.restore(path)
    for k in ("params", "mom", "w", "losses", "comp"):
        assert torch.equal(getattr(st, k), getattr(tr.state, k)), k
    for a, b in ((st.key, tr.state.key), (st.link.key, tr.state.link.key),
                 (st.churn.key, tr.state.churn.key)):
        assert torch.equal(a.get_state(), b.get_state())
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        tr.run_round()
        fresh.run_round()
    finally:
        torch.backends.cudnn.deterministic = prev
    for k in ("params", "mom", "w"):
        assert torch.equal(getattr(fresh.state, k), getattr(tr.state, k)), k
    with pytest.raises(ValueError, match="cuda generator"):
        checkpoint.restore_state(path, tr.spec, "cpu")
    cpu = checkpoint.restore_state(
        path, tr.spec, "cpu", key=torch.Generator(),
        link_key=torch.Generator(), churn_key=torch.Generator())
    np.testing.assert_array_equal(cpu.params.numpy(), bank)
