"""The port's CUDA kernels on the card (``gpu`` marker; each test skips
without one).  This file imports neither ``jax`` nor ``repro``, so it also
runs on a machine with only PyTorch:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

Tolerances: the fused update and the gather do the plain versions' IEEE
operations in the same order, so they must match bit for bit; the dense
mix sums its n products in its own order, 1e-6 of the output's magnitude
in f32 and one bf16 ulp with a bf16 bank.
"""
import pytest
import torch

from repro_torch.core import FLTrainer, TopologyConfig, make_algo
from repro_torch.data.dirichlet import dirichlet_partition, stack_client_data
from repro_torch.data.synthetic import make_dataset
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
