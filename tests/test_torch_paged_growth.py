"""The paged round at lr 0.1, where the loss grows, in both packages.

``chip_smoke.py`` phase 10 (mnist_2nn, n = 4096, k_active = 256, kout
k_out = 4, DFedSGPSM with 5 local steps) saw the active clients' mean
loss grow past 1e4 by the third round at the default lr 0.1, and runs at
lr 0.01.  This test is the CPU witness that the growth is the algorithm's
at that setting and not the port's: at the same ratios scaled down
(n = 512, k_active = 32, kout k_out = 4, the same model at full width,
synthetic MNIST by Dirichlet(0.3), 32 rows a client) the reference's
``ResidentDriver`` (the paged round's fully resident twin: the same
chain, closure and operator) and the port's, from the reference's init
row and on its draws, give the same losses round by round (1e-5
relative: the draw-exact tolerance of the round-parity tests) while the
loss grows by more than 1e3.  Push-sum explains it: a cold in-neighbour
sends mass without training, so a client can come back active with a
small weight w, and the de-biased step of a client is lr / w.  The
smallest w among the round's active clients is printed beside each
round, and must fall below 0.1.
"""
import torch

from repro.core import TopologyConfig as RefTopo
from repro.core import make_algo as ref_make_algo
from repro.core import make_program as ref_make_program
from repro.data.dirichlet import dirichlet_partition, stack_client_data
from repro.data.synthetic import make_dataset
from repro.models.small import mnist_2nn as ref_mnist_2nn
from repro.store import ResidentDriver as RefDriver
from repro_torch.core import TopologyConfig, make_algo, make_program
from repro_torch.models.small import mnist_2nn
from repro_torch.store import ResidentDriver
from test_torch_paged import ref_round_draws
from _torch_threads import one_thread  # noqa: F401,E402  (an autouse fixture)

N, K_ACTIVE, K_OUT, ROUNDS = 512, 32, 4, 4


def test_paged_loss_grows_alike_in_both_packages_at_lr_01():
    train, _ = make_dataset("mnist", 60_000 * N // 4096, 100, seed=0)
    parts = dirichlet_partition(train["y"], N, alpha=0.3, seed=0)
    cdata = stack_client_data(train, parts, pad_to=32)
    kw = dict(local_steps=5, batch_size=32, lr=0.1)
    ref_model, model = ref_mnist_2nn(), mnist_2nn()
    ref = RefDriver(
        ref_make_program(ref_model.loss, ref_model.init, cdata,
                         ref_make_algo("dfedsgpsm", **kw),
                         RefTopo(kind="kout", n_clients=N, k_out=K_OUT),
                         gossip="dense"),
        K_ACTIVE, seed=0)
    prog = make_program(model.loss, model.init, cdata,
                        make_algo("dfedsgpsm", **kw),
                        TopologyConfig(kind="kout", n_clients=N, k_out=K_OUT),
                        gossip="dense", device="cpu")
    active_w = []
    update = prog.solver.update

    def spy(loss_fn, spec, params, w, *args, **kwargs):
        active_w.append(float(w.min()))
        return update(loss_fn, spec, params, w, *args, **kwargs)

    object.__setattr__(prog.solver, "update", spy)
    port = ResidentDriver(prog, K_ACTIVE, seed=0)
    port.state = port.state._replace(
        params=torch.tensor(ref.state.params.__array__()))
    losses = []
    for t in range(ROUNDS):
        draws = ref_round_draws(ref)
        want = ref.run_round()
        got = port.run_round(draws)
        print(f"round {t}: loss {want['loss']:.6g} (reference) "
              f"{got['loss']:.6g} (port); smallest active w "
              f"{active_w[-1]:.4g}, so a de-biased step of "
              f"{kw['lr'] / active_w[-1]:.4g}")
        assert abs(got["loss"] - want["loss"]) <= 1e-5 * max(
            abs(want["loss"]), 1.0), t
        losses.append(want["loss"])
    assert max(losses) > 1e3 * losses[0], losses
    assert min(active_w) < 0.1, active_w
    for driver in (ref, port):
        assert abs(driver.total_mass() - N) <= 1e-5 * N
