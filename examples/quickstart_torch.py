"""Quickstart of the PyTorch port: train DFedSGPSM (the paper's algorithm) on
a synthetic non-IID MNIST-shaped task with 16 clients over a directed
time-varying topology, against OSGP (the asymmetric baseline it extends),
and once more with top-k sparsification and error feedback (about 5% of
the coordinates on the wire per round, same push-sum mixing).  The twin of
``examples/quickstart.py``.

  python examples/quickstart_torch.py                # on the CUDA card
  python examples/quickstart_torch.py --device cpu   # the plain versions
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

from repro_torch.core import FLTrainer, TopologyConfig, make_algo  # noqa: E402
from repro_torch.data.dirichlet import (  # noqa: E402
    dirichlet_partition,
    stack_client_data,
)
from repro_torch.data.synthetic import make_dataset  # noqa: E402
from repro_torch.models.small import mnist_2nn  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--rounds", type=int, default=20)
    args = ap.parse_args(argv)
    n_clients = 16
    train, test = make_dataset("mnist", 4000, 1000, seed=0)
    parts = dirichlet_partition(train["y"], n_clients, alpha=0.3, seed=0)
    cdata = stack_client_data(train, parts, pad_to=256)
    model = mnist_2nn()
    topo = TopologyConfig(kind="kout", n_clients=n_clients, k_out=4)

    runs = [
        ("osgp", make_algo("osgp", local_steps=5, batch_size=32)),
        ("dfedsgpsm", make_algo("dfedsgpsm", local_steps=5, batch_size=32)),
        # Same round program, compressed gossip: top-k + error feedback.
        ("dfedsgpsm+topk_ef",
         make_algo("dfedsgpsm", local_steps=5, batch_size=32,
                   compressor="topk_ef")),
    ]
    for name, algo in runs:
        tr = FLTrainer(model.loss, model.init, cdata, algo, topo, seed=0,
                       participation=0.25, device=args.device)
        tr.fit(args.rounds, test_data=test, eval_every=5, superstep=10,
               log=lambda r: print(f"  [{name}] round {r['round']:3d} "
                                   f"loss={r['loss']:.3f}"
                                   + (f" test_acc={r['test_acc']:.3f}"
                                      if "test_acc" in r else "")))
        loss, acc = tr.evaluate(test)
        print(f"{name}: final test acc={acc:.3f} loss={loss:.3f} "
              f"(push-sum mass {float(tr.state.w.sum()):.3f} == n_clients)")


if __name__ == "__main__":
    main()
