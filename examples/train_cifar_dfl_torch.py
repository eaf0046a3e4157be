"""End-to-end run of the PyTorch port: the paper's CIFAR-10 experiment.
The twin of ``examples/train_cifar_dfl.py``.

CNN backbone, Dirichlet non-IID partition, every algorithm of
``ALGORITHMS``, checkpointing, and JSON logging.  --paper approaches the
paper's setting (100 clients, 500 rounds, ResNet-18-GN).  Rounds run in
supersteps of --superstep rounds (``FLTrainer.fit``); the eval runs every 5
global rounds, and the full FLState is checkpointed at each superstep's
end, from which --resume warm-restarts.

  python examples/train_cifar_dfl_torch.py --algo dfedsgpsm --rounds 15
  python examples/train_cifar_dfl_torch.py --device cpu --model mnist_2nn \\
      --rounds 3 --local-steps 1
"""
import argparse
import json
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

from repro_torch import checkpoint  # noqa: E402
from repro_torch.core import (  # noqa: E402
    ALGORITHMS,
    FLTrainer,
    TopologyConfig,
    make_algo,
)
from repro_torch.data.dirichlet import (  # noqa: E402
    dirichlet_partition,
    partition_summary,
    stack_client_data,
)
from repro_torch.data.synthetic import make_dataset  # noqa: E402
from repro_torch.models.small import get_model  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--algo", default="dfedsgpsm", choices=sorted(ALGORITHMS))
    ap.add_argument("--rounds", type=int, default=10)
    ap.add_argument("--clients", type=int, default=8)
    ap.add_argument("--alpha", type=float, default=0.3, help="Dirichlet (<=0 = IID)")
    ap.add_argument("--model", default="cifar_cnn",
                    choices=["cifar_cnn", "resnet18_gn", "mnist_2nn"])
    ap.add_argument("--local-steps", type=int, default=3)
    ap.add_argument("--participation", type=float, default=0.25)
    ap.add_argument("--paper", action="store_true",
                    help="paper scale: 100 clients, 500 rounds, resnet18_gn")
    ap.add_argument("--superstep", type=int, default=5,
                    help="rounds per superstep; eval runs every 5 (global) "
                         "rounds and checkpoints land at superstep "
                         "boundaries")
    ap.add_argument("--ckpt-dir",
                    default=os.path.join(tempfile.gettempdir(),
                                         "repro_torch_ckpt"))
    ap.add_argument("--resume", action="store_true",
                    help="warm-restart the full FLState (params + momentum "
                         "bank + push-sum weights + round) from --ckpt-dir")
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (their plain versions)")
    args = ap.parse_args(argv)
    if args.paper:
        args.clients, args.rounds, args.model = 100, 500, "resnet18_gn"
        args.participation = 0.1

    train, test = make_dataset("cifar10", 4000, 1000, seed=0)
    parts = dirichlet_partition(train["y"], args.clients, args.alpha, seed=0)
    print("partition:", partition_summary(train["y"], parts))
    cdata = stack_client_data(train, parts, pad_to=256)

    model = get_model(args.model, n_classes=10)
    algo = make_algo(args.algo, local_steps=args.local_steps, batch_size=32)
    topo = TopologyConfig(
        kind="kout", n_clients=args.clients,
        k_out=max(int(args.participation * args.clients), 1))
    tr = FLTrainer(model.loss, model.init, cdata, algo, topo, seed=0,
                   participation=args.participation, device=args.device)

    start = 0
    history = []
    if args.resume:
        path = checkpoint.latest_checkpoint(args.ckpt_dir)
        if path is not None:
            state = tr.restore(path)
            start = int(state.round)
            print(f"resumed {path} at round {start}")
            if args.out and os.path.exists(args.out):
                with open(args.out) as f:  # keep the pre-resume curve
                    history = [r for r in json.load(f) if r["round"] < start]
    # Each chunk of rounds is one superstep; the eval's cadence is keyed on
    # the global round counter, so it is stable across chunks and --resume,
    # and the full warm-restartable FLState is saved at each boundary.
    for r0 in range(start, args.rounds, max(args.superstep, 1)):
        chunk = min(max(args.superstep, 1), args.rounds - r0)
        for raw in tr.fit(chunk, test_data=test, eval_every=5):
            rec = {"round": r0 + raw["round"], "train_loss": raw["loss"],
                   "train_acc": raw["acc"]}
            if "test_acc" in raw:
                rec.update(test_loss=raw["test_loss"],
                           test_acc=raw["test_acc"])
                print(f"round {rec['round']:4d} "
                      f"loss={rec['train_loss']:.3f} "
                      f"test_acc={rec['test_acc']:.3f}")
            else:
                print(f"round {rec['round']:4d} "
                      f"loss={rec['train_loss']:.3f}")
            history.append(rec)
        tr.save(args.ckpt_dir, r0 + chunk)  # full FLState at the boundary
        print(f"superstep [{r0}, {r0 + chunk}) done (ckpt saved)")
    if history and "test_acc" not in history[-1]:
        tl, ta = tr.evaluate(test)
        history[-1].update(test_loss=tl, test_acc=ta)

    if args.out:
        with open(args.out, "w") as f:
            json.dump(history, f, indent=1)
    if history:
        print("final:", history[-1])
    print("latest ckpt:", checkpoint.latest_checkpoint(args.ckpt_dir))
    return history


if __name__ == "__main__":
    main()
