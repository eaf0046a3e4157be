"""``examples/train_cifar_dfl_torch.py``, the port's twin of the
reference's CIFAR-10 example, on the CPU at golden scale (mnist_2nn on the
synthetic CIFAR-10 draw, 8 clients, kout k_out = 2, 1 local step, 3 rounds
in supersteps of 2): the rounds run with a finite loss, the eval lands on
the last record, each superstep's end leaves a checkpoint, and a run
resumed from the first superstep's checkpoint gives the uninterrupted
run's last round bit for bit (everything in the port is deterministic on
the CPU, the random streams included in the checkpoint)."""
import importlib.util
import json
import math
import pathlib

import pytest
import torch

from repro_torch import checkpoint

ROOT = pathlib.Path(__file__).resolve().parents[1]
ARGS = ["--device", "cpu", "--model", "mnist_2nn", "--clients", "8",
        "--local-steps", "1", "--superstep", "2"]


@pytest.fixture(scope="module")
def example():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    spec = importlib.util.spec_from_file_location(
        "train_cifar_dfl_torch", ROOT / "examples" / "train_cifar_dfl_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    yield mod
    torch.set_num_threads(n)


def test_the_example_trains_and_checkpoints(example, tmp_path, capsys):
    out = tmp_path / "hist.json"
    hist = example.main(ARGS + ["--rounds", "3", "--ckpt-dir", str(tmp_path),
                                "--out", str(out)])
    assert [r["round"] for r in hist] == [0, 1, 2]
    assert all(math.isfinite(r["train_loss"]) for r in hist)
    assert "test_acc" in hist[-1] and 0.0 <= hist[-1]["test_acc"] <= 1.0
    assert json.loads(out.read_text()) == hist
    printed = capsys.readouterr().out
    assert "superstep [0, 2) done" in printed and "superstep [2, 3) done" in printed
    assert checkpoint.latest_checkpoint(str(tmp_path)).endswith("ckpt_3.npz")


def test_a_resumed_run_equals_the_uninterrupted_one(example, tmp_path):
    whole = example.main(ARGS + ["--rounds", "3", "--ckpt-dir",
                                 str(tmp_path / "a")])
    first = tmp_path / "b"
    out = tmp_path / "b.json"
    example.main(ARGS + ["--rounds", "2", "--ckpt-dir", str(first),
                         "--out", str(out)])
    resumed = example.main(ARGS + ["--rounds", "3", "--ckpt-dir", str(first),
                                   "--out", str(out), "--resume"])
    assert [r["round"] for r in resumed] == [0, 1, 2]
    assert resumed[-1]["train_loss"] == whole[-1]["train_loss"]
    assert resumed[-1]["train_acc"] == whole[-1]["train_acc"]
