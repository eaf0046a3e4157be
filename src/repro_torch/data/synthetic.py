"""Deterministic synthetic datasets shaped like the paper's benchmarks — a
numpy copy of ``repro.data.synthetic.make_dataset`` and ``make_lm_stream``
giving byte-identical arrays.

The container is offline, so MNIST/CIFAR cannot be downloaded.  We generate
learnable Gaussian-mixture classification problems with matching shapes so
every algorithmic claim (optimizer ordering, ablation trends, convergence)
can be validated end-to-end.  Class signal strength is controlled by
``margin``; intra-class variation by per-sample noise and random per-class
covariance directions, which makes the task non-trivially non-convex for
conv nets while staying CPU-sized.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

__all__ = ["DatasetSpec", "SPECS", "make_dataset", "make_lm_stream"]


@dataclasses.dataclass(frozen=True)
class DatasetSpec:
    name: str
    shape: tuple  # per-example feature shape
    n_classes: int
    margin: float = 3.0


SPECS = {
    "mnist": DatasetSpec("mnist", (784,), 10, margin=4.0),
    "cifar10": DatasetSpec("cifar10", (32, 32, 3), 10, margin=3.0),
    "cifar100": DatasetSpec("cifar100", (32, 32, 3), 100, margin=2.5),
}


def make_dataset(spec: DatasetSpec | str, n_train: int, n_test: int, seed: int = 0):
    """Returns (train, test) dicts with 'x' float32 and 'y' int32 arrays."""
    if isinstance(spec, str):
        spec = SPECS[spec]
    rng = np.random.default_rng(seed)
    dim = int(np.prod(spec.shape))
    # Class means on a random low-dimensional subspace, scaled by margin.
    basis = rng.standard_normal((spec.n_classes, dim)).astype(np.float32)
    basis /= np.linalg.norm(basis, axis=1, keepdims=True)
    means = spec.margin * basis
    # Per-class anisotropic wobble directions (adds non-convex structure).
    wobble = rng.standard_normal((spec.n_classes, dim)).astype(np.float32)
    wobble /= np.linalg.norm(wobble, axis=1, keepdims=True)

    def sample(n, s):
        r = np.random.default_rng(s)
        y = r.integers(0, spec.n_classes, size=n).astype(np.int32)
        coef = r.standard_normal((n, 1)).astype(np.float32)
        x = (
            means[y]
            + 1.5 * coef * wobble[y]
            + r.standard_normal((n, dim)).astype(np.float32)
        )
        x = np.tanh(x)  # bounded, image-like range
        return {"x": x.reshape((n,) + spec.shape), "y": y}

    return sample(n_train, seed + 1), sample(n_test, seed + 2)


def make_lm_stream(
    vocab_size: int, seq_len: int, n_seqs: int, seed: int = 0, order: int = 2
) -> torch.Tensor:
    """Synthetic token stream with learnable Markov structure for LM training:
    ``(n_seqs, seq_len)`` int32 tokens on the CPU, the reference's token for
    token (the same numpy draws).

    A fixed random ``order``-gram transition table generates sequences, so a
    language model can reduce loss well below uniform entropy.
    """
    rng = np.random.default_rng(seed)
    ctx = min(vocab_size, 512)
    table = rng.dirichlet(np.ones(ctx) * 0.1, size=ctx).astype(np.float32)
    toks = np.empty((n_seqs, seq_len), dtype=np.int32)
    state = rng.integers(0, ctx, size=n_seqs)
    for t in range(seq_len):
        u = rng.random((n_seqs, 1))
        cdf = np.cumsum(table[state], axis=1)
        nxt = (u < cdf).argmax(axis=1)
        toks[:, t] = nxt
        state = nxt
    return torch.from_numpy(toks % vocab_size)
