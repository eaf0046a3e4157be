"""Dirichlet non-IID partitioner (Hsu et al. 2019), as used by the paper."""
from __future__ import annotations

import numpy as np

__all__ = ["dirichlet_partition", "stack_client_data", "partition_summary"]


def dirichlet_partition(
    labels: np.ndarray,
    n_clients: int,
    alpha: float,
    seed: int = 0,
    min_per_client: int = 2,
):
    """Split sample indices across clients with Dir(alpha) label skew.

    alpha -> 0 gives extreme non-IID (each client few labels); alpha -> inf
    gives IID.  ``alpha <= 0`` is treated as IID (uniform shuffle).
    Returns a list of n_clients index arrays that *partition* the dataset.
    """
    rng = np.random.default_rng(seed)
    n = len(labels)
    if alpha <= 0 or np.isinf(alpha):
        perm = rng.permutation(n)
        return [np.sort(s) for s in np.array_split(perm, n_clients)]

    classes = np.unique(labels)
    client_idx = [[] for _ in range(n_clients)]
    for c in classes:
        idx_c = rng.permutation(np.where(labels == c)[0])
        props = rng.dirichlet(np.full(n_clients, alpha))
        cuts = (np.cumsum(props)[:-1] * len(idx_c)).astype(int)
        for cid, shard in enumerate(np.split(idx_c, cuts)):
            client_idx[cid].extend(shard.tolist())

    # Re-balance clients that received too few samples.
    sizes = np.array([len(ci) for ci in client_idx])
    for cid in np.where(sizes < min_per_client)[0]:
        donor = int(np.argmax([len(ci) for ci in client_idx]))
        need = min_per_client - len(client_idx[cid])
        client_idx[cid].extend(client_idx[donor][-need:])
        del client_idx[donor][-need:]
    return [np.sort(np.array(ci, dtype=np.int64)) for ci in client_idx]


def stack_client_data(data: dict, parts, pad_to: int | None = None):
    """Materialize per-client shards as stacked fixed-size arrays
    (n_clients, m, ...) — ragged shards are wrapped (resampled) to length m,
    which matches with-replacement minibatch sampling semantics."""
    m = pad_to or max(len(p) for p in parts)
    out = {}
    for k, v in data.items():
        rows = []
        for p in parts:
            reps = np.resize(p, m)  # wrap-around fill
            rows.append(np.asarray(v)[reps])
        out[k] = np.stack(rows)
    return out


def partition_summary(labels: np.ndarray, parts) -> dict:
    """Diagnostics: per-client size and label-distribution skew."""
    sizes = [len(p) for p in parts]
    n_classes = int(labels.max()) + 1
    hists = np.stack(
        [np.bincount(labels[p], minlength=n_classes) for p in parts]
    ).astype(np.float64)
    probs = hists / np.maximum(hists.sum(1, keepdims=True), 1)
    uniform = np.full(n_classes, 1.0 / n_classes)
    tv = 0.5 * np.abs(probs - uniform).sum(1)
    return {
        "sizes": sizes,
        "mean_tv_from_uniform": float(tv.mean()),
        "max_tv_from_uniform": float(tv.max()),
    }
