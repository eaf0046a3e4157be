"""Flat client-parameter bank: every client's parameter dict ravelled into one
contiguous row of an ``(n_clients, D)`` tensor — the port of the
``BankSpec`` / ``make_spec`` part of ``repro.core.flat``.

Leaves are ordered as ``jax.tree`` flattens a nested dict (keys sorted at
every level), so a row of the port's bank and a row of the reference's
bank hold the same numbers in the same places.  The low-rank delta bank
waits for its own slice.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

__all__ = ["BankSpec", "make_spec", "tree_flatten", "tree_unflatten",
           "tree_map"]


def tree_flatten(tree) -> tuple[list[tuple[str, ...]], list[Any]]:
    """``(paths, leaves)`` of a nested dict, keys sorted at every level."""
    paths, leaves = [], []

    def walk(node, prefix):
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], prefix + (k,))
        else:
            paths.append(prefix)
            leaves.append(node)

    walk(tree, ())
    return paths, leaves


def tree_unflatten(paths, leaves) -> dict:
    out: dict = {}
    for path, leaf in zip(paths, leaves):
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf
    return out


def tree_map(fn, tree, *rest):
    """``fn`` over corresponding leaves of same-structured nested dicts."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    return fn(tree, *rest)


@dataclasses.dataclass(frozen=True)
class BankSpec:
    """Static ravel/unravel metadata for one model's parameter dict.

    Attributes:
      paths: key path of each leaf, in bank order.
      shapes / dtypes: per-leaf shape and original dtype (restored on
        unravel).
      offsets / sizes: start offset and element count of each leaf inside
        the flat row.
      dim: total row length D.
      dtype: storage dtype of the flat bank (promotion of all leaf dtypes
        unless given).
    """

    paths: tuple[tuple[str, ...], ...]
    shapes: tuple[tuple[int, ...], ...]
    dtypes: tuple[torch.dtype, ...]
    offsets: tuple[int, ...]
    sizes: tuple[int, ...]
    dim: int
    dtype: torch.dtype

    # -- single row <-> single-client params ---------------------------------

    def ravel(self, tree) -> torch.Tensor:
        """Params dict -> flat (D,) row in the bank storage dtype."""
        _, leaves = tree_flatten(tree)
        return torch.cat([x.reshape(-1).to(self.dtype) for x in leaves])

    def unravel(self, row: torch.Tensor) -> dict:
        """Flat (D,) row -> params dict of views (leaf dtypes restored)."""
        leaves = [
            row[o:o + s].reshape(shape).to(dt)
            for o, s, shape, dt in zip(
                self.offsets, self.sizes, self.shapes, self.dtypes
            )
        ]
        return tree_unflatten(self.paths, leaves)

    def debias(self, row: torch.Tensor, w) -> dict:
        """De-biased model ``z = unravel(row) / w`` (push-sum line 5)."""
        return tree_map(lambda p: p / w, self.unravel(row))

    def ravel_grad_stacked(self, G_tree, X: torch.Tensor) -> torch.Tensor:
        """Client-stacked loss gradients -> (n, D) bank-space gradient rows
        (the identity pullback of the dense bank)."""
        return self.ravel_stacked(G_tree)

    # -- (n, D) bank <-> client-stacked params -------------------------------

    def ravel_stacked(self, stacked_tree) -> torch.Tensor:
        """Client-stacked params (leading dim n per leaf) -> (n, D) bank."""
        _, leaves = tree_flatten(stacked_tree)
        return torch.cat(
            [x.reshape(x.shape[0], -1).to(self.dtype) for x in leaves], dim=1
        )

    def unravel_stacked(self, bank: torch.Tensor) -> dict:
        """(n, D) bank -> client-stacked params dict."""
        n = bank.shape[0]
        leaves = [
            bank[:, o:o + s].reshape((n,) + shape).to(dt)
            for o, s, shape, dt in zip(
                self.offsets, self.sizes, self.shapes, self.dtypes
            )
        ]
        return tree_unflatten(self.paths, leaves)


def make_spec(tree, dtype=None) -> BankSpec:
    """Build the :class:`BankSpec` for one client's parameter dict.  Leaves
    may be tensors or anything with ``.shape`` and ``.dtype`` (meta tensors
    included) — only the metadata is read."""
    paths, leaves = tree_flatten(tree)
    shapes = tuple(tuple(x.shape) for x in leaves)
    dtypes = tuple(x.dtype for x in leaves)
    sizes = tuple(math.prod(s) for s in shapes)
    offsets = tuple(sum(sizes[:i]) for i in range(len(sizes)))
    if dtype is None:
        dtype = dtypes[0]
        for dt in dtypes[1:]:
            dtype = torch.promote_types(dtype, dt)
    return BankSpec(tuple(paths), shapes, dtypes, offsets, sizes,
                    int(sum(sizes)), dtype)
