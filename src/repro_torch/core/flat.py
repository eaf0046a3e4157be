"""Flat client-parameter bank: every client's parameter dict ravelled into one
contiguous row of an ``(n_clients, D)`` tensor — the port of the
``BankSpec`` / ``make_spec`` part of ``repro.core.flat``.

Leaves are ordered as ``jax.tree`` flattens a nested dict (keys sorted at
every level), so a row of the port's bank and a row of the reference's
bank hold the same numbers in the same places.

The **low-rank delta bank** (:class:`DeltaBankSpec`, the port of the
reference's) stores per-client adapter payloads over one frozen shared
base: rank-r ``(A, B)`` factors for selected >=2-D leaves, a dense delta
for small leaves, nothing for frozen leaves.  ``delta_i = x_i - w_i *
base`` survives any linear mix of ``(delta, w)``, so push-sum runs on the
narrow ``(n, d_delta)`` bank unchanged and the de-biased model is ``z_i =
base + expand(delta_i) / w_i``.  ``rank="full"`` stores dense deltas and
reproduces the dense bank.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

__all__ = ["BankSpec", "make_spec", "tree_flatten", "tree_unflatten",
           "tree_map", "keystr", "tree_leaves_with_path", "tree_rebuild", "DeltaConfig", "DeltaBankSpec",
           "BoundDeltaSpec", "make_delta_spec", "bind_delta_spec"]

# The most elements of one f32 piece of an expanded delta leaf
# (:meth:`BoundDeltaSpec.debias_stacked`): 256 MiB.
_PIECE_ELEMS = 1 << 26


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


def keystr(path: tuple[str, ...]) -> str:
    """A leaf's key path in the reference's ``jax.tree_util.keystr`` form,
    ``"['conv2']['w']"``, so ``adapt=`` filters select the same leaves in
    both packages."""
    return "".join(f"[{k!r}]" for k in path)


def tree_leaves_with_path(tree, prefix=()):
    """``(path, leaf)`` pairs of a tree that may also hold NamedTuples and
    sequences (a round state's ``LinkState``), in ``jax.tree`` flattening
    order with ``jax.tree_util`` key names: dict keys sorted (``['k']``,
    as :func:`keystr`), NamedTuple fields in order (``.name``), sequence
    items (``[i]``); empty tuples hold no leaf.  On a nested dict the
    order is :func:`tree_flatten`'s."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from tree_leaves_with_path(tree[k], prefix + (f"[{k!r}]",))
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for f in tree._fields:
            yield from tree_leaves_with_path(getattr(tree, f),
                                             prefix + (f".{f}",))
    elif isinstance(tree, (tuple, list)):
        for i, x in enumerate(tree):
            yield from tree_leaves_with_path(x, prefix + (f"[{i}]",))
    else:
        yield prefix, tree


def tree_rebuild(like, leaves):
    """``like``'s structure with its leaves taken, in
    :func:`tree_leaves_with_path`'s order, from the iterator ``leaves``."""
    if isinstance(like, dict):
        done = {k: tree_rebuild(like[k], leaves) for k in sorted(like)}
        return {k: done[k] for k in like}
    if isinstance(like, tuple) and hasattr(like, "_fields"):
        return type(like)(*[tree_rebuild(getattr(like, f), leaves)
                            for f in like._fields])
    if isinstance(like, (tuple, list)):
        return type(like)(tree_rebuild(x, leaves) for x in like)
    return next(leaves)


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


# ---------------------------------------------------------------------------
# Low-rank delta bank: frozen shared base + per-client adapter rows.
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class DeltaConfig:
    """Which leaves adapt and at what rank.

    ``rank``: adapter rank per selected >=2-D leaf, or ``"full"`` for a
      dense delta on every selected leaf (the dense-bank program).  A leaf
      whose rank-r factors would not be smaller than the leaf itself takes
      a dense delta.
    ``adapt``: ``"auto"`` / ``"all"`` adapt every leaf; ``"2d"`` /
      ``"matrices"`` only >=2-D leaves; a callable ``(path, shape) ->
      bool`` or a path substring selects explicitly (paths in the
      ``keystr`` form).  Unselected leaves are frozen at the base.
    ``base_seed``: seed of the generator that materializes the frozen base
      through the program's ``init_fn``.
    """

    rank: Any = 8
    adapt: Any = "auto"
    base_seed: int = 0


def _leaf_selected(adapt, path: str, shape) -> bool:
    if adapt in ("auto", "all"):
        return True
    if adapt in ("2d", "matrices"):
        return len(shape) >= 2
    if callable(adapt):
        return bool(adapt(path, shape))
    return str(adapt) in path


@dataclasses.dataclass(frozen=True)
class DeltaBankSpec:
    """Static layout of the ``(n, d_delta)`` delta bank over one base model.

    Per leaf: ``"lowrank"`` stores ``A`` (``lead + (p, r)``) then ``B``
    (``lead + (r, q)``) and the leaf delta is ``A @ B``; ``"dense"`` stores
    the leaf delta; ``"frozen"`` stores nothing.  Methods take the base
    explicitly; :class:`BoundDeltaSpec` closes over one.
    """

    full: BankSpec  # spec of the full model
    paths: tuple[str, ...]  # per-leaf keystr paths (for adapt= filters)
    modes: tuple[str, ...]  # per-leaf "lowrank" | "dense" | "frozen"
    ranks: tuple[int, ...]  # per-leaf adapter rank (0 unless lowrank)
    offsets: tuple[int, ...]  # per-leaf start offset in the delta row
    sizes: tuple[int, ...]  # per-leaf payload length (0 if frozen)
    asizes: tuple[int, ...]  # A-factor length within the payload
    dim: int  # d_delta
    dtype: torch.dtype

    def _factor_shapes(self, i):
        shape, r = self.full.shapes[i], self.ranks[i]
        lead, p, q = shape[:-2], shape[-2], shape[-1]
        return lead + (p, r), lead + (r, q)

    def factors(self, row: torch.Tensor, i: int):
        """(A, B) of low-rank leaf ``i`` sliced out of one row."""
        o, a, s = self.offsets[i], self.asizes[i], self.sizes[i]
        sa, sb = self._factor_shapes(i)
        return row[o:o + a].reshape(sa), row[o + a:o + s].reshape(sb)

    def _delta_leaf(self, row: torch.Tensor, i: int):
        """The expanded float32 delta of leaf ``i``, or None if frozen."""
        mode = self.modes[i]
        if mode == "frozen":
            return None
        if mode == "dense":
            o, s = self.offsets[i], self.sizes[i]
            return row[o:o + s].reshape(self.full.shapes[i]).float()
        A, B = self.factors(row, i)
        return torch.matmul(A.float(), B.float())

    def _delta_pieces(self, row: torch.Tensor, i: int, limit: int):
        """Leaf ``i``'s float32 delta (not frozen) in pieces of at most
        ``limit`` elements (one row at the least): yields ``(index,
        piece)``, the index into the leaf viewed as ``(N, p, q)`` (low-rank,
        N the product of its leading axes) or as a flat vector (dense).
        Each piece is whole matrices ``A[n] @ B[n]`` or rows of one, the
        same products as :meth:`_delta_leaf`'s, so that the pieces are its
        slices."""
        if self.modes[i] == "dense":
            o, s = self.offsets[i], self.sizes[i]
            for a in range(0, s, limit):
                e = min(a + limit, s)
                yield (slice(a, e),), row[o + a:o + e].float()
            return
        A, B = self.factors(row, i)
        p, r, q = A.shape[-2], A.shape[-1], B.shape[-1]
        A, B = A.reshape(-1, p, r), B.reshape(-1, r, q)
        if p * q <= limit:
            per = limit // (p * q)
            for a in range(0, A.shape[0], per):
                yield ((slice(a, a + per),),
                       torch.matmul(A[a:a + per].float(),
                                    B[a:a + per].float()))
            return
        rows = max(1, limit // q)
        for n in range(A.shape[0]):
            Bn = B[n].float()
            for a in range(0, p, rows):
                yield (n, slice(a, a + rows)), torch.matmul(
                    A[n, a:a + rows].float(), Bn)

    def unravel(self, base, row: torch.Tensor) -> dict:
        """``base + expand(row)`` as a params dict (leaf dtypes restored)."""
        return self.debias(base, row, None)

    def debias(self, base, row: torch.Tensor, w) -> dict:
        """De-biased model ``z = base + expand(row) / w`` (``w=None`` skips
        the division)."""
        _, base_leaves = tree_flatten(base)
        out = []
        for i, bl in enumerate(base_leaves):
            d = self._delta_leaf(row, i)
            if d is None:
                out.append(bl.to(self.full.dtypes[i]))
                continue
            if w is not None:
                d = d / w
            out.append((bl + d.to(bl.dtype)).to(self.full.dtypes[i]))
        return tree_unflatten(self.full.paths, out)

    def ravel(self, base, tree) -> torch.Tensor:
        """Params dict -> delta row (``w = 1``).  Only dense-mode leaves can
        hold an arbitrary delta; a low-rank leaf raises."""
        _, leaves = tree_flatten(tree)
        _, base_leaves = tree_flatten(base)
        segs = []
        for i, (x, b) in enumerate(zip(leaves, base_leaves)):
            mode = self.modes[i]
            if mode == "dense":
                segs.append((x - b).reshape(-1).to(self.dtype))
            elif mode == "lowrank":
                raise ValueError(
                    f"leaf {self.paths[i]!r} is low-rank (r={self.ranks[i]}):"
                    " an arbitrary delta cannot be factored into its row;"
                    " use rank='full' or write the (A, B) factors directly"
                )
        if not segs:
            return torch.zeros((0,), dtype=self.dtype)
        return torch.cat(segs)

    def draw_init(self, gen: torch.Generator) -> list:
        """The init row's draw: one standard-normal float32 ``A`` factor per
        low-rank leaf, in leaf order."""
        return [
            torch.randn(self._factor_shapes(i)[0], generator=gen,
                        device=gen.device, dtype=torch.float32)
            for i, mode in enumerate(self.modes) if mode == "lowrank"
        ]

    def build_init_row(self, normals: list) -> torch.Tensor:
        """The broadcast initial row from :meth:`draw_init`'s normals: zero
        deltas everywhere, low-rank leaves ``A = normal / sqrt(p)``, ``B =
        0`` (LoRA init: the delta is exactly zero, gradients reach B from
        the first step)."""
        segs, it = [], iter(normals)
        device = normals[0].device if normals else None
        for i, mode in enumerate(self.modes):
            if mode == "frozen":
                continue
            if mode == "dense":
                segs.append(torch.zeros((self.sizes[i],), dtype=self.dtype,
                                        device=device))
                continue
            p = self._factor_shapes(i)[0][-2]
            A = next(it) / torch.tensor(math.sqrt(p), dtype=torch.float32)
            segs.append(A.reshape(-1).to(self.dtype))
            segs.append(torch.zeros((self.sizes[i] - self.asizes[i],),
                                    dtype=self.dtype, device=device))
        if not segs:
            return torch.zeros((0,), dtype=self.dtype, device=device)
        return torch.cat(segs)

    def init_row(self, gen: torch.Generator) -> torch.Tensor:
        return self.build_init_row(self.draw_init(gen))

    def grad_rows(self, G_tree, X: torch.Tensor) -> torch.Tensor:
        """Client-stacked loss gradients -> ``(n, d_delta)`` gradient rows:
        dense leaves as the identity, low-rank leaves pulled back through
        ``A @ B`` at the stored factors (``dA = G B^T``, ``dB = A^T G``, in
        float32), frozen leaves dropped."""
        _, leaves = tree_flatten(G_tree)
        n = X.shape[0]
        segs = []
        for i, g in enumerate(leaves):
            mode = self.modes[i]
            if mode == "frozen":
                continue
            if mode == "dense":
                segs.append(g.reshape(n, -1).to(self.dtype))
                continue
            sa, sb = self._factor_shapes(i)
            o, a, s = self.offsets[i], self.asizes[i], self.sizes[i]
            A = X[:, o:o + a].reshape((n,) + sa).float()
            B = X[:, o + a:o + s].reshape((n,) + sb).float()
            gf = g.float()
            dA = torch.matmul(gf, B.transpose(-1, -2))
            dB = torch.matmul(A.transpose(-1, -2), gf)
            segs.append(dA.reshape(n, -1).to(self.dtype))
            segs.append(dB.reshape(n, -1).to(self.dtype))
        if not segs:
            return torch.zeros((n, 0), dtype=self.dtype, device=X.device)
        return torch.cat(segs, dim=1)


def make_delta_spec(tree, rank=8, adapt="auto", dtype=None) -> DeltaBankSpec:
    """Build the :class:`DeltaBankSpec` for one client's parameter dict
    (only shapes and dtypes are read).  ``rank="full"`` stores dense deltas
    on every selected leaf."""
    full = make_spec(tree, dtype=dtype)
    paths = tuple(keystr(p) for p in full.paths)
    modes, ranks, sizes, asizes = [], [], [], []
    for path, shape, size in zip(paths, full.shapes, full.sizes):
        if not _leaf_selected(adapt, path, shape):
            modes.append("frozen")
            ranks.append(0)
            sizes.append(0)
            asizes.append(0)
            continue
        if rank != "full" and len(shape) >= 2:
            r = min(int(rank), shape[-2], shape[-1])
            lead = math.prod(shape[:-2])
            a = lead * shape[-2] * r
            b = lead * r * shape[-1]
            if a + b < size:
                modes.append("lowrank")
                ranks.append(r)
                sizes.append(a + b)
                asizes.append(a)
                continue
        modes.append("dense")
        ranks.append(0)
        sizes.append(size)
        asizes.append(0)
    offsets = tuple(sum(sizes[:i]) for i in range(len(sizes)))
    return DeltaBankSpec(full, paths, tuple(modes), tuple(ranks), offsets,
                         tuple(sizes), tuple(asizes), int(sum(sizes)),
                         full.dtype)


def bind_delta_spec(spec: DeltaBankSpec, base) -> "BoundDeltaSpec":
    """Close a static delta layout over its concrete frozen base."""
    return BoundDeltaSpec(spec, base)


@dataclasses.dataclass(frozen=True, eq=False)
class BoundDeltaSpec:
    """A :class:`DeltaBankSpec` closed over its frozen base: the
    ``BankSpec`` interface the solvers, eval and the trainer consume."""

    delta: DeltaBankSpec
    base: Any  # the frozen shared model (params dict)

    @property
    def dim(self) -> int:
        return self.delta.dim

    @property
    def dtype(self):
        return self.delta.dtype

    def unravel(self, row: torch.Tensor) -> dict:
        return self.delta.unravel(self.base, row)

    def debias(self, row: torch.Tensor, w) -> dict:
        return self.delta.debias(self.base, row, w)

    def ravel(self, tree) -> torch.Tensor:
        return self.delta.ravel(self.base, tree)

    def ravel_grad_stacked(self, G_tree, X: torch.Tensor) -> torch.Tensor:
        return self.delta.grad_rows(G_tree, X)

    def init_row(self, gen: torch.Generator) -> torch.Tensor:
        return self.delta.init_row(gen)

    def base_row(self) -> torch.Tensor:
        """The base ravelled under the *full* model spec (checkpoint v3's
        ``__base__``)."""
        return self.delta.full.ravel(self.base)

    def unravel_stacked(self, bank: torch.Tensor) -> dict:
        return tree_map(lambda *xs: torch.stack(xs),
                        *[self.unravel(row) for row in bank])

    def debias_stacked(self, bank: torch.Tensor, w: torch.Tensor) -> dict:
        """Row-stacked :meth:`debias`, built into the stacked outputs leaf
        by leaf, and each leaf in pieces of at most ``_PIECE_ELEMS``
        elements (:meth:`DeltaBankSpec._delta_pieces`): the f32
        temporaries stay near that size (1 GiB at most), where a whole
        expanded leaf can be larger than the card (one of
        deepseek-v3-671b's expert leaves is 15 GB in f32).  Bit for bit
        :meth:`debias` of each row."""
        _, base_leaves = tree_flatten(self.base)
        d = self.delta
        out = []
        for i, bl in enumerate(base_leaves):
            dt = d.full.dtypes[i]
            leaf = torch.empty((bank.shape[0],) + tuple(bl.shape), dtype=dt,
                               device=bl.device)
            if d.modes[i] == "frozen":
                leaf[:] = bl.to(dt)
                out.append(leaf)
                continue
            view = ((-1,) if d.modes[i] == "dense"
                    else (-1,) + tuple(bl.shape[-2:]))
            base = bl.reshape(view)
            for b in range(bank.shape[0]):
                dst = leaf[b].view(view)
                for idx, delta in d._delta_pieces(bank[b], i,
                                                    _PIECE_ELEMS):
                    dst[idx] = (base[idx] + (delta / w[b]).to(bl.dtype)).to(dt)
                    del delta
            out.append(leaf)
        return tree_unflatten(d.full.paths, out)
