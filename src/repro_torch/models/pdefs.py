"""Parameter definitions — the port of ``repro.models.pdefs``.

Every model declares its parameters (and KV caches) as a nested dict of
``PDef``: shape, per-dim logical axis names, dtype and init spec.  From one
declaration come real parameters (:func:`init_tree`) and meta tensors
(:func:`abstract_tree`: shapes and dtypes, no allocation, the dry-run's
stand-ins); the axis names place them on a mesh
(``repro_torch.launch.sharding.spec_for``).
"""
from __future__ import annotations

import math
from typing import Any, NamedTuple

import numpy as np
import torch

__all__ = ["PDef", "init_tree", "abstract_tree", "tree_num_params"]

# At most this many values are drawn at once: a full-width leaf (gemma3-12b's
# stacked ``wi`` holds 2.83e9) is filled slice by slice, so no f32 temporary
# of the whole leaf ever exists.
_CHUNK = 1 << 26


class PDef(NamedTuple):
    shape: tuple
    axes: tuple  # logical axis name (str) or None per dim
    dtype: Any = torch.float32
    init: str = "normal"  # normal | zeros | ones
    fan_in: int = 0  # 0 -> last-but-one dim

    def scale(self) -> float:
        if self.init != "normal":
            return 0.0
        fan = self.fan_in or (self.shape[-2] if len(self.shape) >= 2 else self.shape[-1])
        return float(1.0 / np.sqrt(max(fan, 1)))


def _fill_normal(out: torch.Tensor, gen: torch.Generator, scale: float) -> None:
    """``out = (scale * N(0, 1)).to(out.dtype)``, drawn in f32 one slice of
    the leading dims at a time (each at most ``_CHUNK`` values)."""
    flat = out.view(-1, *out.shape[-1:]) if out.dim() else out.view(1, 1)
    rows = max(1, _CHUNK // max(flat.shape[1], 1))
    for r0 in range(0, flat.shape[0], rows):
        part = flat[r0:r0 + rows]
        draw = torch.randn(part.shape, generator=gen, device=out.device,
                           dtype=torch.float32)
        part.copy_(draw.mul_(scale))


def init_tree(gen: torch.Generator, defs, device=None) -> dict:
    """Real parameters from a PDef tree, drawn from ``gen`` in the sorted-key
    order of the tree, on ``device`` (default: the generator's)."""
    device = torch.device(device if device is not None else gen.device)

    def make(d: PDef):
        if d.init == "zeros":
            return torch.zeros(d.shape, dtype=d.dtype, device=device)
        if d.init == "ones":
            return torch.ones(d.shape, dtype=d.dtype, device=device)
        out = torch.empty(d.shape, dtype=d.dtype, device=device)
        _fill_normal(out, gen, d.scale())
        return out

    return _map_sorted(make, defs)


def abstract_tree(defs, device="meta") -> dict:
    """Empty tensors of every ``PDef``'s shape and dtype on ``device`` —
    on ``meta`` (the default) they hold no memory: the reference's
    ``ShapeDtypeStruct`` tree."""
    return _map_sorted(
        lambda d: torch.empty(d.shape, dtype=d.dtype, device=device), defs)


def _map_sorted(fn, tree):
    if isinstance(tree, dict):
        return {k: _map_sorted(fn, tree[k]) for k in sorted(tree)}
    return fn(tree)


def _leaves(tree):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k])
    else:
        yield tree


def tree_num_params(defs) -> int:
    return sum(math.prod(d.shape) for d in _leaves(defs))
