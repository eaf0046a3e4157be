"""Placement on a mesh — the port of ``repro.launch.sharding``: the
logical-axis rules of model parameters and caches (``spec_for``,
``sharding_for``, ``use_mesh``), and the row sharding of the flat client
bank (``bank_row_pins``).

Models declare *logical* axes ("heads", "mlp", "embed", "batch", ...);
:func:`spec_for` maps them onto the mesh axes ("data", "model"[, "pod"])
exactly as the reference does, as a tuple of the ``PartitionSpec``'s
entries.  The port runs a model on one card, so nothing places it yet: the
dry-run (``repro_torch.launch.dryrun``) reads the specs to count each
device's bytes and collectives on the reference's production meshes.
``constrain`` and ``in_manual_region``, which place activations of a model
running across cards, wait for the pod runtime (ROADMAP item 13.7).

The reference pins every bank-row leaf of its one GSPMD program to the mesh
axis with sharding constraints.  The port's sharded round is SPMD over
``torch.distributed``: each rank holds ``m = n / world`` contiguous rows
``[lo, lo + m)`` of every bank-row leaf (params, momentum, w, losses, the
EF residual, the link buffers, the churn liveness), and :class:`RowShard` is
the one object that knows which — it slices a whole leaf to the rank's
rows and gathers the rows of every rank back into a whole leaf.
"""
from __future__ import annotations

import contextlib
import math

import torch

__all__ = ["MODEL_AXES", "FSDP_AXES", "ACT_RULES", "use_mesh", "active_mesh",
           "spec_for", "sharding_for", "shard_shape", "RowShard",
           "bank_row_pins", "check_row_mesh"]

# Logical axes eligible for tensor/expert parallelism, in priority order —
# the *first* divisible dim of a param gets the "model" mesh axis.
MODEL_AXES = ("expert", "vocab", "heads", "kv_heads", "mlp", "head_dim",
              "ssm_inner")
# Logical axes eligible for FSDP-style sharding over "data".
FSDP_AXES = ("embed", "ffpar", "frontend", "rank")
# Activation logical names -> mesh axes (the reference's ``constrain``
# rules; kept for the pod runtime).
ACT_RULES = {
    "batch": "data",
    "expert": "model",
    "heads": "model",
    "kv_heads": "model",
    "mlp": "model",
    "vocab": "model",
    "head_dim": "head_dim_fallback",  # only used when heads were replicated
    "ssm_inner": "model",
    "seq": None,
    "embed": None,
}

_STATE: list = []  # stack of (mesh, fsdp: bool)


@contextlib.contextmanager
def use_mesh(mesh, fsdp: bool = True):
    """Make ``mesh`` (and its FSDP choice) the active one inside the block:
    :func:`sharding_for` without a mesh reads it."""
    _STATE.append((mesh, fsdp))
    try:
        yield mesh
    finally:
        _STATE.pop()


def active_mesh():
    return _STATE[-1][0] if _STATE else None


def _axis_size(mesh, name: str) -> int:
    from repro_torch.launch.mesh import mesh_axis_names, mesh_axis_size

    return mesh_axis_size(mesh, name) if name in mesh_axis_names(mesh) else 0


def spec_for(pdef, mesh, fsdp: bool = True, model_axes: tuple = None) -> tuple:
    """A parameter's (or cache's) ``PDef`` -> its ``PartitionSpec``
    entries, one mesh axis name or ``None`` per dim.

    At most one dim is sharded over "model" (first divisible logical axis in
    ``model_axes`` priority) and, when ``fsdp``, one over "data"; a cache's
    batch dim takes "data" first, and a long cache whose batch does not
    divide shards its sequence instead."""
    model_axes = MODEL_AXES if model_axes is None else model_axes
    model_n = _axis_size(mesh, "model")
    data_n = _axis_size(mesh, "data")
    spec: list = [None] * len(pdef.shape)

    def place(mesh_axis, mesh_n, candidates):
        if not mesh_n or mesh_axis in spec:
            return
        for logical in candidates:
            for i, (dim, name) in enumerate(zip(pdef.shape, pdef.axes)):
                if name == logical and spec[i] is None and dim % mesh_n == 0:
                    spec[i] = mesh_axis
                    return

    place("model", model_n, model_axes)
    # caches/activations: batch rides on "data" (takes priority over FSDP)
    place("data", data_n, ("batch",))
    if fsdp:
        place("data", data_n, FSDP_AXES)
    # long-context caches with unshardable batch: shard the sequence dim
    place("data", data_n, ("seq",))
    return tuple(spec)


def shard_shape(shape: tuple, spec: tuple, mesh) -> tuple:
    """One device's block of a ``shape`` placed by ``spec`` on ``mesh``: a
    dim on a mesh axis (or a tuple of axes) divided by its size."""
    out = []
    for i, dim in enumerate(shape):
        axes = spec[i] if i < len(spec) else None
        axes = () if axes is None else (axes,) if isinstance(axes, str) else axes
        out.append(dim // math.prod(_axis_size(mesh, a) for a in axes))
    return tuple(out)


def sharding_for(pdef, mesh=None, fsdp: bool = None):
    """Where ``pdef`` goes on ``mesh`` (default: the active one, ``None``
    without one): on a live ``DeviceMesh`` the DTensor placements, one per
    mesh dim (``Shard(i)`` for the dim :func:`spec_for` puts on it, else
    ``Replicate()``); on an abstract mesh (axis names and sizes) the shape
    of one device's shard."""
    if mesh is None:
        if not _STATE:
            return None
        mesh, fsdp_active = _STATE[-1]
        fsdp = fsdp_active if fsdp is None else fsdp
    spec = spec_for(pdef, mesh, True if fsdp is None else fsdp)
    names = getattr(mesh, "mesh_dim_names", None)
    if names is None:
        return shard_shape(pdef.shape, spec, mesh)
    from torch.distributed.tensor import Replicate, Shard

    return tuple(Shard(spec.index(name)) if name in spec else Replicate()
                 for name in names)


def check_row_mesh(mesh, axis: str, n: int) -> int:
    """The number of shards of an ``n``-row bank on ``mesh``'s ``axis``;
    refuses a mesh without that axis or whose axis does not divide n."""
    from repro_torch.launch.mesh import mesh_axis_names, mesh_axis_size

    names = mesh_axis_names(mesh)
    if axis not in names:
        raise ValueError(f"mesh has no {axis!r} axis (axes: {names})")
    world = mesh_axis_size(mesh, axis)
    if n % world:
        raise ValueError(
            f"n_clients={n} must be divisible by the {axis!r} axis size "
            f"{world} to row-shard the bank"
        )
    return world


class RowShard:
    """This rank's contiguous block of bank rows on the ``axis`` of a
    clients mesh (a ``torch.distributed.device_mesh.DeviceMesh``)."""

    def __init__(self, mesh, axis: str, n: int):
        self.world = check_row_mesh(mesh, axis, n)
        self.mesh = mesh
        self.axis = axis
        self.group = mesh.get_group(axis)
        self.rank = int(mesh.get_local_rank(axis))
        self.n = n
        self.m = n // self.world
        self.lo = self.rank * self.m
        self.hi = self.lo + self.m

    def rows(self, x, lead: int = 0):
        """This rank's rows of a whole leaf (dim ``lead`` is the client
        dim), as a tensor of its own."""
        return x.narrow(lead, self.lo, self.m).contiguous()

    def all_gather(self, x, lead: int = 0):
        """The whole leaf from every rank's rows (dim ``lead``)."""
        import torch.distributed as dist

        x = x.movedim(lead, 0).contiguous()
        out = x.new_empty((self.world * x.shape[0],) + tuple(x.shape[1:]))
        dist.all_gather_into_tensor(out, x, group=self.group)
        return out.movedim(0, lead)

    def state_rows(self, state):
        """This rank's rows of every bank-row leaf of a whole ``FLState``;
        the random streams, the round and the cold template stay whole."""
        return _map_rows(state, self.rows)

    def state_whole(self, state):
        """The whole ``FLState`` from every rank's rows (each rank gets it)."""
        return _map_rows(state, self.all_gather)


def _map_rows(state, fn):
    """``fn(leaf, lead)`` on every bank-row leaf of ``state``: the params,
    momentum, w, losses and EF residual (rows first), the link buffers
    (``bufx`` and ``bufw`` rows second, ``last`` first) and the churn
    liveness."""
    from repro_torch.core.program import _is_empty

    def row(x, lead=0):
        return x if x is None or _is_empty(x) else fn(x, lead)

    link, churn = state.link, state.churn
    if not _is_empty(link):
        link = link._replace(bufx=row(link.bufx, 1), bufw=row(link.bufw, 1),
                             last=row(link.last))
    if not _is_empty(churn):
        churn = churn._replace(live=row(churn.live))
    return state._replace(params=row(state.params), mom=row(state.mom),
                          w=row(state.w), losses=row(state.losses),
                          comp=row(state.comp), link=link, churn=churn)


def bank_row_pins(mesh, axis: str, n: int):
    """The :class:`RowShard` of this rank for an ``n``-row bank on ``mesh``'s
    ``axis``, or ``None`` without a mesh (or without that axis): the
    unsharded program then runs exactly as before."""
    from repro_torch.launch.mesh import mesh_axis_names

    if mesh is None or axis not in mesh_axis_names(mesh):
        return None
    return RowShard(mesh, axis, n)
