"""Row sharding of the flat client bank — the port of
``repro.launch.sharding.bank_row_pins``.

The reference pins every bank-row leaf of its one GSPMD program to the mesh
axis with sharding constraints.  The port's sharded round is SPMD over
``torch.distributed``: each rank holds ``m = n / world`` contiguous rows
``[lo, lo + m)`` of every bank-row leaf (params, momentum, w, losses, the
EF residual, the link buffers, the churn liveness), and :class:`RowShard` is
the one object that knows which — it slices a whole leaf to the rank's
rows and gathers the rows of every rank back into a whole leaf.  The
placement of model parameters (``spec_for``, ``sharding_for``,
``use_mesh``, ``constrain``) waits for ROADMAP item 14.
"""
from __future__ import annotations

import torch

__all__ = ["RowShard", "bank_row_pins", "check_row_mesh"]


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
