"""The clients mesh — the port of ``repro.launch.mesh``'s
``make_clients_mesh``: a 1-D ``torch.distributed`` device mesh whose one
axis, ``"clients"``, row-shards the flat bank.

The reference forces host devices and builds a ``jax`` mesh inside one
process; the port's row-sharded program is SPMD over ``torch.distributed``,
one process a shard.  Nothing on the card's machine tells a process of a
cluster, so :func:`init_clients_world` starts the process group itself from
an explicit address, world size and rank: NCCL on CUDA, gloo when the caller
asks for the CPU (as the tests do).  There is no fallback from one to the
other.  ``make_host_mesh``, ``make_production_mesh`` and ``HARDWARE`` place
model parameters on the pod mesh and wait for ROADMAP items 14 and 13.7.
"""
from __future__ import annotations

import torch

__all__ = ["CLIENTS", "init_clients_world", "close_clients_world",
           "make_clients_mesh", "mesh_axis_names", "mesh_axis_size"]

CLIENTS = "clients"


def mesh_axis_names(mesh) -> tuple:
    """The axis names of a ``DeviceMesh`` (``mesh_dim_names``) or of any
    mesh-like object with ``axis_names`` (the reference's meshes, and the
    duck-typed meshes of the tests)."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is None:
        names = getattr(mesh, "axis_names", ())
    return tuple(names or ())


def mesh_axis_size(mesh, axis: str) -> int:
    """How many shards ``mesh`` has along ``axis``."""
    names = mesh_axis_names(mesh)
    if hasattr(mesh, "mesh_dim_names"):
        return int(mesh.size(names.index(axis)))
    return int(mesh.shape[axis])


def make_clients_mesh(n_devices: int | None = None, device="cuda"):
    """1-D ``DeviceMesh`` over every rank of the running process group, its
    one axis named ``"clients"``.  ``n_devices`` defaults to the world size
    and must equal it (each rank holds one shard).  ``make_program`` checks
    that the client count divides by the axis size."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError(
            "make_clients_mesh needs a running process group: start it "
            "with init_clients_world (or torch.distributed."
            "init_process_group with an explicit address, world size and "
            "rank)"
        )
    world = dist.get_world_size()
    if n_devices is None:
        n_devices = world
    if n_devices != world:
        raise ValueError(
            f"a clients mesh of {n_devices} shards needs a world of as many "
            f"ranks, one shard each; this world has {world}"
        )
    return init_device_mesh(torch.device(device).type, (n_devices,),
                            mesh_dim_names=(CLIENTS,))


def init_clients_world(rank: int, world_size: int, port: int,
                       device="cuda"):
    """Start the process group of one rank — NCCL for CUDA, gloo for the
    CPU — at ``tcp://localhost:port``, and return its clients mesh.  On
    CUDA the rank's card is ``cuda:rank`` (of the cards this host shows)."""
    import torch.distributed as dist

    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(rank % torch.cuda.device_count())
        backend = "nccl"
    elif dev.type == "cpu":
        backend = "gloo"
    else:
        raise ValueError(f"no clients mesh for device {dev}")
    dist.init_process_group(backend, init_method=f"tcp://localhost:{port}",
                            world_size=world_size, rank=rank)
    return make_clients_mesh(world_size, dev)


def close_clients_world() -> None:
    """Tear the process group down, so that later code sees none."""
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()
