"""The clients mesh — the port of ``repro.launch.mesh``'s
``make_clients_mesh``: a 1-D ``torch.distributed`` device mesh whose one
axis, ``"clients"``, row-shards the flat bank.

The reference forces host devices and builds a ``jax`` mesh inside one
process; the port's row-sharded program is SPMD over ``torch.distributed``,
one process a shard.  Nothing on the card's machine tells a process of a
cluster, so :func:`init_clients_world` starts the process group itself from
an explicit address, world size and rank: NCCL on CUDA, gloo when the caller
asks for the CPU (as the tests do).  There is no fallback from one to the
other.

:func:`make_production_mesh` returns the reference's production meshes
(``(data, model)`` 16 x 16; ``(pod, data, model)`` 2 x 16 x 16) as an
:class:`AbstractMesh`: axis names and sizes, no devices.  A live mesh of 256
or 512 ranks cannot be built on one card; the dry-run
(``repro_torch.launch.dryrun``) only reads the axes to place parameters
(``launch.sharding.spec_for``).  ``HARDWARE`` holds the H100 SXM constants
of the roofline (``repro_torch.roofline``).  ``make_host_mesh``, which
places a live model across cards, waits for the pod runtime (ROADMAP item
13.7).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

__all__ = ["CLIENTS", "HARDWARE", "AbstractMesh", "card_hardware",
           "init_clients_world", "close_clients_world", "make_clients_mesh",
           "make_production_mesh", "mesh_axis_names", "mesh_axis_size"]

CLIENTS = "clients"

# NVIDIA H100 SXM constants of the roofline (NVIDIA's data sheet, dense
# rates, 700 W).  ``link_bw`` is one direction of NVLink 4 (900 GB/s both
# ways) and takes the place of the reference's ``ici_bw``: a 16-wide model
# axis spans two 8-card nodes, whose links are slower, so the collective
# term is a lower bound there.  ``hbm_bytes`` is the data sheet's 80 GB;
# :func:`card_hardware` reads it from the card.
HARDWARE = {
    "chip": "h100-sxm",
    "peak_flops_bf16": 989e12,  # FLOP/s, dense, on the tensor cores
    "peak_flops_f32": 67e12,  # FLOP/s outside the tensor cores
    "hbm_bw": 3.35e12,  # B/s
    "link_bw": 450e9,  # B/s, NVLink 4, one direction
    "hbm_bytes": 80 * 10 ** 9,
}


def card_hardware(device=0) -> dict:
    """``HARDWARE`` with ``hbm_bytes`` read from the card
    (``torch.cuda.get_device_properties``); raises without one."""
    props = torch.cuda.get_device_properties(device)
    return {**HARDWARE, "chip": props.name, "hbm_bytes": props.total_memory}


class AbstractMesh(NamedTuple):
    """A mesh by its axes alone: ``axis_names`` and ``shape`` (axis name ->
    size), as the reference's ``jax`` meshes expose them."""

    axis_names: tuple
    shape: dict

    @property
    def size(self) -> int:
        n = 1
        for name in self.axis_names:
            n *= self.shape[name]
        return n


def make_production_mesh(*, multi_pod: bool = False) -> AbstractMesh:
    """The reference's production mesh: ``(data, model)`` 16 x 16, or with
    ``multi_pod`` ``(pod, data, model)`` 2 x 16 x 16 (the ``pod`` axis is
    the DFL client axis: each pod holds one push-sum replica)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return AbstractMesh(axes, dict(zip(axes, shape)))


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
