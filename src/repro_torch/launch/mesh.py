"""Meshes of the port — the port of ``repro.launch.mesh``: the live
``torch.distributed`` device meshes (the clients mesh that row-shards the
flat bank, and the host mesh of the pod runtime), and the reference's
production meshes as abstract ones.

The reference forces host devices and builds a ``jax`` mesh inside one
process; the port is SPMD over ``torch.distributed``, one process a device.
Nothing on the card's machine tells a process of a cluster, so
:func:`init_world` starts the process group itself from an explicit address,
world size and rank, and returns the mesh of any shape over it: NCCL on
CUDA, gloo when the caller asks for the CPU (as the tests do).  There is no
fallback from one to the other.  :func:`init_clients_world` is its 1-D
``"clients"`` case.

:func:`make_host_mesh` is the pod runtime's live mesh (the reference's
``(2, 2, 2)`` ``("pod", "data", "model")`` on 8 forced host devices; here
over the running world): each pod's replica is placed over its ``("data",
"model")`` submesh (``launch.sharding.place_params``) and the pod axis
carries the gossip (``launch.steps.make_round_step``).

:func:`make_production_mesh` returns the reference's production meshes
(``(data, model)`` 16 x 16; ``(pod, data, model)`` 2 x 16 x 16) as an
:class:`AbstractMesh`: axis names and sizes, no devices.  :func:`fake_world`
makes a live mesh of any size in one process: rank 0 of a world of
``torch.distributed``'s ``"fake"`` backend, whose collectives move nothing
and leave their outputs as they were allocated.  The dry-run
(``repro_torch.launch.dryrun``) traces one rank's own step on it, on meta
tensors or (``chip_smoke.py``) on the card.  ``HARDWARE`` holds the H100
SXM constants of the roofline (``repro_torch.roofline``).
"""
from __future__ import annotations

import contextlib
import math
from typing import NamedTuple

import torch

__all__ = ["CLIENTS", "HARDWARE", "AbstractMesh", "card_hardware",
           "fake_world", "init_world", "init_clients_world",
           "close_clients_world",
           "make_clients_mesh", "make_host_mesh", "make_production_mesh",
           "mesh_axis_names", "mesh_axis_size"]

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


def _world_size() -> int:
    """The running world's size; refuses without a process group."""
    import torch.distributed as dist

    if not dist.is_initialized():
        raise RuntimeError(
            "a live mesh needs a running process group: start it with "
            "init_world (or torch.distributed.init_process_group with an "
            "explicit address, world size and rank)"
        )
    return dist.get_world_size()


def _live_mesh(shape: tuple, axes: tuple, device):
    """A ``DeviceMesh`` of ``shape`` over every rank of the running world,
    its dims named ``axes``; refuses a shape whose size is not the world's
    (each rank holds one device of the mesh)."""
    from torch.distributed.device_mesh import init_device_mesh

    shape, axes = tuple(int(n) for n in shape), tuple(axes)
    world = _world_size()
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in rank")
    size = 1
    for n in shape:
        size *= n
    if size != world:
        raise ValueError(
            f"a mesh of shape {shape} has {size} devices and needs a world "
            f"of as many ranks, one device each; this world has {world}"
        )
    return init_device_mesh(torch.device(device).type, shape,
                            mesh_dim_names=axes)


def make_clients_mesh(n_devices: int | None = None, device="cuda"):
    """1-D ``DeviceMesh`` over every rank of the running process group, its
    one axis named ``"clients"``.  ``n_devices`` defaults to the world size
    and must equal it (each rank holds one shard).  ``make_program`` checks
    that the client count divides by the axis size."""
    if n_devices is None:
        n_devices = _world_size()
    return _live_mesh((n_devices,), (CLIENTS,), device)


def make_host_mesh(shape=(2, 2), axes=("data", "model"), device="cuda"):
    """The pod runtime's live mesh over the running world: ``shape`` named
    ``axes`` (the reference's host mesh is ``(2, 2, 2)`` ``("pod", "data",
    "model")``).  Refuses without a process group, and refuses a shape whose
    size is not the world size."""
    return _live_mesh(shape, axes, device)


def init_world(rank: int, world_size: int, port: int | None = None,
               device="cuda", shape=None, axes=(CLIENTS,),
               addr: str = "localhost"):
    """Start the process group of one rank — NCCL for CUDA, gloo for the
    CPU — and return the live mesh of ``shape`` (default: the world on one
    axis) named ``axes`` over it.  The store is ``tcp://addr:port``; with
    ``port`` None it is read from the environment a launcher such as
    ``torch.distributed.run`` sets (``env://``).  On CUDA the rank's card is
    ``cuda:rank`` (of the cards this host shows)."""
    import torch.distributed as dist

    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(rank % torch.cuda.device_count())
        backend = "nccl"
    elif dev.type == "cpu":
        backend = "gloo"
    else:
        raise ValueError(f"no mesh for device {dev}")
    init = "env://" if port is None else f"tcp://{addr}:{port}"
    dist.init_process_group(backend, init_method=init,
                            world_size=world_size, rank=rank)
    return _live_mesh((world_size,) if shape is None else shape, axes, dev)


@contextlib.contextmanager
def fake_world(shape, axes, device="meta"):
    """Rank 0 of a world of ``prod(shape)`` ranks of the ``"fake"`` backend,
    in this process: yields the live mesh of ``shape`` named ``axes`` over
    it, and destroys the process group on leaving.  The collectives of the
    world move nothing: their outputs keep what they were allocated with,
    so only counts, memory and time mean anything under it.  ``device``
    is where the rank's tensors live: ``"meta"`` (the mesh then names the
    CPU) or a card.  Refuses to start while a process group runs.

    The backend's store, ``FakeStore``, is importable only from torch's
    private ``torch.testing._internal.distributed.fake_pg`` (torch 2.11 and
    2.13 alike): a pinned dependency on that module."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError(
            "a fake world needs this process without a process group; one "
            f"of {dist.get_world_size()} ranks is running")
    dev = torch.device(device)
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=math.prod(int(n) for n in shape))
    try:
        yield _live_mesh(shape, axes, "cpu" if dev.type == "meta" else dev)
    finally:
        dist.destroy_process_group()


def init_clients_world(rank: int, world_size: int, port: int,
                       device="cuda"):
    """Start the process group of one rank (:func:`init_world`) at
    ``tcp://localhost:port``, and return its clients mesh."""
    return init_world(rank, world_size, port, device)


def close_clients_world() -> None:
    """Tear the process group down, so that later code sees none."""
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()
