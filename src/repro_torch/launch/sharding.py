"""Placement on a mesh — the port of ``repro.launch.sharding``: the
logical-axis rules of model parameters and caches (``spec_for``,
``sharding_for``, ``use_mesh``), the pod runtime's placement of parameters
and activations (``place_params``, ``constrain``, ``in_manual_region``), and
the row sharding of the flat client bank (``bank_row_pins``).

Models declare *logical* axes ("heads", "mlp", "embed", "batch", ...);
:func:`spec_for` maps them onto the mesh axes ("data", "model"[, "pod"])
exactly as the reference does, as a tuple of the ``PartitionSpec``'s
entries.  The dry-run (``repro_torch.launch.dryrun``) reads the specs to
count each device's bytes and collectives on the reference's production
meshes; the pod runtime (``launch.steps.make_round_step`` under
:func:`use_mesh`) turns them into DTensor placements on each pod's
``("data", "model")`` submesh (:func:`place_params`), where the GSPMD
partitioner of the reference becomes DTensor's sharding propagation.
:func:`constrain` is the reference's activation constraint: it
redistributes a DTensor activation to the placements its logical names
resolve to (``ACT_RULES``).  Inside a manual region (:func:`manual_region`:
the flash kernel's call on each rank's local heads, the pod ring's halo
exchange) values are per-rank shards, and it returns its input.

Every family's replica runs as DTensors over its pod's submesh, the
experts of a mixture on the "model" axis (``"expert"`` leads
``MODEL_AXES``).  The cores that DTensor has no sharding rule for, or whose
rule would move more than the layer needs, run in a manual region on each
rank's local block (:func:`local_part` in, :func:`from_local` out): the
flash kernel on local heads, xlstm's mLSTM and sLSTM on local heads,
hymba's SSM on local channels, MLA's scores on local heads and a mixture's
routing, dispatch, experts and combine on local experts (the combine then a
partial sum over "model", :func:`sum_partial`).

The reference pins every bank-row leaf of its one GSPMD program to the mesh
axis with sharding constraints.  The port's sharded round is SPMD over
``torch.distributed``: each rank holds ``m = n / world`` contiguous rows
``[lo, lo + m)`` of every bank-row leaf (params, momentum, w, losses, the
EF residual, the link buffers, the churn liveness), and :class:`RowShard` is
the one object that knows which — it slices a whole leaf to the rank's
rows and gathers the rows of every rank back into a whole leaf.  The pod
runtime's gossip uses it over the ``"pod"`` axis.
"""
from __future__ import annotations

import contextlib
import math

import torch

__all__ = ["MODEL_AXES", "FSDP_AXES", "ACT_RULES", "POD_AXES", "use_mesh",
           "active_mesh", "spec_for", "model_axes_for", "pod_spec",
           "cache_spec", "place_cache", "cache_zeros", "sharding_for",
           "shard_shape",
           "placements_for", "place_tensor", "place_params", "submesh",
           "is_dtensor", "unshard_data", "full_tensor", "model_block",
           "local_part", "from_local", "sum_partial", "whole_grad",
           "gather_model", "gathered_local", "shared_grad", "manual_region",
           "in_manual_region",
           "constrain", "RowShard", "bank_row_pins", "check_row_mesh"]

# Logical axes eligible for tensor/expert parallelism, in priority order —
# the *first* divisible dim of a param gets the "model" mesh axis.
MODEL_AXES = ("expert", "vocab", "heads", "kv_heads", "mlp", "head_dim",
              "ssm_inner")
# Logical axes eligible for FSDP-style sharding over "data".
FSDP_AXES = ("embed", "ffpar", "frontend", "rank")
# Activation logical names -> mesh axes (the reference's ``constrain``
# rules).
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

# The mesh axes a pod's replica is placed over (the submesh of one pod).
POD_AXES = ("data", "model")

_STATE: list = []  # stack of (mesh, fsdp: bool)
_MANUAL: list = []  # stack of the meshes of the open manual regions


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


def model_axes_for(cfg) -> tuple:
    """The logical axes a config's leaves may put on "model", in priority
    order: ``MODEL_AXES``, without head_dim under ``attn_fallback =
    "replicate"``."""
    if cfg.attn_fallback == "replicate":
        return tuple(a for a in MODEL_AXES if a != "head_dim")
    return MODEL_AXES


def pod_spec(spec: tuple, batch_dims: tuple, shape: tuple, n_pods: int,
             data_n: int = 16) -> tuple:
    """Widen a single-pod spec over the pods, as the reference's dry-run
    does: a batch dim on "data" that divides by ``data_n * n_pods`` goes on
    ``("pod", "data")``; everything else is left as it is (replicated over
    the pods)."""
    if n_pods <= 1:
        return tuple(spec)
    out = list(spec) + [None] * (len(shape) - len(spec))
    for i in batch_dims:
        if out[i] == "data" and shape[i] % (data_n * n_pods) == 0:
            out[i] = ("pod", "data")
    return tuple(out)


def cache_spec(pdef, mesh, cfg) -> tuple:
    """A serving cache leaf's ``PartitionSpec`` entries on ``mesh``, as the
    reference's dry-run places the cache (``_abstract_cache``): by
    :func:`spec_for` without FSDP (kv heads, else head_dim, or an SSM
    state's channels on "model"; the batch on "data", else a long cache's
    sequence), or with ``cfg.serve_cache_shard == "seq"`` the batch on
    "data" and the sequence on "model"; on a mesh with pods the batch dims
    widened over them (:func:`pod_spec`)."""
    model_n = _axis_size(mesh, "model")
    data_n = _axis_size(mesh, "data")
    if cfg.serve_cache_shard == "seq" and "seq" in pdef.axes:
        spec = tuple("data" if a == "batch" and data_n and n % data_n == 0
                     else "model" if a == "seq" and model_n
                     and n % model_n == 0 else None
                     for a, n in zip(pdef.axes, pdef.shape))
    else:
        spec = spec_for(pdef, mesh, fsdp=False, model_axes=model_axes_for(cfg))
    bdims = tuple(i for i, a in enumerate(pdef.axes) if a == "batch")
    return pod_spec(spec, bdims, pdef.shape, _axis_size(mesh, "pod"),
                    data_n or 1)


def _sub_spec(spec: tuple) -> tuple:
    """A spec on the pod-runtime mesh as its submesh sees it: a dim on
    ``("pod", "data")`` is on "data" (the pod's rows taken first)."""
    return tuple("data" if a == ("pod", "data") else a for a in spec)


def place_cache(cache, defs, mesh, cfg):
    """Place a serving cache (whole tensors, the same on every rank) over the
    pod runtime's ``mesh`` as DTensors on the pod's ``("data", "model")``
    submesh, each leaf by :func:`cache_spec`: where it puts a batch dim on
    ``("pod", "data")`` the rank's pod takes its rows of it first (as its
    requests' tokens are), and the rest is replicated over the pods."""
    sub = submesh(mesh)

    def one(x, d):
        if isinstance(x, dict):
            return {k: one(x[k], d[k]) for k in x}
        spec = cache_spec(d, mesh, cfg)
        for i, a in enumerate(spec):
            if a == ("pod", "data"):
                x = RowShard(mesh, "pod", x.shape[i]).rows(x, i)
        return place_tensor(x, sub, placements_for(_sub_spec(spec), sub))

    return one(cache, defs)


def cache_zeros(defs, mesh, cfg, device=None):
    """A zero serving cache placed as :func:`place_cache` places one, built
    on each rank from its own blocks: ``defs`` are the cache of the pod's
    requests (their rows only) and ``mesh`` is the pod's ``("data",
    "model")`` submesh, the mesh of the prefill's activations."""
    from torch.distributed.tensor import DTensor

    def one(d):
        if not hasattr(d, "axes"):
            return {k: one(d[k]) for k in d}
        pls = placements_for(cache_spec(d, mesh, cfg), mesh)
        local = list(d.shape)
        for i, pl in enumerate(pls):
            if pl.is_shard():
                local[pl.dim] //= mesh.size(i)
        z = torch.zeros(local, dtype=d.dtype, device=device)
        return DTensor.from_local(z, mesh, pls, run_check=False,
                                  shape=torch.Size(d.shape),
                                  stride=torch.empty(d.shape,
                                                     device="meta").stride())

    return one(defs)


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


def placements_for(spec: tuple, mesh, lead: int = 0) -> tuple:
    """The DTensor placements of ``spec`` (:func:`spec_for`'s tuple) on a
    live mesh: one per mesh dim, ``Shard(lead + i)`` for the dim ``i`` that
    ``spec`` puts on it, else ``Replicate()`` (a mesh dim of one device
    too: one shard is the whole, and a view of a dim of size 1 may drop
    it).  ``lead`` counts leading dims that ``spec`` does not cover (the
    stacked pods of the pod runtime)."""
    from torch.distributed.tensor import Replicate, Shard

    return tuple(Shard(lead + spec.index(name))
                 if name in spec and mesh.size(i) > 1 else Replicate()
                 for i, name in enumerate(mesh.mesh_dim_names))


def submesh(mesh):
    """The pod's ``("data", "model")`` submesh of a live pod-runtime mesh
    (the axes of :data:`POD_AXES` that ``mesh`` has)."""
    from repro_torch.launch.mesh import mesh_axis_names

    names = tuple(a for a in POD_AXES if a in mesh_axis_names(mesh))
    if not names:
        raise ValueError(f"mesh has none of the axes {POD_AXES}")
    return mesh[names]


def is_dtensor(x) -> bool:
    """Whether ``x`` is a ``torch.distributed.tensor.DTensor``."""
    if not isinstance(x, torch.Tensor) or type(x) is torch.Tensor:
        return False
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def full_tensor(x):
    """The whole tensor of a DTensor (gathered over its mesh), or ``x``."""
    return x.full_tensor() if is_dtensor(x) else x


def unshard_data(x):
    """FSDP's gather: a DTensor leaf sharded on the "data" axis,
    all-gathered there for its use (its gradient, a partial sum over the
    batch shards, is reduce-scattered back by the backward); anything else
    as it is."""
    if not is_dtensor(x) or "data" not in x.device_mesh.mesh_dim_names:
        return x
    i = x.device_mesh.mesh_dim_names.index("data")
    if not x.placements[i].is_shard():
        return x
    from torch.distributed.tensor import Replicate

    pl = list(x.placements)
    pl[i] = Replicate()
    return x.redistribute(x.device_mesh, pl)


def place_tensor(x, dmesh, placements):
    """``x`` (the whole tensor, the same on every rank) as a DTensor of
    ``placements`` on ``dmesh``: each rank keeps its own block, no
    collective (a replicated tensor redistributed to shards is sliced)."""
    from torch.distributed.tensor import DTensor, Replicate

    rep = DTensor.from_local(x, dmesh, [Replicate()] * dmesh.ndim,
                             run_check=False)
    return rep.redistribute(dmesh, placements)


def place_params(tree, defs, mesh, fsdp: bool = True, lead: int = 0,
                 model_axes: tuple = None):
    """Place a parameter tree (whole tensors, the same on every rank) over
    the pod's ``("data", "model")`` submesh of ``mesh`` as DTensors: each
    leaf by its ``PDef``'s :func:`spec_for` tuple on ``mesh`` (with
    ``model_axes``; :func:`placements_for`).  ``lead`` leading dims of every
    leaf (the pods stacked on one rank) stay whole.  On a pod-only mesh (a
    submesh of one device) every placement is ``Replicate``: the replica is
    whole on its pod's rank, and runs as DTensors all the same."""
    sub = submesh(mesh)

    def one(x, d):
        if isinstance(x, dict):
            return {k: one(x[k], d[k]) for k in x}
        spec = spec_for(d, mesh, fsdp, model_axes)
        return place_tensor(x, sub, placements_for(spec, sub, lead))

    return one(tree, defs)


def model_block(mesh) -> tuple:
    """(this rank's index on ``mesh``'s "model" dim, its size): (0, 1) on a
    mesh without one."""
    names = mesh.mesh_dim_names
    if "model" not in names:
        return 0, 1
    i = names.index("model")
    return int(mesh.get_local_rank(i)), mesh.size(i)


def local_part(x, act, own_model: bool = True):
    """The local block of DTensor ``x`` for a manual region whose work on
    each rank is its own: the gradient of the block comes back as a
    ``Partial`` sum on every mesh dim where ``x`` is replicated but the
    ranks' work differs — "model" (each rank takes its own heads, channels
    or experts; not with ``own_model`` False, where every rank of the dim
    does the same work), and "data" where the activation ``act`` splits the
    batch there (each rank reads its own rows)."""
    from torch.distributed.tensor import Partial

    mesh = x.device_mesh
    grads = []
    for i, (name, pl) in enumerate(zip(mesh.mesh_dim_names, x.placements)):
        split = (own_model if name == "model"
                 else act.placements[i].is_shard())
        grads.append(Partial() if pl.is_replicate() and mesh.size(i) > 1
                     and split else pl)
    return x.to_local(grad_placements=grads)


def from_local(xl, act, model=None):
    """A manual region's local result ``xl`` as a DTensor on ``act``'s mesh:
    the batch placed as ``act``'s, and on "model" ``model`` (a placement:
    ``Shard(i)`` for a block of dim i, ``Partial()`` for a rank's partial
    sum; ``Replicate()`` when None)."""
    from torch.distributed.tensor import DTensor, Replicate

    mesh = act.device_mesh
    pls = [(model or Replicate()) if name == "model" and mesh.size(i) > 1
           else act.placements[i] if name != "model" else Replicate()
           for i, name in enumerate(mesh.mesh_dim_names)]
    return DTensor.from_local(xl, mesh, pls, run_check=False)


def sum_partial(x):
    """A DTensor that is a partial sum on some mesh dims, summed there (one
    all-reduce a dim) as :func:`constrain` does: its gradient is made whole
    there too (a partial sum arriving from the layers above is reduced
    here, the tensor-parallel backward all-reduce); anything else as it
    is."""
    if not is_dtensor(x) or not any(p.is_partial() for p in x.placements):
        return x
    from torch.distributed.tensor import Replicate

    return _Constrain.apply(x, tuple(
        Replicate() if p.is_partial() else p for p in x.placements))


def whole_grad(x):
    """DTensor ``x`` as it is, its gradient made whole in ``x``'s placements
    (a partial sum arriving from a column-parallel projection above is
    all-reduced here, Megatron's input operator); anything else as it
    is."""
    return _Constrain.apply(x, tuple(x.placements)) if is_dtensor(x) else x


def gather_model(x):
    """DTensor ``x`` replicated on the "model" dim (an all-gather of its
    blocks there; its gradient, each rank's share, is reduce-scattered
    back); anything else as it is."""
    if not is_dtensor(x) or "model" not in x.device_mesh.mesh_dim_names:
        return x
    from torch.distributed.tensor import Replicate

    i = x.device_mesh.mesh_dim_names.index("model")
    if x.placements[i].is_replicate():
        return x
    pls = list(x.placements)
    pls[i] = Replicate()
    return x.redistribute(x.device_mesh, pls)


def gathered_local(x, act):
    """The whole of DTensor ``x`` (a weight replicated on "data") as a plain
    tensor for a manual region whose ranks use it each for their own part
    of the work: its blocks on "model" gathered by one all-gather (whose
    backward reduce-scatters the ranks' partial gradients back to each
    block), its gradient otherwise a partial sum where the activation
    ``act`` splits the batch (reduced where it takes ``x``'s placements, as
    every replicated weight's is)."""
    xl = local_part(x, act, own_model=False)
    if "model" not in x.device_mesh.mesh_dim_names:
        return xl
    i = x.device_mesh.mesh_dim_names.index("model")
    if not x.placements[i].is_shard():
        return xl
    from torch.distributed import _functional_collectives as funcol

    return funcol.all_gather_tensor_autograd(xl, x.placements[i].dim,
                                             (x.device_mesh, i))


class _SharedGrad(torch.autograd.Function):
    """The identity, its gradient divided by ``n``."""

    @staticmethod
    def forward(ctx, x, n):
        ctx.n = n
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g / ctx.n, None


def shared_grad(x, n: int):
    """A manual region's value that every one of ``n`` ranks computes alike
    from inputs whose gradient is a ``Partial`` sum over them
    (:func:`local_part`): the value as it is, its gradient divided by ``n``,
    so that the sum counts it once."""
    return x if n == 1 else _SharedGrad.apply(x, n)


@contextlib.contextmanager
def manual_region(mesh=None):
    """A region whose values are per-rank shards (the reference's
    ``shard_map`` manual region): a hand-written kernel's call on local
    shards, the pod ring's halo exchange.  :func:`constrain` returns its
    input inside."""
    _MANUAL.append(mesh)
    try:
        yield
    finally:
        _MANUAL.pop()


def in_manual_region(mesh=None) -> bool:
    """Is the caller inside a :func:`manual_region` (over an axis of
    ``mesh``, the active mesh when ``None``)?  False without any mesh, as
    the reference's probe is."""
    from repro_torch.launch.mesh import mesh_axis_names

    if not _MANUAL:
        return False
    if mesh is None:
        mesh = active_mesh()
    if mesh is None:
        return False
    names = set(mesh_axis_names(mesh))
    return any(m is None or names & set(mesh_axis_names(m)) for m in _MANUAL)


def constrain(x, logical: tuple):
    """Activation sharding constraint by logical names (no-op without an
    active mesh).  The names resolve by ``ACT_RULES`` as the reference's
    do (each mesh axis on the first divisible dim); a DTensor is
    redistributed to those placements on its own mesh, a plain tensor (a
    replica whole on its rank) passes through.  Inside a manual region
    (:func:`in_manual_region`) the value is already per-rank and is
    returned as it is — but a malformed constraint (a name that is no
    logical axis, a rank mismatch) raises there too."""
    if not _STATE:
        return x
    mesh, _ = _STATE[-1]
    if len(logical) != x.dim():
        raise ValueError(
            f"constraint {logical} names {len(logical)} dims of a rank-"
            f"{x.dim()} activation")
    spec: list = [None] * x.dim()
    for i, name in enumerate(logical):
        if name is None:
            continue
        if name not in ACT_RULES:
            raise ValueError(
                f"unknown logical axis {name!r} (known: {sorted(ACT_RULES)})")
        mesh_axis = ACT_RULES[name]
        if mesh_axis in (None, "head_dim_fallback"):
            continue
        n = _axis_size(mesh, mesh_axis)
        if n and x.shape[i] % n == 0 and mesh_axis not in spec:
            spec[i] = mesh_axis
    if in_manual_region(mesh) or not is_dtensor(x):
        return x
    placements = placements_for(tuple(spec), x.device_mesh)
    if tuple(x.placements) == placements:
        return x
    return _Constrain.apply(x, placements)


class _Constrain(torch.autograd.Function):
    """A DTensor redistributed to ``placements``, and its gradient too: the
    reference's sharding constraint holds for the cotangent, so a partial
    sum arriving from the layers above is reduced here (the tensor-parallel
    backward all-reduce) and not carried into the weight gradients."""

    @staticmethod
    def forward(ctx, x, placements):
        ctx.placements = placements
        ctx.inputs = tuple(x.placements)
        return x.redistribute(x.device_mesh, placements)

    @staticmethod
    def backward(ctx, g):
        g = g.redistribute(g.device_mesh, ctx.placements)
        # A partial input takes the whole gradient as it is.
        back = [pc if pi.is_partial() else pi
                for pi, pc in zip(ctx.inputs, ctx.placements)]
        return g.redistribute(g.device_mesh, back), None


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
        dim), as a tensor of its own: a block of the leading dim, contiguous
        as it is, is copied too, so that it keeps no other rank's rows
        alive."""
        rows = x.narrow(lead, self.lo, self.m)
        return (rows.clone(memory_format=torch.contiguous_format)
                if self.m < self.n else rows.contiguous())

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
