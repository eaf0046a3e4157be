"""The port's executor rule ``repro_torch.comm.plan.resolve_backend`` against
the reference's ``repro.comm.plan.resolve_backend``, case for case: every
``gossip`` value, both operator forms (``sparse_mix``), each family (ring,
exponential, kout, two_tier, and the symmetric mixer), without a mesh, on a
mesh without the bank-row axis, and on meshes of 1 and 8 shards.  Both
must refuse the same cases (``ValueError``) and otherwise pick the same
executor: ``None``, ``"xla"`` (the all-gather), or a ``HaloBackend`` whose
plan equals the reference's field for field.  A duck-typed mesh
(``axis_names`` and a ``shape`` dict, what the reference reads) serves both
packages, so no device is forced.  Also ``CommPlan.build`` for two_tier.
"""
import pytest

from repro.comm import plan as ref_plan
from repro.core import TopologyConfig as RefTopo
from repro_torch.comm import plan
from repro_torch.core import TopologyConfig
from _torch_threads import one_thread  # noqa: F401,E402  (an autouse fixture)

GOSSIP = ("auto", "sparse", "dense", "xla", "halo", "nccl")
N = 64


class Mesh:
    """What both rules read of a mesh: its axis names and their sizes."""

    def __init__(self, **axes):
        self.axis_names = tuple(axes)
        self.shape = dict(axes)


FAMILIES = {
    "ring": (dict(kind="ring", k_out=1), "directed"),
    "exponential": (dict(kind="exponential", k_out=1), "directed"),
    "kout": (dict(kind="kout", k_out=10), "directed"),
    "two_tier": (dict(kind="two_tier", k_out=10, n_pods=8), "directed"),
    "symmetric": (dict(kind="kout", k_out=4), "symmetric"),
}
MESHES = {"none": None, "data-axis": Mesh(data=2), "clients-1": Mesh(clients=1),
          "clients-8": Mesh(clients=8)}


def _plan_fields(p):
    return (p.n_shards, p.m, p.k_in, p.k_max, p.static,
            tuple((leg.delta, tuple(leg.offsets)) for leg in p.legs),
            p.capacity, p.mixer_kind, p.topo.kind)


def _outcome(rule, gossip, sparse_mix, topo, mixer_kind, mesh):
    try:
        got = rule(gossip, sparse_mix, topo, mixer_kind, mesh, "clients")
    except ValueError as e:
        return ("raises", str(e).split(";")[0][:40])
    if got is None or isinstance(got, str):
        return ("value", got)
    assert got.mesh is mesh and got.axis == "clients"
    return ("halo", _plan_fields(got.plan))


@pytest.mark.parametrize("mesh", list(MESHES), ids=list(MESHES))
@pytest.mark.parametrize("family", list(FAMILIES))
def test_resolve_backend_matches_the_reference(family, mesh):
    kw, mixer_kind = FAMILIES[family]
    ref_topo = RefTopo(n_clients=N, **kw)
    topo = TopologyConfig(n_clients=N, **kw)
    m = MESHES[mesh]
    seen = set()
    for gossip in GOSSIP:
        for sparse_mix in (False, True):
            want = _outcome(ref_plan.resolve_backend, gossip, sparse_mix,
                            ref_topo, mixer_kind, m)
            got = _outcome(plan.resolve_backend, gossip, sparse_mix, topo,
                           mixer_kind, m)
            assert got == want, (family, mesh, gossip, sparse_mix)
            seen.add(got[0])
    # Every mesh case exercises a refusal (halo without the axis, or the
    # unknown gossip value) and at least one executor.
    assert "raises" in seen and len(seen) >= 2


@pytest.mark.parametrize("shards", [1, 2, 8])
def test_two_tier_plan_matches_the_reference(shards):
    kw = dict(kind="two_tier", n_clients=N, k_out=10, n_pods=8)
    got = plan.CommPlan.build(TopologyConfig(**kw), shards)
    want = ref_plan.CommPlan.build(RefTopo(**kw), shards)
    assert _plan_fields(got) == _plan_fields(want)
    assert got.halo_rows() == want.halo_rows()
    assert got.request_ints() == want.request_ints()
    assert got.halo_bytes(1000) == want.halo_bytes(1000)
    assert got.allgather_rows() == want.allgather_rows()
    assert got.pageable and got.closure_bound(4) == want.closure_bound(4)
    # The dynamic transport's capacity is the sender's whole shard.
    assert got.static == (shards == 1) and got.capacity == (
        0 if shards == 1 else N // shards)
