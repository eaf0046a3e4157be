"""Personalized lanes of the MoE family (dbrx-132b: GQA, softmax top 2 of 4
experts at ``reduced`` size; deepseek-v3-671b: MLA, sigmoid top 2 of 4 and
a shared expert) against the JAX reference on the CPU, f32: the port's
lane-stacked ``prefill`` / ``decode_step`` against the reference's
``make_personalized_serve_step``, its laned ``forward`` (logits and the
per-lane ``moe_aux``) against ``jax.vmap`` of the reference's, and
``serve.main --clients`` (``tests/_torch_lanes.py`` states the setup and
the tolerances).

Each lane routes through its own router and experts, with capacity and
positions per batch row, which under the reference's vmap with an inner
batch of 1 is per lane; both sides run the config's own capacity factor.
The aux loss is each lane's mean over the layers, held within 1e-5 of its
magnitude (f32 means in each library's order).  A mutant must miss: the
port's lanes 0 and 1 swapped.
"""
import numpy as np
import pytest
import torch
from _torch_blocks import one_thread  # noqa: F401  (an autouse fixture)
from _torch_lanes import (
    IDS,
    Lanes,
    close,
    serve_main_with_clients,
    swapped,
)

from repro.configs import registry as ref_registry
from repro_torch.configs import registry
from repro_torch.models import moe

ARCHS = ("dbrx-132b", "deepseek-v3-671b")
S = 24

_CACHE: dict = {}


def _setup(arch):
    if arch not in _CACHE:
        ref_cfg = ref_registry.get_config(arch, smoke=True)
        lanes = Lanes(ref_cfg, registry.get_config(arch, smoke=True))
        batch = {k: np.asarray(v) for k, v in ref_registry.make_batch(
            ref_cfg, len(IDS), S, seed=1).items()}
        _CACHE[arch] = lanes, batch
    return _CACHE[arch]


@pytest.mark.parametrize("arch", ARCHS)
def test_laned_prefill_and_decode_match_the_reference(arch):
    lanes, batch = _setup(arch)
    lanes.serve(batch)


@pytest.mark.parametrize("arch", ARCHS)
def test_laned_forward_and_its_per_lane_aux_match_the_reference(arch):
    lanes, batch = _setup(arch)
    (logits, aux), (ref_logits, ref_aux) = lanes.forward(batch)
    close(logits, ref_logits, f"{arch} forward logits")
    assert tuple(aux["moe_aux"].shape) == (len(IDS),)
    close(aux["moe_aux"], ref_aux["moe_aux"], f"{arch} moe_aux", 1e-5)
    # Each lane's own aux, not one over the batch: the lanes differ.
    assert len(set(aux["moe_aux"].tolist())) == len(IDS)


@pytest.mark.parametrize("arch", ARCHS)
def test_swapped_lane_weights_miss_the_tolerance(arch):
    lanes, batch = _setup(arch)
    err = lanes.prefill_error(batch, swapped(lanes.stacked))
    assert err > 1e-3, f"{arch}: swapped lanes within {err:.3e}"


def test_lane_slots_run_one_bmm_over_the_lane_experts(monkeypatch):
    """With lanes the dispatch lays its slots out (lane, expert, capacity):
    ``_expert_products`` runs once a lane, lane b's ``(E, C, d)`` block
    against lane b's ``(E, d, f)`` experts, views of the stacked leaf (no
    copy of the weights); without lanes it runs once on ``(E, B * C,
    d)``."""
    lanes, batch = _setup("dbrx-132b")
    cfg, seen = lanes.api.cfg, []
    products = moe._expert_products

    def spy(p, xin):
        seen.append((tuple(xin.shape), tuple(p["wi"].shape),
                     p["wi"].data_ptr()))
        return products(p, xin)

    monkeypatch.setattr(moe, "_expert_products", spy)
    tokens = torch.from_numpy(batch["tokens"])
    c = moe.moe_capacity(S, cfg)
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    wi = lanes.stacked["layers"]["mlp"]["wi"]  # (B, L, E, d, f)
    with torch.no_grad():
        lanes.api.forward(lanes.stacked, {"tokens": tokens})
        assert seen[:3] == [((e, c, d), (e, d, f), wi[b, 0].data_ptr())
                            for b in range(3)]
        assert len(seen) == 3 * cfg.n_layers
        seen.clear()
        lanes.api.forward(lanes.spec.base, {"tokens": tokens})
        assert [x[:2] for x in seen[:1]] == [((e, 3 * c, d), (e, d, f))]


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_main_with_clients_serves_the_moe_family(arch, capsys):
    serve_main_with_clients(arch, capsys)


@pytest.mark.parametrize("limit", [1 << 26, 2 * 33 * 17, 33 * 17, 100, 5])
def test_debias_stacked_in_pieces_is_the_whole_leaf_expansion(limit,
                                                              monkeypatch):
    """``BoundDeltaSpec.debias_stacked`` builds each leaf in pieces of at
    most ``flat._PIECE_ELEMS`` elements, set here to ``limit`` (whole
    matrices of the leading axes, or rows of one), so that one of deepseek-v3-671b's expert leaves, ``(1, 256, 7168,
    2048)``, never stands expanded whole in f32; each row's lanes must equal
    :meth:`debias` of that row, which expands every leaf whole, bit for bit:
    a 3-D and a 4-D low-rank leaf, a bf16 one, and a dense one."""
    from repro_torch.core import flat
    from repro_torch.core.flat import (
        bind_delta_spec,
        make_delta_spec,
        tree_flatten,
    )

    monkeypatch.setattr(flat, "_PIECE_ELEMS", limit)

    gen = torch.Generator().manual_seed(0)
    base = {"experts": torch.randn((6, 33, 17), generator=gen),
            "layers": torch.randn((2, 3, 20, 30), generator=gen),
            "embed": torch.randn((40, 9), generator=gen).to(torch.bfloat16),
            "norm": torch.randn((5,), generator=gen)}
    spec = bind_delta_spec(make_delta_spec(base, rank=2), base)
    assert sorted(spec.delta.modes) == ["dense"] + ["lowrank"] * 3
    bank = torch.randn((3, spec.dim), generator=gen)
    w = torch.rand((3,), generator=gen) + 0.5
    paths, got = tree_flatten(spec.debias_stacked(bank, w))
    for b in range(3):
        want = tree_flatten(spec.debias(bank[b], w[b]))[1]
        for path, g, x in zip(paths, got, want):
            assert g.dtype == x.dtype
            assert torch.equal(g[b], x), (limit, path, b)
