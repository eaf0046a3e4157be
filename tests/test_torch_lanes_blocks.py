"""Personalized lanes of the recurrent and hybrid block kinds against the
JAX reference on the CPU, f32 (``tests/_torch_lanes.py`` states the setup
and the tolerances; ``tests/test_torch_{xlstm,hymba}.py`` state the same
1e-4 for logits and decode):

- xlstm-350m at ``reduced`` size as 2 groups of [2 mLSTM, 1 sLSTM]
  (``n_layers=6, slstm_every=3``): the block views follow the lane axis
  (``(B, groups, n, ...)`` leaves), the sLSTM's recurrence reads each
  lane's own ``(H, hd, 4 hd)`` ``r``; ``prefill`` is recurrent in both
  packages.
- hymba-1.5b at ``reduced`` size (8 meta tokens, a global layer 0 and a
  32-token window on layer 1; 40 prompt tokens, so the window closes the
  meta tokens to the last rows): each lane puts its own meta tokens before
  its row, and its SSM's ``b_dt``, ``A_log`` and ``D`` are its own.

For each: the port's lane-stacked ``prefill`` / ``decode_step`` against the
reference's ``make_personalized_serve_step``, the laned ``forward`` against
``jax.vmap`` of the reference's, and ``serve.main --clients``.  Mutants
must miss: the port's lanes 0 and 1 swapped; hymba's meta tokens broadcast
from lane 0.
"""
import numpy as np
import pytest
from _torch_blocks import one_thread  # noqa: F401  (an autouse fixture)
from _torch_lanes import (
    IDS,
    Lanes,
    close,
    serve_main_with_clients,
    swapped,
)

from repro.configs import base as ref_base
from repro.configs import registry as ref_registry
from repro_torch.configs import base, registry

XLSTM, HYMBA = "xlstm-350m", "hymba-1.5b"
ARCHS = (XLSTM, HYMBA)
SHAPES = {XLSTM: dict(n_layers=6, slstm_every=3), HYMBA: {}}
S = {XLSTM: 16, HYMBA: 40}

_CACHE: dict = {}


def _setup(arch):
    if arch not in _CACHE:
        ref_cfg = ref_base.reduced(ref_registry.get_config(arch),
                                   **SHAPES[arch])
        cfg = base.reduced(registry.get_config(arch), **SHAPES[arch])
        batch = {k: np.asarray(v) for k, v in ref_registry.make_batch(
            ref_cfg, len(IDS), S[arch], seed=1).items()}
        _CACHE[arch] = Lanes(ref_cfg, cfg), batch
    return _CACHE[arch]


@pytest.mark.parametrize("arch", ARCHS)
def test_laned_prefill_and_decode_match_the_reference(arch):
    lanes, batch = _setup(arch)
    lanes.serve(batch)


@pytest.mark.parametrize("arch", ARCHS)
def test_laned_forward_matches_the_reference(arch):
    lanes, batch = _setup(arch)
    (logits, _), (ref_logits, _) = lanes.forward(batch)
    close(logits, ref_logits, f"{arch} forward logits")


@pytest.mark.parametrize("arch", ARCHS)
def test_swapped_lane_weights_miss_the_tolerance(arch):
    lanes, batch = _setup(arch)
    err = lanes.prefill_error(batch, swapped(lanes.stacked))
    assert err > 1e-3, f"{arch}: swapped lanes within {err:.3e}"


def test_hymba_meta_tokens_broadcast_from_lane_0_miss():
    lanes, batch = _setup(HYMBA)
    one = dict(lanes.stacked)
    meta = lanes.stacked["meta_tokens"]
    assert meta.shape[:2] == (len(IDS), lanes.api.cfg.n_meta_tokens)
    one["meta_tokens"] = meta[:1].expand_as(meta)
    err = lanes.prefill_error(batch, one)
    assert err > 1e-3, f"meta tokens of lane 0 within {err:.3e}"


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_main_with_clients_serves_the_blocks(arch, capsys):
    serve_main_with_clients(arch, capsys)
