"""Personalized lanes of the vlm and masked_lm tasks against the JAX
reference on the CPU, f32 (``tests/_torch_lanes.py`` states the setup and
the tolerances):

- llava-next-mistral-7b at ``reduced`` size (16 image embeddings before 24
  tokens): the port's lane-stacked ``prefill`` / ``decode_step`` against
  the reference's ``make_personalized_serve_step`` on a cache sized to the
  image prefix + prompt + new tokens (the reference's serve launcher sizes
  it without the prefix, ROADMAP §3; its step functions take any size),
  each lane's projector its own; the laned ``forward`` against ``jax.vmap``
  of the reference's; ``serve.main --clients``.
- hubert-xlarge at ``reduced`` size widened to hd 80 (as
  ``tests/test_torch_masked_lm.py``): the laned ``forward`` (an encoder
  has no decode in either package) against ``jax.vmap`` of the reference's
  ``forward``, each lane's ``in_proj`` and ``mask_emb`` its own.

Mutants must miss: the port's lanes 0 and 1 swapped; hubert's
``mask_emb`` taken from lane 0 for every lane.
"""
import dataclasses

import numpy as np
import pytest
from _torch_blocks import one_thread  # noqa: F401  (an autouse fixture)
from _torch_lanes import (
    IDS,
    Lanes,
    close,
    rel_err,
    serve_main_with_clients,
    swapped,
)

from repro.configs import base as ref_base
from repro.configs import registry as ref_registry
from repro_torch.configs import base, registry

VLM, ENCODER = "llava-next-mistral-7b", "hubert-xlarge"
SEQ = 40  # positions: 16 image embeddings (the reduced cap) + 24 tokens

_CACHE: dict = {}


def _setup(arch):
    if arch not in _CACHE:
        if arch == ENCODER:
            ref_cfg = dataclasses.replace(
                ref_base.reduced(ref_registry.get_config(arch)), d_model=320)
            cfg = dataclasses.replace(
                base.reduced(registry.get_config(arch)), d_model=320)
        else:
            ref_cfg = ref_registry.get_config(arch, smoke=True)
            cfg = registry.get_config(arch, smoke=True)
        batch = {k: np.asarray(v) for k, v in ref_registry.make_batch(
            ref_cfg, len(IDS), SEQ, seed=1).items()}
        _CACHE[arch] = Lanes(ref_cfg, cfg), batch
    return _CACHE[arch]


def test_vlm_laned_prefill_and_decode_match_the_reference():
    lanes, batch = _setup(VLM)
    assert batch["image_feats"].shape[:2] == (len(IDS), 16)
    lanes.serve(batch)


@pytest.mark.parametrize("arch", (VLM, ENCODER))
def test_laned_forward_matches_the_reference(arch):
    lanes, batch = _setup(arch)
    (logits, _), (ref_logits, _) = lanes.forward(batch)
    close(logits, ref_logits, f"{arch} forward logits")


@pytest.mark.parametrize("arch", (VLM, ENCODER))
def test_swapped_lane_weights_miss_the_tolerance(arch):
    lanes, batch = _setup(arch)
    if arch == VLM:
        err = lanes.prefill_error(batch, swapped(lanes.stacked))
    else:
        (logits, _), (ref_logits, _) = lanes.forward(
            batch, swapped(lanes.stacked))
        err = rel_err(logits, ref_logits)
    assert err > 1e-3, f"{arch}: swapped lanes within {err:.3e}"


def test_the_encoder_mask_emb_broadcast_from_lane_0_misses():
    """``mask_emb`` is a ``(B, d)`` lane vector broadcast over each lane's
    frames; one lane's vector for all of them must miss."""
    lanes, batch = _setup(ENCODER)
    assert batch["mask"].any(1).all()
    one = dict(lanes.stacked)
    one["mask_emb"] = lanes.stacked["mask_emb"][:1].expand(len(IDS), -1)
    (logits, _), (ref_logits, _) = lanes.forward(batch, one)
    err = rel_err(logits, ref_logits)
    assert err > 1e-3, f"mask_emb of lane 0 within {err:.3e}"


def test_serve_main_with_clients_serves_the_vlm(capsys):
    serve_main_with_clients(VLM, capsys)


def test_serve_main_still_refuses_the_encoder_with_clients():
    """Neither package decodes an encoder: ``--clients`` does not change
    that."""
    with pytest.raises(SystemExit, match="encoder-only"):
        serve_main_with_clients(ENCODER, None)
