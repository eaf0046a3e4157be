"""Step functions of the launchers — the port of ``repro.launch.steps``:
the serving step and the personalized serving step.  The pods-as-clients
round and train steps wait for ROADMAP queue 1 item 13.5."""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from repro_torch.core.flat import BoundDeltaSpec, tree_map
from repro_torch.models.registry import ModelApi

__all__ = ["make_serve_step", "PersonalizedServe",
           "make_personalized_serve_step"]


def make_serve_step(api: ModelApi) -> Callable:
    """(params, cache, tokens (B,), pos) -> (logits, cache); the cache is
    updated in place."""

    def serve_step(params, cache, tokens, pos):
        return api.decode_step(params, cache, tokens, pos)

    return serve_step


class PersonalizedServe(NamedTuple):
    """Batched many-model serving over the client bank (see
    :func:`make_personalized_serve_step`)."""

    expand: Callable       # (bank, w, ids) -> lane-stacked params
    prefill: Callable      # (params_stacked, batch, cache_len) -> (logits, cache)
    decode_step: Callable  # (params_stacked, cache, tokens (B,), pos) -> ...


def make_personalized_serve_step(api: ModelApi, spec) -> PersonalizedServe:
    """Serve many *different* clients' models in one batched decode.

    The bank is a personalization store: request lane ``b`` serves client
    ``ids[b]``, whose model is its bank row de-biased onto the shared
    weights.  ``spec`` is the program's bank spec — a
    :class:`~repro_torch.core.flat.BoundDeltaSpec` expands ``base + (A @
    B) / w`` per leaf over its frozen base, and only the narrow ``(B,
    d_delta)`` rows are gathered per batch; a dense
    :class:`~repro_torch.core.flat.BankSpec` expands ``row / w``.

    ``expand`` runs once per batch and returns the lanes' weights stacked on
    a leading lane axis.  ``prefill`` and ``decode_step`` run the model
    zoo's prefill and decode on those stacked weights with one request per
    lane: one pass over the layers per token serves every lane, the
    projections and the MLP as batched matmuls over the lanes and the
    attention core as the flash kernel's batch.
    """

    def expand(bank, w, ids):
        ids = torch.as_tensor(ids, device=bank.device).long()
        rows = bank[ids]
        wv = (torch.ones(ids.shape, dtype=torch.float32, device=bank.device)
              if w is None else w[ids].float())
        if isinstance(spec, BoundDeltaSpec):
            return spec.debias_stacked(rows, wv)
        stacked = spec.unravel_stacked(rows)
        return tree_map(
            lambda p: p / wv.reshape((-1,) + (1,) * (p.dim() - 1)), stacked)

    def prefill(params_stacked, batch, cache_len):
        return api.prefill(params_stacked, batch, cache_len)

    def decode_step(params_stacked, cache, tokens, pos):
        return api.decode_step(params_stacked, cache, tokens, pos)

    return PersonalizedServe(expand, prefill, decode_step)
