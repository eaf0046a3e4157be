"""Step functions of the launchers — the port of ``repro.launch.steps``.
This slice ports the serving step; the pods-as-clients round step and the
personalized serving step wait for ROADMAP queue 1 items 12 and 9."""
from __future__ import annotations

from typing import Callable

from repro_torch.models.registry import ModelApi

__all__ = ["make_serve_step"]


def make_serve_step(api: ModelApi) -> Callable:
    """(params, cache, tokens (B,), pos) -> (logits, cache); the cache is
    updated in place."""

    def serve_step(params, cache, tokens, pos):
        return api.decode_step(params, cache, tokens, pos)

    return serve_step
