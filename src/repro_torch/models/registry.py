"""Uniform model API — the port of ``repro.models.registry`` for the
``transformer`` block kind (xlstm and hymba wait for ROADMAP queue 1
item 13.4)."""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import transformer
from repro_torch.models.pdefs import init_tree, tree_num_params

__all__ = ["ModelApi", "get_model_api"]


class ModelApi(NamedTuple):
    cfg: ArchConfig
    param_defs: Callable
    cache_defs: Callable
    forward: Callable
    loss: Callable
    decode_step: Callable
    prefill: Callable

    def init(self, gen: torch.Generator, device=None) -> dict:
        """Parameters drawn from ``gen`` on ``device`` (default: gen's)."""
        return init_tree(gen, self.param_defs(self.cfg), device)

    def num_params(self) -> int:
        return tree_num_params(self.param_defs(self.cfg))


_MODULES = {"transformer": transformer}


def get_model_api(cfg: ArchConfig) -> ModelApi:
    if cfg.block_kind not in _MODULES:
        raise NotImplementedError(
            f"block kind {cfg.block_kind!r} is not ported yet (ROADMAP queue 1 "
            "item 13.4)")
    mod = _MODULES[cfg.block_kind]

    def forward(params, batch):
        return mod.forward(params, batch, cfg)

    def loss(params, batch):
        return mod.loss(params, batch, cfg)

    def decode_step(params, cache, tokens, pos):
        return mod.decode_step(params, cache, tokens, pos, cfg)

    def prefill(params, batch, cache_len: int):
        return mod.prefill(params, batch, cfg, cache_len)

    return ModelApi(
        cfg=cfg,
        param_defs=lambda c=cfg: mod.param_defs(c),
        cache_defs=lambda batch, length, c=cfg: mod.cache_defs(c, batch, length),
        forward=forward,
        loss=loss,
        decode_step=decode_step,
        prefill=prefill,
    )
