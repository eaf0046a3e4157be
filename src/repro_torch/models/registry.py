"""Uniform model API — the port of ``repro.models.registry``: block kind ->
(param_defs, cache_defs, forward, loss, decode_step, prefill), for the
``transformer``, ``xlstm`` and ``hymba`` kinds."""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import hymba, transformer, xlstm
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


_MODULES = {"transformer": transformer, "xlstm": xlstm, "hymba": hymba}


def get_model_api(cfg: ArchConfig) -> ModelApi:
    if cfg.block_kind not in _MODULES:
        raise ValueError(f"unknown block kind {cfg.block_kind!r}; known: "
                         f"{', '.join(_MODULES)}")
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
