"""Architecture registry: ``--arch <id>`` resolution and random batches —
the port of ``repro.configs.registry``.

The port holds the four dense GQA SwiGLU decoders and the two MoE
decoders (dbrx-132b with GQA, deepseek-v3-671b with MLA), all of the
``lm`` task.  The other ids of the zoo are known, and ``get_config`` says
which open item ports them.
"""
from __future__ import annotations

import importlib

import numpy as np
import torch

from repro_torch.configs.base import INPUT_SHAPES, ArchConfig, InputShape, reduced

__all__ = ["ARCH_IDS", "PORTED_ARCH_IDS", "get_config", "make_batch",
           "INPUT_SHAPES", "InputShape"]

_MODULES = {
    "gemma3-12b": "gemma3_12b",
    "phi3-medium-14b": "phi3_medium_14b",
    "glm4-9b": "glm4_9b",
    "codeqwen1.5-7b": "codeqwen15_7b",
    "dbrx-132b": "dbrx_132b",
    "deepseek-v3-671b": "deepseek_v3_671b",
}

# The zoo ids the port does not hold yet, with the open item (ROADMAP
# queue 1) that ports each.
_WAITING = {
    "hubert-xlarge": "item 13.3 (the masked_lm task)",
    "llava-next-mistral-7b": "item 13.3 (the vlm task)",
    "xlstm-350m": "item 13.4 (the xlstm block)",
    "hymba-1.5b": "item 13.4 (the hymba block)",
}

ARCH_IDS = ("hubert-xlarge", "gemma3-12b", "phi3-medium-14b",
            "deepseek-v3-671b", "glm4-9b", "dbrx-132b",
            "llava-next-mistral-7b", "codeqwen1.5-7b", "xlstm-350m",
            "hymba-1.5b")
PORTED_ARCH_IDS = tuple(a for a in ARCH_IDS if a in _MODULES)


def get_config(arch: str, smoke: bool = False) -> ArchConfig:
    if arch in _WAITING:
        raise NotImplementedError(
            f"{arch} is not ported to repro_torch yet: ROADMAP queue 1 "
            f"{_WAITING[arch]}; ported: {', '.join(PORTED_ARCH_IDS)}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}")
    cfg = mod.CONFIG
    return reduced(cfg) if smoke else cfg


def make_batch(cfg: ArchConfig, batch: int, seq: int, seed: int = 0,
               device="cpu") -> dict:
    """A random ``lm`` batch ``{"tokens": (batch, seq) int32}``, drawn with
    numpy from ``seed`` exactly as the reference's ``make_batch`` draws it."""
    if cfg.task != "lm":
        raise NotImplementedError(
            f"task {cfg.task!r} is not ported yet (ROADMAP queue 1 item 13.3)")
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, size=(batch, seq))
    return {"tokens": torch.as_tensor(tokens, dtype=torch.int32,
                                      device=device)}
