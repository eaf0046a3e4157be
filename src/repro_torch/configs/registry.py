"""Architecture registry: ``--arch <id>`` resolution, ``input_specs`` and
random batches — the port of ``repro.configs.registry``.

The port holds every id of the zoo: the four dense GQA SwiGLU decoders
and the two MoE decoders (dbrx-132b with GQA, deepseek-v3-671b with MLA)
of the ``lm`` task, the recurrent xlstm-350m and the hybrid hymba-1.5b
(their own block kinds, also ``lm``), llava-next-mistral-7b (the ``vlm``
task: an image prefix before the text) and hubert-xlarge (the
``masked_lm`` task: an encoder over audio frames).
"""
from __future__ import annotations

import importlib

import numpy as np
import torch

from repro_torch.configs.base import INPUT_SHAPES, ArchConfig, InputShape, reduced

__all__ = ["ARCH_IDS", "PORTED_ARCH_IDS", "get_config", "input_specs",
           "make_batch",
           "make_round_batches", "step_positions", "INPUT_SHAPES",
           "InputShape"]

_MODULES = {
    "gemma3-12b": "gemma3_12b",
    "phi3-medium-14b": "phi3_medium_14b",
    "glm4-9b": "glm4_9b",
    "codeqwen1.5-7b": "codeqwen15_7b",
    "dbrx-132b": "dbrx_132b",
    "deepseek-v3-671b": "deepseek_v3_671b",
    "llava-next-mistral-7b": "llava_next_mistral_7b",
    "hubert-xlarge": "hubert_xlarge",
    "xlstm-350m": "xlstm_350m",
    "hymba-1.5b": "hymba_1_5b",
}

ARCH_IDS = ("hubert-xlarge", "gemma3-12b", "phi3-medium-14b",
            "deepseek-v3-671b", "glm4-9b", "dbrx-132b",
            "llava-next-mistral-7b", "codeqwen1.5-7b", "xlstm-350m",
            "hymba-1.5b")
PORTED_ARCH_IDS = ARCH_IDS  # the port holds the whole zoo


def get_config(arch: str, smoke: bool = False) -> ArchConfig:
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}")
    cfg = mod.CONFIG
    return reduced(cfg) if smoke else cfg


def _batch_shapes(cfg: ArchConfig, batch: int, seq: int) -> dict:
    """Input name -> (shape, dtype) of a full-sequence (train or prefill)
    batch of ``seq`` positions, in the reference's key order (the order of
    the draws)."""
    if cfg.task == "masked_lm":
        return {
            "features": ((batch, seq, cfg.frontend_dim), torch.float32),
            "mask": ((batch, seq), torch.bool),
            "targets": ((batch, seq), torch.int32),
        }
    if cfg.task == "vlm":
        n_img = min(cfg.n_frontend_tokens, max(seq // 2, 1))
        return {
            "tokens": ((batch, seq - n_img), torch.int32),
            "image_feats": ((batch, n_img, cfg.frontend_dim), torch.float32),
        }
    return {"tokens": ((batch, seq), torch.int32)}


def input_specs(cfg: ArchConfig, shape: InputShape | str,
                device="meta") -> dict:
    """Empty tensors (on ``meta`` by default: no memory) of every model input
    of one input shape, with the reference's names, shapes and dtypes.  For
    a decode shape this is the per-step request batch {tokens (B,), pos
    ()}; the KV cache comes from the model's ``cache_defs``."""
    if isinstance(shape, str):
        shape = INPUT_SHAPES[shape]
    if shape.kind == "decode":
        specs = {"tokens": ((shape.global_batch,), torch.int32),
                 "pos": ((), torch.int32)}
    else:
        specs = _batch_shapes(cfg, shape.global_batch, shape.seq_len)
    return {k: torch.empty(sh, dtype=dt, device=device)
            for k, (sh, dt) in specs.items()}


def make_batch(cfg: ArchConfig, batch: int, seq: int, seed: int = 0,
               device="cpu") -> dict:
    """A random batch of ``seq`` positions for ``cfg``'s task, drawn with
    numpy from ``seed`` exactly as the reference's ``make_batch`` draws it:
    ``lm`` ``{"tokens"}``; ``vlm`` ``{"tokens", "image_feats"}`` (the image
    prefix takes ``min(n_frontend_tokens, max(seq // 2, 1))`` positions);
    ``masked_lm`` ``{"features", "mask", "targets"}`` (a frame is masked
    with probability 0.3)."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, (shape, dt) in _batch_shapes(cfg, batch, seq).items():
        if dt == torch.int32:
            hi = cfg.vocab_size if name in ("tokens", "targets") else 2
            a = rng.integers(0, hi, size=shape)
        elif dt == torch.bool:
            a = rng.random(shape) < 0.3
        else:
            a = rng.standard_normal(shape)
        out[name] = torch.as_tensor(a, device=device).to(dt)
    return out


def make_round_batches(cfg: ArchConfig, rounds: int, pods: int,
                       local_steps: int, batch: int, seq: int, seed: int = 0,
                       device="cpu") -> dict:
    """The batches of ``rounds`` pods-as-clients rounds of ``cfg``'s task:
    one :func:`make_batch` draw of ``rounds x pods x local_steps x batch``
    rows of ``seq`` positions, each array cut to (rounds, pods,
    local_steps, batch, ...).  A round's slice is the batch
    ``launch.steps.make_round_step`` takes."""
    flat = make_batch(cfg, rounds * pods * local_steps * batch, seq,
                      seed=seed, device=device)
    return {k: v.reshape(rounds, pods, local_steps, batch, *v.shape[1:])
            for k, v in flat.items()}


def step_positions(batches: dict) -> int:
    """The fewest positions one local step's accuracy averages over, for
    batches of shape (rounds, pods, K, B, ...): the masked frames of a
    masked_lm step, else the text positions but the first (B (S - 1))."""
    if "mask" in batches:
        m = batches["mask"]
        return int(m.flatten(0, 2).sum(dim=(1, 2)).min())
    t = batches["tokens"]
    return t.shape[3] * (t.shape[4] - 1)
