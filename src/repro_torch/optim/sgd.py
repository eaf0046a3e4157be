"""Minimal optimizer utilities shared by the FL engine and the pod runtime —
the port of ``repro.optim.sgd``.

The paper's local optimizer is SGD(+momentum) wrapped by SAM; these helpers
keep the schedule/update math in one place.  Schedules take the step as a
number or tensor and return an f32 tensor, as the reference's return f32
arrays.
"""
from __future__ import annotations

import math

import torch

from repro_torch.core.flat import tree_flatten, tree_unflatten

__all__ = ["exponential_decay", "warmup_cosine", "sgd_momentum_step"]


def _f32(step) -> torch.Tensor:
    return torch.as_tensor(step, dtype=torch.float32)


def exponential_decay(base_lr: float, decay: float = 0.998):
    """Per-round decay used by all paper experiments (0.998 ** round)."""

    def schedule(step):
        return base_lr * decay ** _f32(step)

    return schedule


def warmup_cosine(base_lr: float, warmup: int, total: int, floor: float = 0.1):
    def schedule(step):
        step = _f32(step)
        warm = base_lr * step / max(warmup, 1)
        frac = torch.clip((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = base_lr * (floor + (1 - floor) * 0.5
                         * (1 + torch.cos(math.pi * frac)))
        return torch.where(step < warmup, warm, cos)

    return schedule


def sgd_momentum_step(params, v, grads, lr, alpha: float = 0.0):
    """v' = alpha v + g ; x' = x - lr v'  (dict-wide, dtype-preserving)."""

    def upd(p, vi, g):
        v_new = alpha * vi.float() + g.float()
        p_new = p.float() - lr * v_new
        return p_new.to(p.dtype), v_new.to(vi.dtype)

    paths, flat_p = tree_flatten(params)
    _, flat_v = tree_flatten(v)
    _, flat_g = tree_flatten(grads)
    out = [upd(p, vi, g) for p, vi, g in zip(flat_p, flat_v, flat_g)]
    return (tree_unflatten(paths, [o[0] for o in out]),
            tree_unflatten(paths, [o[1] for o in out]))
