"""The dense SwiGLU MLP of the zoo's decoders — the part of
``repro.models.moe`` that the dense GQA decoders use.  The mixture of
experts waits for ROADMAP queue 1 item 13."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.models.layers import shard_act
from repro_torch.models.pdefs import PDef

__all__ = ["swiglu_defs", "swiglu_forward"]


def swiglu_defs(cfg: ArchConfig, stacked: tuple = (), d_ff: int = 0) -> dict:
    d, f = cfg.d_model, d_ff or cfg.d_ff
    L, Lax = (stacked, ("layers",) * len(stacked)) if stacked else ((), ())
    dt = cfg.dtype
    defs = {
        "wi": PDef(L + (d, f), Lax + ("embed", "mlp"), dt, fan_in=d),
        "wo": PDef(L + (f, d), Lax + ("mlp", "embed"), dt, fan_in=f),
    }
    if cfg.mlp_act == "swiglu":
        defs["wg"] = PDef(L + (d, f), Lax + ("embed", "mlp"), dt, fan_in=d)
    return defs


def swiglu_forward(p, x):
    """``(act(x wi) * (x wg)) wo`` with act = silu (gelu without ``wg``)."""
    if "wg" in p:
        h = F.silu(x @ p["wi"]) * (x @ p["wg"])
    else:
        h = F.gelu(x @ p["wi"], approximate="tanh")
    h = shard_act(h, ("batch", "seq", "mlp"))
    return h @ p["wo"]
