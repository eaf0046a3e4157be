"""Shared model layers: norms, rotary and sinusoidal positions, loss — the
port of ``repro.models.layers``.  ``shard_act`` is the activation
constraint of the pod runtime (``launch.sharding.constrain``): the identity
without an active mesh."""
from __future__ import annotations

import torch

from repro_torch.launch import sharding as shlib

__all__ = ["rms_norm", "lane_scale", "rope", "apply_rope",
           "sinusoidal_positions", "softmax_xent", "shard_act"]


def shard_act(x, logical: tuple):
    """Activation sharding constraint hook: ``launch.sharding.constrain``
    (the identity without an active mesh)."""
    return shlib.constrain(x, logical)


def rms_norm(x, scale, eps: float = 1e-6):
    """``x * rsqrt(mean(x^2) + eps) * (1 + scale)`` over the last dim, in
    f32, cast back to x's dtype."""
    dt = x.dtype
    x = x.float()
    var = x.square().mean(-1, keepdim=True)
    return (x * torch.rsqrt(var + eps) * (1.0 + scale.float())).to(dt)


def lane_scale(scale, x):
    """A norm scale with a leading lane axis, ``(B, dim)`` for a ``(B, ...,
    dim)`` activation whose batch rows are the lanes, reshaped to broadcast
    over x's middle axes; a ``(dim,)`` scale is returned as it is."""
    if scale.dim() == 1:
        return scale
    return scale.reshape(scale.shape[:1] + (1,) * (x.dim() - 2)
                         + scale.shape[1:])


def rope(positions, dim: int, theta) -> tuple:
    """(sin, cos) of shape positions.shape + (dim // 2,), in f32."""
    half = dim // 2
    ar = torch.arange(half, dtype=torch.float32, device=positions.device)
    log_theta = torch.log(torch.tensor(theta, dtype=torch.float32))
    freqs = torch.exp(-log_theta * ar / half)
    angles = positions.float()[..., None] * freqs
    return torch.sin(angles), torch.cos(angles)


def apply_rope(x, sin, cos):
    """Half-split rotation.  x: (..., seq, heads, head_dim); sin/cos:
    (..., seq, head_dim // 2).  Computed in f32, cast to x's dtype."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    s = sin[..., None, :].float()
    c = cos[..., None, :].float()
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(x.dtype)


def sinusoidal_positions(positions, dim: int):
    """Fixed sinusoidal embeddings ``positions.shape + (dim,)`` in f32: the
    sines of ``positions * 10000^(-i / half)`` for i < half = dim // 2, then
    their cosines."""
    half = dim // 2
    ar = torch.arange(half, dtype=torch.float32, device=positions.device)
    freqs = torch.exp(-torch.log(torch.tensor(10_000.0)) * ar / half)
    ang = positions.float()[..., None] * freqs
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def softmax_xent(logits, labels, mask=None):
    """Mean CE over (optionally masked) positions; returns (loss, acc)."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    if shlib.is_dtensor(logp):
        # Each rank gathers from its own rows (gather's backward on the
        # DTensor makes its zeros at the whole batch's shape on every rank).
        lab = labels.to_local() if shlib.is_dtensor(labels) else labels
        ll = shlib.from_local(shlib.local_part(logp, logp, own_model=False)
                              .gather(-1, lab[..., None].long())[..., 0], logp)
    else:
        ll = logp.gather(-1, labels[..., None].long())[..., 0]
    correct = (logits.argmax(-1) == labels).float()
    if mask is None:
        return -ll.mean(), correct.mean()
    mask = mask.float()
    denom = mask.sum().clamp_min(1.0)
    return -(ll * mask).sum() / denom, (correct * mask).sum() / denom
