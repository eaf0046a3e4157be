"""Plain PyTorch oracles for the port's kernels — the counterpart of
``repro.kernels.ref`` (ground truth, not the hot path).

``fused_update_bank_ref`` divides by ``w`` exactly as the reference oracle
does; the kernels multiply by a precomputed ``1 / w`` (their plain
versions beside each wrapper follow the kernel).  Dense mixes accumulate in
float32; callers on CUDA keep TF32 off, as the reference mixes at
``Precision.HIGHEST``.
"""
from __future__ import annotations

import torch

__all__ = ["gossip_matmul_ref", "gossip_gather_ref", "fused_update_ref",
           "fused_update_bank_ref", "flash_attention_ref"]


def gossip_matmul_ref(P: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    return (P.float() @ X.float()).to(X.dtype)


def gossip_gather_ref(idx: torch.Tensor, wgt: torch.Tensor,
                      X: torch.Tensor) -> torch.Tensor:
    """Y[i] = sum_l wgt[i,l] * X[idx[i,l]] via one (n, k_max, D) gather."""
    gathered = X[idx.long()].float()
    return torch.einsum("nk,nkd->nd", wgt.float(), gathered).to(X.dtype)


def fused_update_ref(x, v, g, alpha, eta, w):
    v_new = float(alpha) * v.float() + g.float()
    x_new = x.float() - float(eta) * v_new
    z_new = x_new / torch.as_tensor(w, dtype=torch.float32)
    return x_new.to(x.dtype), v_new, z_new.to(x.dtype)


def fused_update_bank_ref(X, V, G, alpha, eta, w):
    """Row-banked fused update: (n, D) banks, per-client weight w (n,)."""
    v_new = float(alpha) * V.float() + G.float()
    x_new = X.float() - float(eta) * v_new
    z_new = x_new / w.float()[:, None]
    return x_new.to(X.dtype), v_new, z_new.to(X.dtype)


def flash_attention_ref(q, k, v, causal: bool = True, window: int = 0):
    """q: (B,H,S,hd), k/v: (B,KV,S,hd) -> (B,H,S,hd).  GQA by repeating
    the kv heads, f32 scores scaled by hd^-0.5 after the product, masked
    scores set to -1e30, softmax, P.V in f32, cast to q's dtype."""
    b, h, s, hd = q.shape
    g = h // k.shape[1]
    k = k.repeat_interleave(g, dim=1)
    v = v.repeat_interleave(g, dim=1)
    scores = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * hd ** -0.5
    qi = torch.arange(s, device=q.device)[:, None]
    ki = torch.arange(s, device=q.device)[None, :]
    ok = torch.ones(s, s, dtype=torch.bool, device=q.device)
    if causal:
        ok = ki <= qi
    if window > 0:
        ok = ok & (qi - ki < window)
    probs = scores.masked_fill(~ok, -1e30).softmax(-1)
    return torch.einsum("bhqk,bhkd->bhqd", probs, v.float()).to(q.dtype)
