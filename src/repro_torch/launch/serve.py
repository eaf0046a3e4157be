"""Serving launcher: batched prefill, then greedy decode — the port of
``repro.launch.serve`` for the decoders: the dense GQA decoders and the
MoE family (dbrx-132b with GQA, deepseek-v3-671b with MLA; their expert
routing and capacity drops are ``models.moe``'s) of the ``lm`` task,
llava-next-mistral-7b of the ``vlm`` task, xlstm-350m and hymba-1.5b.  An
encoder (hubert-xlarge) has no decode path and is refused.
:func:`generate` serves any ``ModelApi``, so a caller may cut a config's
depth first (``dataclasses.replace(cfg, n_layers=...)``), as a model too
deep for one card needs.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma3-12b \\
      --no-smoke --batch 4 --prompt-len 2048 --new-tokens 16

Runs on the card (``--device cuda``, the default) unless asked for the CPU
(``--device cpu``, where every kernel takes its plain PyTorch version).
Parameters are drawn on the device from a ``torch.Generator`` seeded with
``--seed``; prompts come from numpy with ``--seed + 1``.  A vlm request
also carries 8 image embeddings, as in the reference, drawn with numpy from
``--seed + 2`` (standard normals, f32).  The first new token comes from the
prefill logits, the other ``--new-tokens - 1`` from decode steps, and the
cache holds the image prefix, ``--prompt-len`` and ``--new-tokens``
positions.  (The reference sizes its cache without the prefix but decodes
after it, so its vlm decode writes past the cache; ``dynamic_update_slice``
clamps every step onto the last slot.  ROADMAP §3.)

With ``--clients N`` the batch becomes a *personalized* decode: a low-rank
delta bank (frozen shared base = the drawn weights, rank ``--rank``
adapters) holds one row per client, and request lane b serves client b's
expanded model in the same pass over the layers, for every decoding zoo
id (a vlm lane's cache holds its image prefix, as above).  The bank's rows
are ``0.02`` times standard normals drawn from ``--seed + 3``
(:func:`client_bank`); the first ``--zero-clients`` rows are zero, so
those lanes serve the base model.  On the CPU, at smoke size:

  PYTHONPATH=src python -m repro_torch.launch.serve --arch dbrx-132b \
      --clients 2 --rank 2 --device cpu
"""
from __future__ import annotations

import argparse
import contextlib
import time

import numpy as np
import torch

from repro_torch.configs.registry import get_config
from repro_torch.launch import sharding as shlib
from repro_torch.launch.steps import (
    make_personalized_serve_step,
    make_serve_step,
)
from repro_torch.models.registry import ModelApi, get_model_api

__all__ = ["build_parser", "client_bank", "generate", "main", "prompts",
           "N_IMAGE"]

# Image embeddings per vlm request (the reference's serve launcher's).
N_IMAGE = 8


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="codeqwen1.5-7b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=12)
    ap.add_argument("--new-tokens", type=int, default=8)
    ap.add_argument("--smoke", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="shrink the arch config (--no-smoke for full size)")
    ap.add_argument("--clients", type=int, default=0,
                    help="serve this many per-client delta-bank models "
                         "(0 = plain shared-weights decode)")
    ap.add_argument("--rank", type=int, default=8,
                    help="adapter rank for the --clients delta bank")
    ap.add_argument("--zero-clients", type=int, default=0,
                    help="the first this many --clients rows are zero "
                         "deltas (they serve the base model)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (their plain versions)")
    return ap


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _finite(t: torch.Tensor) -> torch.Tensor:
    """Whether every element is finite, as a device bool, without a
    full-size temporary: NaN propagates through min and max.  Of a DTensor,
    the rank's own block."""
    lo, hi = torch.aminmax(t.to_local() if shlib.is_dtensor(t) else t)
    return torch.isfinite(lo) & torch.isfinite(hi)


@torch.no_grad()
def generate(api: ModelApi, params: dict, batch: dict, new_tokens: int) -> dict:
    """Prefill ``batch``, then greedy-decode; prints the reference's lines.
    A vlm batch's ``image_feats`` (B, n_img, Fd) come before its tokens:
    the cache holds n_img + S + new_tokens positions and step i decodes at
    n_img + S + i.

    Returns ``tokens`` (B, new_tokens) on the CPU, ``logits`` (B,
    new_tokens, V) on the device (the last-position logits each token was
    picked from), ``prefill_s`` and ``decode_s`` (host clock, synchronized
    with the device), ``steps``, ``n_prefix`` (n_img, 0 without image
    features), ``finite`` (every prefill and decode logit finite) and
    ``cache``, the cache after the last step.

    On a placed replica (the pod runtime's: params by
    ``launch.sharding.place_params``, the batch by ``launch.steps.
    place_batch``, under ``sharding.use_mesh``) the prefill builds the cache
    in its placement (``sharding.cache_spec``) and each step reads and
    writes the rank's blocks of it; each token's logits are gathered over
    the vocabulary before the argmax, and the tokens and logits returned
    are the pod's whole rows (``finite`` covers the rank's blocks)."""
    tokens = batch["tokens"]
    n_prefix = batch["image_feats"].shape[1] if "image_feats" in batch else 0
    cache_len = n_prefix + tokens.shape[1] + new_tokens
    serve_step = make_serve_step(api)
    placed = shlib.is_dtensor(tokens)
    on_mesh = contextlib.nullcontext()
    if placed:  # plain tensors (positions, masks) meet DTensors
        from torch.distributed.tensor.experimental import implicit_replication

        on_mesh = implicit_replication()
    with on_mesh:
        rec = _generate(api, params, batch, new_tokens, serve_step,
                        cache_len, n_prefix)
    if placed:
        rec["tokens"] = shlib.full_tensor(rec["tokens"])
        rec["logits"] = shlib.full_tensor(rec["logits"])
    rec["tokens"] = rec["tokens"].cpu()
    print(rec["tokens"])
    return rec


def _generate(api, params, batch, new_tokens, serve_step, cache_len,
              n_prefix) -> dict:
    """:func:`generate`'s prefill and decode loop."""
    tokens = batch["tokens"]
    device = tokens.device
    b, s = tokens.shape
    _sync(device)
    t0 = time.perf_counter()
    logits, cache = api.prefill(params, batch, cache_len)
    # A clone, or a gather over the vocabulary: a view would keep all of
    # the prefill's logits alive.
    last = [shlib.gather_model(logits[:, -1]) if shlib.is_dtensor(logits)
            else logits[:, -1].clone()]
    toks = last[0].argmax(-1).to(torch.int32)
    finite = _finite(logits)
    del logits
    _sync(device)
    prefill_s = time.perf_counter() - t0
    print(f"[serve] prefill {b}x{s}"
          + (f" after {n_prefix} image embeddings" if n_prefix else "")
          + f": {prefill_s:.2f}s")

    out = [toks]
    steps = new_tokens - 1
    t0 = time.perf_counter()
    for i in range(steps):
        logits_i, cache = serve_step(params, cache, toks, n_prefix + s + i)
        logits_i = shlib.gather_model(logits_i)
        toks = logits_i.argmax(-1).to(torch.int32)
        finite = finite & _finite(logits_i)
        last.append(logits_i)
        out.append(toks)
    _sync(device)
    decode_s = time.perf_counter() - t0
    print(f"[serve] {steps} steps: {1e3 * decode_s / max(steps, 1):.1f} ms/step")
    return {"tokens": torch.stack(out, dim=1),
            "logits": torch.stack(last, dim=1), "prefill_s": prefill_s,
            "decode_s": decode_s, "steps": steps, "n_prefix": n_prefix,
            "finite": bool(finite), "cache": cache}


def main(argv=None) -> dict:
    """Build the model, its parameters and the prompts, then
    :func:`generate`; returns its record (without the cache) together with
    the ``api``, ``params`` and ``batch`` it served."""
    args = build_parser().parse_args(argv)
    device = torch.device(args.device)
    cfg = get_config(args.arch, smoke=args.smoke)
    if not cfg.supports_decode():
        raise SystemExit(f"{cfg.name} is encoder-only: no decode path")
    api = get_model_api(cfg)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    with torch.no_grad():
        params = api.init(gen, device)
    if args.clients:
        return _serve_personalized(args, cfg, api, params, device)
    batch = prompts(cfg, args.batch, args.prompt_len, args.seed, device)
    rec = generate(api, params, batch, args.new_tokens)
    del rec["cache"]
    return {**rec, "api": api, "params": params, "batch": batch}


def prompts(cfg, batch: int, prompt_len: int, seed: int, device) -> dict:
    """The requests :func:`main` serves: ``batch`` prompts of ``prompt_len``
    tokens drawn with numpy from ``seed + 1`` (``make_batch``'s ``lm``
    draw), and for a vlm ``N_IMAGE`` image embeddings per request, standard
    normals in f32 from ``seed + 2``."""
    rng = np.random.default_rng(seed + 1)
    out = {"tokens": torch.as_tensor(
        rng.integers(0, cfg.vocab_size, size=(batch, prompt_len)),
        device=device).to(torch.int32)}
    if cfg.task == "vlm":
        feats = np.random.default_rng(seed + 2).standard_normal(
            (batch, N_IMAGE, cfg.frontend_dim))
        out["image_feats"] = torch.as_tensor(feats, device=device).float()
    return out


@torch.no_grad()
def client_bank(params: dict, n: int, rank: int, zero_clients: int = 0,
                seed: int = 0) -> tuple:
    """``--clients``' delta bank over ``params`` (the frozen base) -> (the
    bound spec, ``bank`` (n, d_delta), ``w`` (n,) of ones): a synthetic
    trained bank, each client a distinct small perturbation, ``0.02``
    times standard normals drawn on the base's device from ``seed + 3``,
    the first ``zero_clients`` rows zero."""
    from repro_torch.core.flat import (
        bind_delta_spec,
        make_delta_spec,
        tree_flatten,
    )

    device = tree_flatten(params)[1][0].device
    dspec = make_delta_spec(params, rank=rank)
    spec = bind_delta_spec(dspec, params)
    bgen = torch.Generator(device=device).manual_seed(seed + 3)
    bank = 0.02 * torch.randn((n, dspec.dim), generator=bgen, device=device,
                              dtype=torch.float32).to(dspec.dtype)
    bank[:zero_clients] = 0.0
    return spec, bank, torch.ones((n,), dtype=torch.float32, device=device)


@torch.no_grad()
def _serve_personalized(args, cfg, api, params, device) -> dict:
    """``--clients``: one delta-bank row per client, one lane per client.
    Returns :func:`generate`'s record (without the cache) with
    ``expand_s``, and the ``api``, ``spec``, ``bank``, ``w``, lane-stacked
    ``params`` and ``batch``."""
    n = args.clients
    spec, bank, w = client_bank(params, n, args.rank, args.zero_clients,
                                args.seed)
    dspec = spec.delta
    ps = make_personalized_serve_step(api, spec)
    ids = torch.arange(n, device=device)
    batch = prompts(cfg, n, args.prompt_len, args.seed, device)

    _sync(device)
    t0 = time.perf_counter()
    stacked = ps.expand(bank, w, ids)
    _sync(device)
    expand_s = time.perf_counter() - t0
    print(f"[serve] expand {n} clients (d_delta={dspec.dim}, "
          f"{100 * dspec.dim / dspec.full.dim:.1f}% of D): {expand_s:.2f}s")
    rec = generate(api, stacked, batch, args.new_tokens)
    del rec["cache"]
    return {**rec, "expand_s": expand_s, "api": api, "spec": spec,
            "bank": bank, "w": w, "params": stacked, "batch": batch}


if __name__ == "__main__":
    main()
