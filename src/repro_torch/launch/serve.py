"""Serving launcher: batched prefill, then greedy decode — the port of
``repro.launch.serve`` for the dense GQA decoders.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma3-12b \\
      --no-smoke --batch 4 --prompt-len 2048 --new-tokens 16

Runs on the card (``--device cuda``, the default) unless asked for the CPU
(``--device cpu``, where every kernel takes its plain PyTorch version).
Parameters are drawn on the device from a ``torch.Generator`` seeded with
``--seed``; prompts come from numpy with ``--seed + 1``.  The first new token
comes from the prefill logits, the other ``--new-tokens - 1`` from decode
steps, and the cache holds ``--prompt-len + --new-tokens`` positions, as in
the reference.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs.registry import get_config, make_batch
from repro_torch.launch.steps import make_serve_step
from repro_torch.models.registry import ModelApi, get_model_api

__all__ = ["build_parser", "generate", "main"]


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
                    help="personalized delta-bank serving (not ported yet)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (their plain versions)")
    return ap


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _finite(t: torch.Tensor) -> torch.Tensor:
    """Whether every element is finite, as a device bool, without a
    full-size temporary: NaN propagates through min and max."""
    lo, hi = torch.aminmax(t)
    return torch.isfinite(lo) & torch.isfinite(hi)


@torch.no_grad()
def generate(api: ModelApi, params: dict, batch: dict, new_tokens: int) -> dict:
    """Prefill ``batch``, then greedy-decode; prints the reference's lines.

    Returns ``tokens`` (B, new_tokens) on the CPU, ``logits`` (B,
    new_tokens, V) on the device (the last-position logits each token was
    picked from), ``prefill_s`` and ``decode_s`` (host clock, synchronized
    with the device), ``steps`` and ``finite`` (every prefill and decode
    logit finite)."""
    tokens = batch["tokens"]
    device = tokens.device
    b, s = tokens.shape
    cache_len = s + new_tokens
    serve_step = make_serve_step(api)

    _sync(device)
    t0 = time.perf_counter()
    logits, cache = api.prefill(params, batch, cache_len)
    last = [logits[:, -1].clone()]  # a view would keep all of them alive
    toks = last[0].argmax(-1).to(torch.int32)
    finite = _finite(logits)
    del logits
    _sync(device)
    prefill_s = time.perf_counter() - t0
    print(f"[serve] prefill {b}x{s}: {prefill_s:.2f}s")

    out = [toks]
    steps = new_tokens - 1
    t0 = time.perf_counter()
    for i in range(steps):
        logits_i, cache = serve_step(params, cache, toks, s + i)
        toks = logits_i.argmax(-1).to(torch.int32)
        finite = finite & _finite(logits_i)
        last.append(logits_i)
        out.append(toks)
    _sync(device)
    decode_s = time.perf_counter() - t0
    print(f"[serve] {steps} steps: {1e3 * decode_s / max(steps, 1):.1f} ms/step")
    tokens_out = torch.stack(out, dim=1).cpu()
    print(tokens_out)
    return {"tokens": tokens_out, "logits": torch.stack(last, dim=1),
            "prefill_s": prefill_s, "decode_s": decode_s, "steps": steps,
            "finite": bool(finite)}


def main(argv=None) -> dict:
    """Build the model, its parameters and the prompts, then
    :func:`generate`; returns its record together with the ``api``,
    ``params`` and ``batch`` it served."""
    args = build_parser().parse_args(argv)
    if args.clients:
        raise NotImplementedError(
            "--clients (personalized serving over the delta bank) is not "
            "ported yet: ROADMAP queue 1 item 9")
    device = torch.device(args.device)
    cfg = get_config(args.arch, smoke=args.smoke)
    if not cfg.supports_decode():
        raise SystemExit(f"{cfg.name} is encoder-only: no decode path")
    api = get_model_api(cfg)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    with torch.no_grad():
        params = api.init(gen, device)
    batch = make_batch(cfg, args.batch, args.prompt_len, seed=args.seed + 1,
                       device=device)
    rec = generate(api, params, batch, args.new_tokens)
    return {**rec, "api": api, "params": params, "batch": batch}


if __name__ == "__main__":
    main()
