"""Run one phase of a checkout's ``chip_smoke.py`` several times in one
process on the card, and print the end-to-end numbers of each run: the
run-to-run spread of a phase's metrics, for comparing two trees on one
card.

  python3 repeat_phase.py --tree DIR --repeat 5 personalized

``--tree`` is a checkout of this repo: its ``chip_smoke.py`` and its
``src`` are imported, and its kernels built into its own ``build/``.  The
phase is a function of that ``chip_smoke.py`` that takes only the device
(``personalized`` is phase 11, ``flash_backward_phase`` phase 12's kernel
checks).  Cached device memory is freed between runs, as ``chip_smoke.py``
does between phases.  Phase 11's serve records (expand, prefill, decode,
host clock after a synchronize) are collected from ``serve.main``; the last
line is a JSON object of them beside the card's name and power limit.
Compare two trees only within one call, in the order A, B, B, A.
"""
import argparse
import gc
import json
import os
import statistics
import sys
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=".")
    ap.add_argument("--repeat", type=int, default=5)
    ap.add_argument("phase")
    args = ap.parse_args(argv)
    tree = os.path.abspath(args.tree)
    sys.path[:0] = [tree, os.path.join(tree, "src")]
    import torch

    import chip_smoke
    from repro_torch.kernels import build
    from repro_torch.launch import serve

    if not torch.cuda.is_available():
        print("repeat_phase.py needs a CUDA card", file=sys.stderr)
        return 2
    assert chip_smoke.__file__.startswith(tree), chip_smoke.__file__
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = chip_smoke.card_line()
    build.load_library()
    records = []
    inner = serve.main

    def recorded(*a, **kw):
        rec = inner(*a, **kw)
        records.append({"expand_s": rec.get("expand_s"),
                        "prefill_s": rec["prefill_s"],
                        "decode_ms_per_step": 1e3 * rec["decode_s"]
                        / max(rec["steps"], 1)})
        return rec

    serve.main = recorded
    walls = []
    for i in range(args.repeat):
        t = time.perf_counter()
        getattr(chip_smoke, args.phase)(dev)
        walls.append(time.perf_counter() - t)
        gc.collect()
        torch.cuda.empty_cache()
        print(f"[repeat {i}] {args.phase} {walls[-1]:.3f} s", flush=True)
    out = {"tree": args.tree, "phase": args.phase, "card": card,
           "wall_s": walls, "serve": records}
    for key in ("expand_s", "prefill_s", "decode_ms_per_step"):
        vals = [r[key] for r in records if r[key] is not None]
        if vals:
            out[key] = {"min": min(vals), "median": statistics.median(vals),
                        "max": max(vals)}
    print(card)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
