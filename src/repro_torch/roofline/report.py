"""Render the dry-run's JSON records as markdown tables — the port of
``repro.roofline.report``: the reference's record and roofline tables, and
a ``card`` table of the records on one H100 with a ``fits`` column (the
predicted peak within the card's memory).

  PYTHONPATH=src python -m repro_torch.roofline.report [--dir experiments/dryrun_torch]
"""
from __future__ import annotations

import argparse
import glob
import json
import os

__all__ = ["load_records", "dryrun_table", "roofline_table", "card_table"]

_SHAPE_ORDER = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]


def load_records(directory: str) -> list[dict]:
    recs = []
    for path in sorted(glob.glob(os.path.join(directory, "*.json"))):
        with open(path) as f:
            recs.append(json.load(f))
    recs.sort(key=lambda r: (r["arch"], _SHAPE_ORDER.index(r["shape"])
                             if r["shape"] in _SHAPE_ORDER else 9, r["mesh"]))
    return recs


def _gb(x) -> str:
    return f"{x / 2**30:.2f}"


def dryrun_table(recs: list[dict]) -> str:
    lines = [
        "| arch | shape | mesh | status | params | bytes/dev (arg+tmp) GiB | "
        "collectives (count) | compile s |",
        "|---|---|---|---|---|---|---|---|",
    ]
    for r in recs:
        if r["status"] == "skip":
            lines.append(
                f"| {r['arch']} | {r['shape']} | {r['mesh']} | SKIP — "
                f"{r['reason']} | | | | |")
            continue
        if r["status"] == "error":
            lines.append(
                f"| {r['arch']} | {r['shape']} | {r['mesh']} | **ERROR** "
                f"{r['error'][:80]} | | | | |")
            continue
        b = r["bytes_per_device"]
        colls = ", ".join(
            f"{k}×{v}" for k, v in sorted(r["collectives"]["count"].items()))
        lines.append(
            f"| {r['arch']} | {r['shape']} | {r['mesh']} | ok | "
            f"{r['n_params'] / 1e9:.1f}B | "
            f"{_gb(b['argument'])}+{_gb(b['temp'])} | {colls or '—'} | "
            f"{r['compile_s']} |")
    return "\n".join(lines)


def roofline_table(recs: list[dict], mesh: str = "single") -> str:
    lines = [
        "| arch | shape | t_compute | t_memory | t_collective | bottleneck | "
        "MODEL_FLOPS | useful/HLO | note |",
        "|---|---|---|---|---|---|---|---|---|",
    ]
    for r in recs:
        if r["mesh"] != mesh:
            continue
        if r["status"] != "ok":
            reason = r.get("reason", r.get("error", ""))[:60]
            lines.append(
                f"| {r['arch']} | {r['shape']} | — | — | — | {r['status']}: "
                f"{reason} | | | |")
            continue
        t = r["roofline"]
        ratio = r.get("useful_flops_ratio")
        note = _note(t)
        lines.append(
            f"| {r['arch']} | {r['shape']} | {t['t_compute_s']:.2e} | "
            f"{t['t_memory_s']:.2e} | {t['t_collective_s']:.2e} | "
            f"**{t['bottleneck']}** | {r['model_flops']:.2e} | "
            f"{ratio:.2f} | {note} |")
    return "\n".join(lines)


def _note(t: dict) -> str:
    b = t["bottleneck"]
    if b == "collective":
        return "reduce gossip/FSDP bytes (shard-aware gossip, overlap)"
    if b == "memory":
        return "fuse elementwise passes / raise arithmetic intensity"
    return "near-roofline: increase per-chip batch or reduce redundant FLOPs"


def card_table(recs: list[dict]) -> str:
    """The ``card`` records: the roofline terms of the whole step on one
    H100, the predicted peak and whether it fits the card's memory."""
    lines = [
        "| arch | shape | t_compute | t_memory | bottleneck | peak GiB | "
        "fits | kernel launches | useful/counted |",
        "|---|---|---|---|---|---|---|---|---|",
    ]
    for r in recs:
        if r["mesh"] != "card":
            continue
        if r["status"] != "ok":
            reason = r.get("reason", r.get("error", ""))[:60]
            lines.append(f"| {r['arch']} | {r['shape']} | — | — | "
                         f"{r['status']}: {reason} | | | | |")
            continue
        t = r["roofline"]
        peak = r["bytes_per_device"]["peak_estimate"]
        fits = "yes" if peak <= r["hbm_bytes"] else "no"
        kernels = ", ".join(f"{k}×{v['launches']}"
                            for k, v in sorted(r["kernels"].items()))
        ratio = r.get("useful_flops_ratio")
        lines.append(
            f"| {r['arch']} | {r['shape']} | {t['t_compute_s']:.2e} | "
            f"{t['t_memory_s']:.2e} | **{t['bottleneck']}** | {_gb(peak)} | "
            f"{fits} | {kernels or '—'} | "
            f"{'—' if ratio is None else f'{ratio:.2f}'} |")
    return "\n".join(lines)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="experiments/dryrun_torch")
    args = ap.parse_args()
    recs = load_records(args.dir)
    print("## Dry-run records\n")
    print(dryrun_table(recs))
    print("\n## Roofline (one H100)\n")
    print(card_table(recs))
    print("\n## Roofline (single-pod)\n")
    print(roofline_table(recs, "single"))
    print("\n## Roofline (multi-pod)\n")
    print(roofline_table(recs, "multi"))


if __name__ == "__main__":
    main()
