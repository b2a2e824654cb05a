"""Renders the dry-run / roofline tables from the port's dry-run records
(counterpart of ``repro/launch/report.py``).

Usage: PYTHONPATH=src python -m repro_torch.launch.report \
    [--art artifacts/dryrun_torch]
Prints markdown to stdout.  A rank is one NVIDIA H100 SXM (80 GB HBM3);
the meshes are 256 and 512 of them.
"""
from __future__ import annotations

import argparse
import glob
import json
import os

__all__ = ["load", "dryrun_table", "roofline_table", "main"]


def load(art_dir: str):
    recs = []
    for p in sorted(glob.glob(os.path.join(art_dir, "*.json"))):
        if "__" not in os.path.basename(p):
            continue
        with open(p) as f:
            recs.append(json.load(f))
    return recs


def _fmt_bytes(b):
    return f"{b / 2**30:.2f}"


def dryrun_table(recs, mesh: str) -> str:
    lines = [
        f"### Dry-run — {mesh} "
        f"({'512' if mesh == 'multi_pod' else '256'} × H100 80 GB)",
        "",
        "| arch | shape | status | trace s | resident GiB/dev | fits "
        "80 GB | collectives |",
        "|---|---|---|---|---|---|---|",
    ]
    for r in recs:
        if r.get("mesh") != mesh:
            continue
        if r.get("status") == "skipped":
            lines.append(
                f"| {r['arch']} | {r['shape']} | skipped (full attn @500k)"
                f" | — | — | — | — |")
            continue
        if r.get("status") != "ok":
            lines.append(
                f"| {r['arch']} | {r['shape']} | ERROR | — | — | — | — |")
            continue
        m = r["memory"]
        resident = m.get("resident_bytes",
                         m.get("argument_bytes", 0)
                         + m.get("temp_bytes", 0))
        c = r.get("cost_full_hlo_once", {})
        lines.append(
            f"| {r['arch']} | {r['shape']} | ok | "
            f"{r.get('compile_seconds', 0):.0f} | "
            f"{_fmt_bytes(resident)} | "
            f"{'✓' if m.get('fits') else '✗'} | "
            f"{c.get('coll_count', 0)} |")
    return "\n".join(lines)


def roofline_table(recs) -> str:
    lines = [
        "### Roofline — single-pod (16×16, 256 × H100 80 GB), per-device "
        "terms",
        "",
        "| arch | shape | compute s | memory s | collective s | dominant"
        " | bound s | frac | useful-FLOP ratio |",
        "|---|---|---|---|---|---|---|---|---|",
    ]
    for r in recs:
        if r.get("mesh") != "single_pod" or r.get("status") != "ok":
            continue
        rl = r.get("roofline")
        if not rl:
            continue
        lines.append(
            f"| {r['arch']} | {r['shape']} | {rl['compute_s']:.3g} | "
            f"{rl['memory_s']:.3g} | {rl['collective_s']:.3g} | "
            f"{rl['dominant']} | {rl['step_lower_bound_s']:.3g} | "
            f"{rl['roofline_fraction']:.3f} | "
            f"{rl.get('useful_flops_ratio', 0):.2f} |")
    return "\n".join(lines)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--art", default="artifacts/dryrun_torch")
    args = ap.parse_args(argv)
    recs = load(args.art)
    print(dryrun_table(recs, "single_pod"))
    print()
    print(dryrun_table(recs, "multi_pod"))
    print()
    print(roofline_table(recs))


if __name__ == "__main__":
    main()
