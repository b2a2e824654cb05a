"""Splices freshly generated dry-run / roofline tables into a markdown
file between its BEGIN/END GENERATED markers (counterpart of
``repro/launch/update_experiments.py``).

Usage: PYTHONPATH=src python -m repro_torch.launch.update_experiments \
    [--art artifacts/dryrun_torch] [--path EXPERIMENTS.md]
"""
from __future__ import annotations

import argparse
import re

from repro_torch.launch.report import dryrun_table, load, roofline_table

__all__ = ["splice", "main"]


def splice(text: str, recs) -> str:
    """``text`` with the generated tables between its markers."""
    dr = (dryrun_table(recs, "single_pod") + "\n\n"
          + dryrun_table(recs, "multi_pod"))
    rl = roofline_table(recs)
    text = re.sub(
        r"(<!-- BEGIN GENERATED DRYRUN TABLES[^\n]*-->).*?"
        r"(<!-- END GENERATED DRYRUN TABLES -->)",
        lambda m: m.group(1) + "\n" + dr + "\n" + m.group(2),
        text, flags=re.S)
    return re.sub(
        r"(<!-- BEGIN GENERATED ROOFLINE TABLE -->).*?"
        r"(<!-- END GENERATED ROOFLINE TABLE -->)",
        lambda m: m.group(1) + "\n" + rl + "\n" + m.group(2),
        text, flags=re.S)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--art", default="artifacts/dryrun_torch")
    ap.add_argument("--path", default="EXPERIMENTS.md")
    args = ap.parse_args(argv)
    recs = load(args.art)
    with open(args.path) as f:
        text = f.read()
    with open(args.path, "w") as f:
        f.write(splice(text, recs))
    n_ok = sum(1 for r in recs if r.get("status") == "ok")
    n_skip = sum(1 for r in recs if r.get("status") == "skipped")
    n_err = sum(1 for r in recs if r.get("status") == "error")
    print(f"{args.path} updated: {n_ok} ok, {n_skip} skipped, "
          f"{n_err} error cells")


if __name__ == "__main__":
    main()
