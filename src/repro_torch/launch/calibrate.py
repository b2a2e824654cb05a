"""Calibration launcher of the port: "calibrate once, run fast"
(counterpart of ``repro/launch/calibrate.py``).

One microbenchmark pass (``perf.calibrate``) over the dispatchable ops on
this box, writing a versioned, device-fingerprinted cost profile:

    python -m repro_torch.launch.calibrate [--out PATH] [--budget-s S] \\
        [--trials N] [--k K] [--b B ...] [--scheme S ...] \\
        [--max-batch N] [--no-serving] [--seed 0] [--table-version v1] \\
        [--device cuda]

The defaults are ``configs/rcv1_oph.py``'s.  Afterwards every launcher
given ``--profile`` (or reading ``CONFIG.profile_path`` / the
``REPRO_PROFILE`` env var) counts its dispatches against the measured
table, and the serving engine sizes its micro-batches from its
``serve_score`` curve.  The pass is wall-clock budgeted (``--budget-s``):
a partial table is safe, since a bucket without a measured arm keeps
the static rule.  It runs on ``--device`` (default ``cuda``; ``cpu``
times the plain versions, a profile for a box without CUDA).
"""
from __future__ import annotations

import argparse
import json
import os
import sys


def main(argv=None) -> int:
    from repro_torch.configs.rcv1_oph import CONFIG
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=CONFIG.profile_path,
                    help="profile JSON destination")
    ap.add_argument("--budget-s", type=float,
                    default=CONFIG.calibrate_budget_s,
                    help="wall-clock budget for the whole pass")
    ap.add_argument("--trials", type=int, default=CONFIG.calibrate_trials)
    ap.add_argument("--k", type=int, default=CONFIG.k)
    ap.add_argument("--b", type=int, action="append", default=None,
                    help="b values to measure (repeatable; default "
                         f"[{CONFIG.b}])")
    ap.add_argument("--scheme", action="append", default=None,
                    help="schemes to measure (repeatable; default "
                         f"[{CONFIG.scheme!r}])")
    ap.add_argument("--max-batch", type=int,
                    default=CONFIG.calibrate_max_batch,
                    help="serving row-bucket ceiling for the "
                         "serve_score curve")
    ap.add_argument("--no-serving", action="store_true",
                    help="skip the serve_score sizing curve")
    ap.add_argument("--seed", type=int, default=CONFIG.seed)
    ap.add_argument("--table-version", default="v1")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (their plain versions)")
    args = ap.parse_args(argv)

    from repro_torch import perf
    table = perf.calibrate(**CONFIG.calibrate_kwargs(
        k=args.k,
        b_values=tuple(args.b or [CONFIG.b]),
        schemes=tuple(args.scheme or [CONFIG.scheme]),
        max_batch=args.max_batch,
        include_serving=not args.no_serving,
        trials=args.trials, budget_s=args.budget_s, seed=args.seed,
        table_version=args.table_version, device=args.device))
    table.save(args.out)
    summary = perf.summarize(table)
    print(json.dumps(summary, indent=2, sort_keys=True))
    print(f"\nwrote {len(table.entries)} entries "
          f"({table.meta.get('calibrate_seconds', '?')}s) "
          f"-> {os.path.abspath(args.out)}")
    print("use it via --profile, CONFIG.profile_path, or "
          f"REPRO_PROFILE={args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
