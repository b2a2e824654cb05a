"""Runs one cell of BENCHMARK.json once and prints its result.

    python3 hashbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout, on a machine with the cards the cell asks
for.  The last line of standard output is the result (one JSON object);
the last lines of standard error are the numbers the check compared,
each beside its limit.  ``--trace 0`` reports the cell's end-to-end
metrics, ``--trace 1`` its per-layer metrics from a traced window.
Without a CUDA card (or with fewer than the cell asks for) it exits 3
and prints no result.  ``--rehearse-cpu`` runs the cell on the CPU at the
small size of the ``rehearsal`` keys of the cell's files (the program's
plain versions; no device numbers): for finding faults here, never for
measuring.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--rehearse-cpu", action="store_true")
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    sys.path[:1] = [str(ROOT), str(ROOT / "src")]
    os.environ["USE_FLAX"] = "0"     # no JAX behind a library's back
    from hashbench import harness
    cell = harness.load_cell(args.workload, rehearsal=args.rehearse_cpu)
    import torch
    if args.rehearse_cpu:
        device = "cpu"
    else:
        if not torch.cuda.is_available():
            print("hashbench: no CUDA device; no result", file=sys.stderr)
            return 3
        if torch.cuda.device_count() < cell.chips:
            print(f"hashbench: {cell.name} needs {cell.chips} cards, have "
                  f"{torch.cuda.device_count()}; no result", file=sys.stderr)
            return 3
        device = "cuda:0"
    out = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                           device, T_START)
    if out["forbidden"]:
        print("hashbench: modules of JAX or the JAX package were loaded: "
              + ", ".join(out["forbidden"]) + "; no result", file=sys.stderr)
        return 4
    win = out["window"]
    print(f"setup: {out['setup_s']} s {out['phases']}; window: {win.calls} "
          f"calls in {win.wall_s} s; check: {out['check_s']} s",
          file=sys.stderr)
    for name, values in win.values.items():
        print(f"window {name}: {values}", file=sys.stderr)
    print(f"check compared: {out['notes']}", file=sys.stderr)
    for name, value, limit in out["checks"]:
        print(f"check {name} {value!r} limit {limit!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out["result"]), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
