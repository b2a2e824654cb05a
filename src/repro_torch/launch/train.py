"""Training launcher of the port: the paper's streaming path.

    python -m repro_torch.launch.train --mode stream --workdir DIR \\
        [--n-docs 2000] [--k 200] [--b 8] [--batch-size 128] [--lr 1e-2] \\
        [--epochs 1] [--seed 0] [--fail-at STEP] [--device cuda]

``--mode stream`` generates a synthetic expanded-rcv1 corpus, hashes it
once into a 4-shard packed archive under ``DIR/shards``
(``preprocess_and_save``, kept for later runs), and fits it with
``fit_streaming`` under the supervised restart loop
(``train.supervisor.run_supervised``, checkpoints under
``DIR/ckpt_stream``): a crash restores the newest valid checkpoint after
a capped backoff, and ``--fail-at`` injects one at that step to watch it
heal.  It runs on ``--device`` (default ``cuda``; ``cpu`` runs the
kernels' plain versions).  ``--mode linear`` (ROADMAP A3, the reference's
``data/loader.py``), ``--mode lm`` (A6) and ``--procs``/
``--data-parallel`` above 1 (A5) are not ported yet and exit with a
message.
"""
from __future__ import annotations

import argparse
import os
import sys

NOT_PORTED = {
    "linear": "--mode linear needs the reference's data/loader.py, "
              "which waits for ROADMAP A3",
    "lm": "--mode lm trains the LM zoo, which waits for ROADMAP A6",
    "gang": "--procs and --data-parallel above 1 run the data-parallel "
            "gang, which waits for ROADMAP A5",
}


def run_stream(args) -> dict:
    """Supervised streaming training over a sharded packed archive."""
    from repro_torch.configs.rcv1_oph import CONFIG
    from repro_torch.data.hashed_dataset import (preprocess_and_save,
                                                 shard_row_counts)
    from repro_torch.data.synth_rcv1 import SynthRcv1Config, generate_arrays
    from repro_torch.ft import faults
    from repro_torch.ft.watchdog import StepWatchdog
    from repro_torch.models.linear import BBitLinearConfig
    from repro_torch.train.supervisor import run_supervised

    hashed_dir = os.path.join(args.workdir, "shards")
    if not os.path.exists(os.path.join(hashed_dir, "meta.json")):
        rows, labels = generate_arrays(
            args.n_docs, SynthRcv1Config(
                seed=args.seed, topic_tokens=150, background_frac=0.35,
                max_pairs_per_doc=8000, max_triples_per_doc=4000))
        stats = preprocess_and_save(hashed_dir, rows, labels,
                                    k=args.k, b=args.b, seed=args.seed,
                                    n_shards=4, device=args.device)
        print(f"preprocessed {stats['n']} docs into 4 shards in "
              f"{stats['seconds_hashing']:.1f}s (one-time cost)")

    if args.fail_at is not None:
        faults.arm_plan(faults.FaultPlan([
            faults.FaultEvent(site="train_step", step=args.fail_at,
                              times=1)]))
    watchdog = StepWatchdog()
    try:
        sup = run_supervised(
            hashed_dir, BBitLinearConfig(k=args.k, b=args.b),
            policy=CONFIG.restart_policy(), watchdog=watchdog,
            ckpt_dir=os.path.join(args.workdir, "ckpt_stream"),
            seed=args.seed, device=args.device,
            **CONFIG.stream_kwargs(epochs=args.epochs,
                                   batch_size=args.batch_size, lr=args.lr,
                                   ckpt_every_shards=1))
    finally:
        faults.disarm()
    res = sup.result
    n_rows = sum(shard_row_counts(hashed_dir))
    print(f"streamed {n_rows} rows x {args.epochs} epochs in "
          f"{res.train_seconds:.1f}s on {args.device}: progressive_acc="
          f"{res.progressive_acc:.4f} steps={res.n_steps} "
          f"restarts={sup.restarts} "
          f"stragglers={sup.straggler_escalations}")
    return dict(progressive_acc=res.progressive_acc,
                steps=res.n_steps, restarts=sup.restarts,
                crashes=[c.error for c in sup.crashes])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description=__doc__.split("\n\n")[0])
    ap.add_argument("--mode", default="stream",
                    choices=["linear", "stream", "lm"])
    ap.add_argument("--workdir", default="artifacts/train")
    ap.add_argument("--n-docs", type=int, default=2000)
    ap.add_argument("--k", type=int, default=200)
    ap.add_argument("--b", type=int, default=8)
    ap.add_argument("--batch-size", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-2)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--fail-at", type=int, default=None,
                    help="inject a crash at this step (fault tolerance)")
    ap.add_argument("--epochs", type=int, default=1,
                    help="passes over the archive")
    ap.add_argument("--data-parallel", type=int, default=None,
                    help="data-parallel world (not ported: ROADMAP A5)")
    ap.add_argument("--procs", type=int, default=None,
                    help="gang of processes (not ported: ROADMAP A5)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (their plain versions)")
    args = ap.parse_args(argv)
    if args.mode != "stream":
        print(NOT_PORTED[args.mode], file=sys.stderr)
        return 2
    if (args.procs or 1) > 1 or (args.data_parallel or 1) > 1:
        print(NOT_PORTED["gang"], file=sys.stderr)
        return 2
    os.makedirs(args.workdir, exist_ok=True)
    run_stream(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
