#!/usr/bin/env python3
"""A 2-rank gang with a card of its own a rank, over NCCL, against one
process folding both slots: ``chip_smoke.py``'s dp phase on a machine
with at least two NVIDIA GPUs.

    python3 scripts/dp_gang_nccl.py [--out result.json]

It writes the stream phase's oph archive (the first 16,000 documents of
``chip_smoke.py``'s train corpus, 8 shards, k=256, b=8) under
build/dp_gang_nccl (removed after), fits it with ``fit_streaming``
(``data_parallel=2``, ``elastic=True``, configs/rcv1_oph.py's streaming
settings) in one process on cuda:0, then as a gang of two worker
processes (``run_multiprocess_supervised``, rank r on cuda:r), once
uninterrupted and once with rank 1 killed (SIGKILL) before step 5.
Each gang must run over NCCL, take exactly the restarts it is dealt,
and end on the fold's params and average bit for bit (two slots: a + b
is commutative).  It prints the card, each run's seconds and backend,
and one JSON line; any failure exits non-zero.  With fewer than two
cards it exits 2.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None, help="write the record here")
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    import chip_smoke as cs      # puts this checkout's src on the path
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        print("dp_gang_nccl: needs two CUDA devices", file=sys.stderr)
        return 2
    from repro_torch.configs.rcv1_oph import CONFIG
    from repro_torch.data.hashed_dataset import preprocess_and_save
    from repro_torch.ft.faults import FaultEvent, FaultPlan
    from repro_torch.ft.retry import BackoffPolicy
    from repro_torch.train.streaming import fit_streaming
    from repro_torch.train.supervisor import (RestartPolicy,
                                              run_multiprocess_supervised)

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    print(f"cards:\n{card}")
    dev = torch.device("cuda", 0)
    cs.phase_build()
    rows, labels = cs.make_train_corpus()
    work = os.path.join(ROOT, "build", "dp_gang_nccl")
    shutil.rmtree(work, ignore_errors=True)
    try:
        root = os.path.join(work, "oph")
        preprocess_and_save(root, rows[:cs.TRAIN_ROWS],
                            labels[:cs.TRAIN_ROWS], cs.K, cs.B,
                            scheme="oph", seed=cs.HASH_SEED,
                            n_shards=cs.STREAM_SHARDS,
                            chunk=CONFIG.preprocess_chunk, device=dev)
        cfg = CONFIG.linear_config()
        kw = CONFIG.stream_kwargs(seed=CONFIG.seed,
                                  data_parallel=cs.DP_WORLD, elastic=True)
        fold = fit_streaming(root, cfg, device=dev, **kw)
        print(f"fold: {fold.n_steps} steps in {fold.train_seconds} s on "
              f"{dev}")
        policy = RestartPolicy(max_restarts=2, backoff=BackoffPolicy(
            base_s=0.05, cap_s=0.5, seed=CONFIG.seed))
        kill = FaultPlan([FaultEvent(site="proc_kill", step=cs.DP_KILL_STEP,
                                     rank=1, times=1)])
        record, ok = {"cards": card}, True
        for name, fault, restarts in (("gang", None, 0),
                                      ("gang_kill", kill, 1)):
            t0 = time.perf_counter()
            run = run_multiprocess_supervised(
                root, cfg, procs=2, run_dir=os.path.join(work, name),
                policy=policy, local_devices=1,
                fault_spec=fault.to_spec() if fault else None,
                attempt_timeout_s=cs.DP_GANG_TIMEOUT_S,
                ckpt_dir=os.path.join(work, name, "ckpt"), device="cuda",
                **kw)
            wall = time.perf_counter() - t0
            ranks = {}
            for r, rec in run.results.items():
                same = cs.gang_matches(run.params_paths[r], fold)
                ranks[r] = dict(backend=rec["backend"], device=rec["device"],
                                bitwise=same,
                                train_seconds=rec["train_seconds"],
                                collectives=rec["collectives"])
                print(f"{name}: rank {r} backend={rec['backend']} device="
                      f"{rec['device']} params and average bitwise equal "
                      f"to the fold={same}; last attempt "
                      f"{rec['collectives']['count'] // 2} steps in "
                      f"{rec['train_seconds']} s")
                ok &= same and rec["backend"] == "nccl"
            devices = {v["device"] for v in ranks.values()}
            ok &= run.restarts == restarts and len(devices) == 2
            record[name] = dict(restarts=run.restarts, wall_s=wall,
                                attempt_s=run.attempt_s,
                                crashes=[c.error for c in run.crashes],
                                ranks=ranks)
            print(f"{name}: restarts={run.restarts} attempt seconds "
                  f"{run.attempt_s} in {wall} s")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    record["ok"] = bool(ok)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(record, f, indent=1)
    print(json.dumps({k: record[k] for k in ("ok", "cards")}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
