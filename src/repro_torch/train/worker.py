"""One rank of a multi-process training gang (counterpart of
``repro/train/worker.py``).

``python -m repro_torch.train.worker --spec <path>`` is what
``train.supervisor.run_multiprocess_supervised`` (and ``launch/train.py
--procs N``) starts once per rank, as a fresh interpreter (never a fork
of a process that may have started CUDA).  The spec is a JSON file that
describes the rank's run::

    {"root": ..., "cfg": {...BBitLinearConfig fields...},
     "fit": {...fit_streaming kwargs, device included...},
     "procs": 2, "rank": 0, "coordinator": "127.0.0.1:12345",
     "local_devices": 1, "run_dir": ..., "fault_spec": {...},
     "fault_state": ..., "result_path": ..., "params_path": ...}

In order:

  1. arm the fault plan (``ft.faults.FaultPlan.from_spec``; the rank's
     ``fault_state`` file restores firing counts, so a ``times=1`` kill
     does not fire again after a respawn);
  2. join the gang (``distributed.runtime.init_runtime``: the process
     group, gloo or NCCL by the runtime's rule, and ``faults.set_rank``);
  3. train (``fit_streaming(..., runtime=rt)``);
  4. write the rank's result record (with its backend, the bytes of
     its collectives and its kernel launches) and its final and averaged
     params, then leave the group.

Exit codes are the supervisor's protocol: 0 finished, **64** a
``ValueError`` (a configuration or compatibility error, which the
supervisor never retries), anything else (signal deaths included) a
crash the supervisor may restart.
"""
from __future__ import annotations

import argparse
import json
import sys
import traceback

CONFIG_ERROR_EXIT = 64


def _dump_params(path: str, result) -> None:
    import numpy as np
    from repro_torch import tree

    arrs = {}
    for i, leaf in enumerate(tree.leaves(result.params)):
        arrs[f"p{i}"] = leaf.detach().cpu().numpy()
    if result.avg_params is not None:
        for i, leaf in enumerate(tree.leaves(result.avg_params)):
            arrs[f"a{i}"] = leaf.detach().cpu().numpy()
    np.savez(path, **arrs)


def run_spec(spec: dict) -> int:
    """Runs one rank's spec → the process's exit code."""
    from repro_torch.ft import faults

    if spec.get("fault_spec"):
        faults.arm_plan(faults.FaultPlan.from_spec(
            spec["fault_spec"], spec.get("fault_state")))

    from repro_torch.distributed.collectives import collective_bytes
    from repro_torch.kernels import ops
    from repro_torch.distributed.runtime import (heartbeat, init_runtime,
                                                 shutdown_runtime)
    fit = dict(spec.get("fit", {}))
    rt = init_runtime(procs=int(spec.get("procs", 1)),
                      rank=int(spec.get("rank", 0)),
                      coordinator=spec.get("coordinator"),
                      run_dir=spec.get("run_dir"),
                      device=fit.get("device"),
                      local_devices=int(spec.get("local_devices", 1)))

    from repro_torch.models.linear import BBitLinearConfig
    from repro_torch.train.streaming import fit_streaming

    cfg = BBitLinearConfig(**spec["cfg"])
    try:
        result = fit_streaming(spec["root"], cfg, runtime=rt, **fit)
    except ValueError:
        traceback.print_exc()
        return CONFIG_ERROR_EXIT

    if spec.get("params_path"):
        _dump_params(spec["params_path"], result)
    if spec.get("result_path"):
        rec = {"rank": rt.rank, "procs": rt.procs,
               "n_steps": result.n_steps,
               "examples_seen": result.examples_seen,
               "shards_processed": result.shards_processed,
               "progressive_acc": result.progressive_acc,
               "completed": result.completed,
               "train_seconds": result.train_seconds,
               "lineage": result.topology_lineage,
               "backend": rt.backend, "device": rt.device,
               "collectives": collective_bytes(),
               "kernel_counts": ops.counts()}
        with open(spec["result_path"], "w") as f:
            json.dump(rec, f)
    heartbeat(rt, step=result.n_steps,
              shards_done=result.shards_processed, phase="done")
    shutdown_runtime()
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.train.worker",
        description="one rank of a multi-process streaming training "
                    "gang (started by train.supervisor)")
    ap.add_argument("--spec", required=True,
                    help="path to this rank's JSON spec")
    args = ap.parse_args(argv)
    with open(args.spec) as f:
        spec = json.load(f)
    return run_spec(spec)


if __name__ == "__main__":
    sys.exit(main())
