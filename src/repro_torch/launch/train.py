"""Training launcher of the port: the paper's pipeline (counterpart of
``repro/launch/train.py``).

    python -m repro_torch.launch.train --mode linear --workdir DIR \
        [--n-docs 2000] [--k 200] [--b 8] [--steps 300] \
        [--batch-size 128] [--lr 1e-2] [--ckpt-every 50] [--seed 0] \
        [--fail-at STEP] [--profile PATH] [--device cuda]
    python -m repro_torch.launch.train --mode stream --workdir DIR \
        [--n-docs 2000] [--k 200] [--b 8] [--batch-size 128] [--lr 1e-2] \
        [--epochs 1] [--seed 0] [--fail-at STEP] [--device cuda] \
        [--data-parallel N] [--procs P] [--local-devices L]

``--mode linear`` (the reference's default; the paper's workload at
``configs/rcv1_bbit.py``'s k=500, b=16 with ``--k 500 --b 16``):
synthetic expanded-rcv1 → one-time b-bit minwise hashing into a 4-shard
packed archive under ``DIR/hashed`` (``preprocess_and_save``, kernel B1
at any b, kept for later runs) → ``load_hashed`` with the last quarter
held out → AdamW minibatch steps of the mean logistic loss over
``bbit_logits`` (B7 forward, B8 dW) on ``HashedCodesLoader`` batches,
checkpoints every ``--ckpt-every`` steps under ``DIR/ckpt`` and a resume
from the newest one; ``--fail-at`` raises once at that step
(``ft.watchdog.FailureInjector``), so a rerun resumes and ends on the
uninterrupted run's bits.  It prints the test accuracy and the cost
model's hits and fallbacks.

``--mode stream`` hashes once into ``DIR/shards`` and fits the archive
with ``fit_streaming`` under the supervised restart loop
(``train.supervisor.run_supervised``, checkpoints under
``DIR/ckpt_stream``): a crash restores the newest valid checkpoint after
a capped backoff, and ``--fail-at`` injects one at that step.
``--data-parallel N`` trains N shard slots a step (elastic: folded onto
the devices there are).  ``--procs P`` (P > 1) runs a gang of P worker
processes instead (``train.supervisor.run_multiprocess_supervised``,
``--local-devices`` devices a rank, coordinated checkpoints, bookkeeping
under ``DIR/gang``), ``--data-parallel`` defaulting to P; there
``--fail-at`` kills the last rank at that step (SIGKILL) and the gang
restarts.  ``--mode linear`` ignores ``--procs``, as the reference's
does.

Both run on ``--device`` (default ``cuda``; ``cpu`` runs the kernels'
plain versions).  ``--profile`` loads a cost-model profile (default:
``configs/rcv1_oph.py``'s ``profile_path`` if it exists).  ``--mode lm``
(ROADMAP A6) is not ported yet and exits with a message.
"""
from __future__ import annotations

import argparse
import os
import sys

import numpy as np

NOT_PORTED = {
    "lm": "--mode lm trains the LM zoo, which waits for ROADMAP A6",
}


def _initial_params(lcfg, seed: int, device):
    """The linear model's start: a 0.01·N(0, 1) table from a CPU
    generator seeded with ``seed`` (the reference draws from
    ``jax.random.key(seed)``, which torch cannot reproduce; parity tests
    replace this with the reference's draw)."""
    import torch
    from repro_torch.models.linear import init_bbit_linear
    return init_bbit_linear(lcfg, torch.Generator().manual_seed(seed),
                            device=device)


def run_linear(args) -> dict:
    """Hash once, then train the b-bit linear model with AdamW minibatch
    steps, checkpoints and resume → {test_acc, final_loss, steps,
    losses (this run's, one a step), params (the final ones)}."""
    import torch
    from repro_torch import perf
    from repro_torch.ckpt import checkpoint as ckpt
    from repro_torch.data.hashed_dataset import (load_hashed,
                                                 preprocess_and_save)
    from repro_torch.data.loader import HashedCodesLoader
    from repro_torch.data.synth_rcv1 import SynthRcv1Config, generate_arrays
    from repro_torch.devices import resolve_device
    from repro_torch.ft.watchdog import FailureInjector, StepWatchdog
    from repro_torch.models.linear import (BBitLinearConfig, bbit_logits,
                                           predict_classes)
    from repro_torch.optim.optimizers import make_optimizer
    from repro_torch.train.losses import mean_loss_fn
    from repro_torch.train.metrics import accuracy
    from repro_torch.train.steps import build_train_step, init_state

    dev = resolve_device(args.device)
    hashed_dir = os.path.join(args.workdir, "hashed")
    if not os.path.exists(os.path.join(hashed_dir, "meta.json")):
        rows, labels = generate_arrays(
            args.n_docs, SynthRcv1Config(
                seed=args.seed, topic_tokens=150, background_frac=0.35,
                max_pairs_per_doc=8000, max_triples_per_doc=4000))
        stats = preprocess_and_save(hashed_dir, rows, labels,
                                    k=args.k, b=args.b, seed=args.seed,
                                    n_shards=4, device=dev)
        print(f"preprocessed {stats['n']} docs in "
              f"{stats['seconds_hashing']:.1f}s (one-time cost)")
    codes, labels, meta = load_hashed(hashed_dir)
    n_test = len(labels) // 4
    codes_tr, y_tr = codes[:-n_test], labels[:-n_test]
    codes_te, y_te = codes[-n_test:], labels[-n_test:]

    lcfg = BBitLinearConfig(k=meta["k"], b=meta["b"])
    opt = make_optimizer("adamw", args.lr)
    loss_fn = mean_loss_fn(lambda p, c: bbit_logits(p, c, lcfg),
                           "logistic", l2=1e-6)
    step_fn = build_train_step(loss_fn, opt)
    loader = HashedCodesLoader(codes_tr, y_tr, args.batch_size,
                               seed=args.seed)

    ckpt_dir = os.path.join(args.workdir, "ckpt")
    state = init_state(_initial_params(lcfg, args.seed, dev), opt)
    start_step = 0
    restored = ckpt.restore_if_exists(ckpt_dir, state)
    if restored is not None:
        state, start_step = restored
        print(f"resumed from step {start_step}")

    def to_dev(arr: np.ndarray, dtype) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(arr, dtype)).to(dev)

    watchdog = StepWatchdog()
    injector = FailureInjector(args.fail_at)
    total_steps = args.steps
    losses = []
    step = start_step - 1
    for step, bc, by in loader.batches(start_step=start_step):
        if step >= total_steps:
            break
        injector.maybe_fail(step)
        watchdog.start_step()
        state, loss = step_fn(state, to_dev(bc, np.int32),
                              to_dev(by, np.int32))
        losses.append(float(loss))
        watchdog.end_step(step)
        if (step + 1) % args.ckpt_every == 0:
            ckpt.save(ckpt_dir, step + 1, state)
    steps = min(total_steps, step + 1)
    ckpt.save(ckpt_dir, steps, state)

    te_acc = accuracy(
        predict_classes(state.params, to_dev(codes_te, np.int32), lcfg),
        y_te)
    final_loss = float(np.mean(losses[-10:])) if losses else float("nan")
    rep = perf.dispatch_report()
    print(f"final loss={final_loss:.4f} test_acc={te_acc:.4f} "
          f"stragglers={len(watchdog.flagged_steps)} "
          f"dispatch_hits={rep['hits']} fallbacks={rep['fallbacks']}")
    return dict(test_acc=te_acc, final_loss=final_loss, steps=int(steps),
                losses=losses, params=state.params)


def run_stream(args) -> dict:
    """Supervised streaming training over a sharded packed archive, in
    one process or, with ``--procs`` above 1, as a gang under
    gang-restart supervision (coordinated checkpoints, a respawn from
    the newest committed step on any worker death)."""
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

    if args.procs and args.procs > 1:
        from repro_torch.train.supervisor import run_multiprocess_supervised
        fault_spec = None
        if args.fail_at is not None:
            fault_spec = faults.FaultPlan([faults.FaultEvent(
                site="proc_kill", step=args.fail_at, rank=args.procs - 1,
                times=1)]).to_spec()
        run = run_multiprocess_supervised(
            hashed_dir, BBitLinearConfig(k=args.k, b=args.b),
            procs=args.procs, run_dir=os.path.join(args.workdir, "gang"),
            policy=CONFIG.restart_policy(), fault_spec=fault_spec,
            local_devices=args.local_devices,
            ckpt_dir=os.path.join(args.workdir, "ckpt_stream"),
            seed=args.seed, device=args.device,
            **CONFIG.stream_kwargs(
                epochs=args.epochs, batch_size=args.batch_size,
                lr=args.lr, ckpt_every_shards=1,
                data_parallel=args.data_parallel or args.procs))
        rec = run.result
        print(f"gang of {args.procs} procs streamed "
              f"{rec['examples_seen']} rows x {args.epochs} epochs in "
              f"{rec['train_seconds']:.1f}s on {args.device} over "
              f"{rec['backend']}: progressive_acc="
              f"{rec['progressive_acc']:.4f} steps={rec['n_steps']} "
              f"gang_restarts={run.restarts} "
              f"topology={rec['lineage']}")
        return dict(progressive_acc=rec["progressive_acc"],
                    steps=rec["n_steps"], restarts=run.restarts,
                    crashes=[c.error for c in run.crashes])

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
                                   ckpt_every_shards=1,
                                   data_parallel=args.data_parallel))
    finally:
        faults.disarm()
    res = sup.result
    n_rows = sum(shard_row_counts(hashed_dir))
    from repro_torch import perf
    rep = perf.dispatch_report()
    print(f"streamed {n_rows} rows x {args.epochs} epochs in "
          f"{res.train_seconds:.1f}s on {args.device}: progressive_acc="
          f"{res.progressive_acc:.4f} steps={res.n_steps} "
          f"restarts={sup.restarts} "
          f"stragglers={sup.straggler_escalations} "
          f"topology={res.topology_lineage} "
          f"dispatch={res.dispatch} "
          f"(profile_hits={rep['hits']} fallbacks={rep['fallbacks']})")
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
    ap.add_argument("--steps", type=int, default=300,
                    help="linear mode: train steps")
    ap.add_argument("--batch-size", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-2)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt-every", type=int, default=50,
                    help="linear mode: checkpoint every N steps")
    ap.add_argument("--fail-at", type=int, default=None,
                    help="inject a crash at this step (fault tolerance)")
    ap.add_argument("--epochs", type=int, default=1,
                    help="passes over the archive")
    ap.add_argument("--data-parallel", type=int, default=None,
                    help="stream mode: logical data-parallel world "
                         "(elastic: folds onto the devices there are)")
    ap.add_argument("--procs", type=int, default=None,
                    help="stream mode: a gang of N worker processes "
                         "(localhost) under gang-restart supervision")
    ap.add_argument("--local-devices", type=int, default=1,
                    help="stream mode with --procs: devices a rank")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (their plain versions)")
    ap.add_argument("--profile", default=None,
                    help="cost-model profile JSON (default: the config's "
                         "profile_path if it exists; missing or "
                         "mismatched files leave the static rules)")
    args = ap.parse_args(argv)
    if args.mode == "lm":
        print(NOT_PORTED[args.mode], file=sys.stderr)
        return 2
    os.makedirs(args.workdir, exist_ok=True)
    from repro_torch import perf
    from repro_torch.configs.rcv1_oph import CONFIG
    profile = args.profile if args.profile is not None \
        else CONFIG.profile_path
    if perf.maybe_load_profile(profile):
        print(f"dispatch: cost-model profile {profile} "
              f"(table {perf.get_model().table.table_version})")
    else:
        print("dispatch: static rules (no usable profile; run "
              "python -m repro_torch.launch.calibrate to measure this box)")
    if args.mode == "linear":
        run_linear(args)
    else:
        run_stream(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
