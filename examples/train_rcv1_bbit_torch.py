"""End-to-end run on the PyTorch port: train a ~100M-parameter hashed
linear model for a few hundred steps; ``examples/train_rcv1_bbit.py`` on
``repro_torch``.

Model: 16-class classifier over b=12-bit codes with k=1536 hashes →
weight table 1536 × 4096 × 16 ≈ 100.7M weights.  Minibatch AdamW
(B7 forward, B8 dW on the card), checkpointing every 50 steps, and the
straggler watchdog.  ``--device cpu`` runs the kernels' plain versions.

Run:  PYTHONPATH=src python examples/train_rcv1_bbit_torch.py \\
          [--steps 300] [--device cuda]
"""
import argparse
import os
import time

import numpy as np
import torch

from repro_torch.ckpt import checkpoint as ckpt
from repro_torch.data.hashed_dataset import preprocess_rows
from repro_torch.data.loader import HashedCodesLoader
from repro_torch.data.synth_rcv1 import SynthRcv1Config, generate_arrays
from repro_torch.devices import resolve_device
from repro_torch.ft.watchdog import StepWatchdog
from repro_torch.models.linear import (
    BBitLinearConfig, bbit_logits, init_bbit_linear, predict_classes,
)
from repro_torch.optim.optimizers import make_optimizer
from repro_torch.train.losses import mean_loss_fn
from repro_torch.train.metrics import accuracy
from repro_torch.train.steps import build_train_step, init_state


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--k", type=int, default=1536)
    ap.add_argument("--b", type=int, default=12)
    ap.add_argument("--n-docs", type=int, default=3000)
    ap.add_argument("--workdir", default="artifacts/example_100m_torch")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (their plain versions)")
    args = ap.parse_args()
    dev = resolve_device(args.device)

    n_classes = 16
    lcfg = BBitLinearConfig(k=args.k, b=args.b, n_classes=n_classes)
    print(f"model: k={args.k} × 2^{args.b} × {n_classes} classes = "
          f"{lcfg.n_weights/1e6:.1f}M parameters")

    cfg = SynthRcv1Config(seed=5, n_classes=n_classes, topic_tokens=200,
                          background_frac=0.3, max_pairs_per_doc=3000,
                          max_triples_per_doc=1500)
    t0 = time.time()
    rows, labels = generate_arrays(args.n_docs, cfg)
    print(f"corpus: {len(rows)} docs in {time.time()-t0:.0f}s")
    t0 = time.time()
    codes = preprocess_rows(rows, k=args.k, b=args.b, seed=1, chunk=256,
                            device=dev)
    print(f"hashing (one-time): {time.time()-t0:.0f}s "
          f"→ {args.k*args.b} bits/doc")

    def to_dev(arr, dtype):
        return torch.from_numpy(np.ascontiguousarray(arr, dtype)).to(dev)

    n_te = args.n_docs // 5
    tr = slice(0, args.n_docs - n_te)
    te = slice(args.n_docs - n_te, None)
    opt = make_optimizer("adamw", 3e-3)
    loss_fn = mean_loss_fn(lambda p, c: bbit_logits(p, c, lcfg),
                           "softmax", l2=1e-7)
    step_fn = build_train_step(loss_fn, opt)
    state = init_state(init_bbit_linear(
        lcfg, torch.Generator().manual_seed(0), device=dev), opt)
    loader = HashedCodesLoader(codes[tr], labels[tr], batch_size=256,
                               seed=0)
    wd = StepWatchdog()
    ckpt_dir = os.path.join(args.workdir, "ckpt")
    t0 = time.time()
    losses = []
    for step, bc, by in loader.batches(0):
        if step >= args.steps:
            break
        wd.start_step()
        state, loss = step_fn(state, to_dev(bc, np.int32),
                              to_dev(by, np.int32))
        losses.append(float(loss))
        wd.end_step(step)
        if (step + 1) % 50 == 0:
            ckpt.save(ckpt_dir, step + 1, state)
            print(f"step {step+1}: loss={np.mean(losses[-50:]):.4f} "
                  f"({(step+1)/(time.time()-t0):.1f} steps/s)")
    te_acc = accuracy(predict_classes(
        state.params, to_dev(codes[te], np.int32), lcfg), labels[te])
    print(f"done: {args.steps} steps in {time.time()-t0:.0f}s; "
          f"test acc (16-way) = {te_acc:.3f}; "
          f"stragglers flagged = {len(wd.flagged_steps)}")


if __name__ == "__main__":
    main()
