#!/usr/bin/env python3
"""Times the widened b-bit linear kernels (B7 forward, B8 dW) on one
NVIDIA GPU at the TRON fits' shapes, over the launch layouts their
wrappers choose from, beside the one-call PyTorch yardsticks.

    python3 scripts/sweep_bbit_linear.py [--out sweep.json]

Shapes: 16,000 rows of random codes (numpy seed 0) at k=256, V=256 and
k=500, V=65536, C=1.  For B7 it times ``_fwd_launch`` at each bin group;
for B8 the plan kernel and ``_dw_sum_launch`` at each span of values a
block, and ``bbit_linear_bwd_dw`` with its cached plan.  Each
layout's result is held to the plain version (B7 within 1e-5 of each
row's sum of absolute terms, B8 within 1e-5 of each bin's).  The layout
``fwd_layout`` / ``dw_sum_span`` picks is marked.  Without a CUDA
device it exits non-zero.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

N = 16_000
SHAPES = ((256, 8), (500, 16))      # (k, b): configs/rcv1_oph, rcv1_bbit


def time_ms(torch, fn, iters: int, warmup: int = 2) -> float:
    """Device time per call, the calls queued behind a sleep kernel."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(50_000_000)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def within(got, want, scale) -> bool:
    return bool(((got - want).abs() <= 1e-5 * scale + 1e-6).all())


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None, help="write the times here")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("sweep_bbit_linear: no CUDA device", file=sys.stderr)
        return 2
    import torch.nn.functional as F
    from repro_torch.kernels import bbit_linear as bl

    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    rng = np.random.default_rng(0)
    rows = []

    def note(kernel, shape, layout, ms, ok, chosen):
        rows.append(dict(kernel=kernel, shape=shape, layout=layout, ms=ms,
                         ok=ok, chosen=chosen))
        print(f"{kernel} {shape} {layout} ms={ms} ok={ok}"
              f"{' (chosen)' if chosen else ''} card={card}")
        if not ok:
            raise RuntimeError(f"{kernel} {shape} {layout} is wrong")

    for k, b in SHAPES:
        v = 1 << b
        shape = f"n={N} k={k} V={v} C=1"
        codes = torch.from_numpy(
            rng.integers(0, v, size=(N, k)).astype(np.int32)).to(dev)
        table = torch.from_numpy(
            rng.normal(size=(k, v, 1)).astype(np.float32)).to(dev)
        dout = torch.from_numpy(
            rng.normal(size=(N, 1)).astype(np.float32)).to(dev)
        want = bl.bbit_linear_fwd_plain(codes, table)
        scale = bl.bbit_linear_fwd_plain(codes, table.abs())
        chosen = bl.fwd_layout(k, v, 1)
        for group in sorted({16, 32, 64, 128, k}):
            fn = lambda: bl._fwd_launch(codes, table, group)
            ok = within(fn(), want, scale)
            note("bbit_linear_fwd", shape, f"group={group}",
                 time_ms(torch, fn, 50), ok, group == chosen)
        flat = torch.arange(k, device=dev)[None, :] * v + codes.to(torch.int64)
        note("embedding_bag", shape, "", time_ms(torch, lambda: F.embedding_bag(
            flat, table.view(k * v, 1), mode="sum"), 50), True, False)
        del want, scale

        dw_want = bl.bbit_linear_bwd_dw_plain(codes, dout, v)
        dw_scale = bl.bbit_linear_bwd_dw_plain(codes, dout.abs(), v)
        plan = bl.bbit_linear_dw_plan(codes, v)
        note("bbit_linear_dw_plan", shape, f"passes={bl.dw_plan_passes(v)}",
             time_ms(torch, lambda: bl.bbit_linear_dw_plan(codes, v), 20),
             True, True)
        chosen = bl.dw_sum_span(N, v)
        for span in (32, 64, 128, 256, 512, 1024, 2048):
            if span > v:
                continue
            fn = lambda: bl._dw_sum_launch(plan, dout, v, span)
            ok = within(fn(), dw_want, dw_scale)
            note("bbit_linear_dw_sum", shape, f"span={span}",
                 time_ms(torch, fn, 50), ok, span == chosen)
        note("bbit_linear_bwd_dw", shape, "cached plan",
             time_ms(torch, lambda: bl.bbit_linear_bwd_dw(codes, dout, v),
                     50), True, True)
        w_rep = dout[:, 0].repeat_interleave(k)
        flat1 = flat.reshape(-1)
        note("bincount", shape, "", time_ms(torch, lambda: torch.bincount(
            flat1, weights=w_rep, minlength=k * v), 20), True, False)
        del dw_want, dw_scale, plan, flat, flat1, table
        torch.cuda.empty_cache()
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"card": card, "rows": rows}, f, indent=1)
    print(f"card: {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
