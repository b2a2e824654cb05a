#!/usr/bin/env python3
"""Times B5-B8 on a bfloat16 table beside the same kernels on a float32
one, on one NVIDIA GPU.

    python3 scripts/sweep_table_dtypes.py [--out sweep.json]

Each bfloat16 result is held to the float32 kernel's on the same inputs
bit for bit: B5 and B7 (the forwards) on the table widened, B6 and B8
(dW) as the float32 dW rounded to bfloat16.  The two are timed in turns
(float32, bfloat16, bfloat16, float32), each call queued behind a sleep
kernel so that the card runs the calls back to back:

  * B5 (packed forward) at k=256, b=8 on 1, 64 and 1,024 rows of random
    codes (the engine's row buckets and a larger batch);
  * B7 (widened forward) on 16,000 rows of uniform random codes at V in
    {256 (k=256), 4,096, 16,384, 32,768, 65,536 (k=500)}: float32 tables
    of 0.26 to 131 MB and bfloat16 ones of half that, so the sweep shows
    how much of B7's time the table's size (inside the 50 MB L2 or not)
    decides;
  * B6 (packed dW) at 1,024 rows, k=256, b=8, and B8 (widened dW over a
    cached plan) at 16,000 x 500, V=65,536.

It prints the card's name and power limit first.  Without a CUDA device
it exits non-zero.
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

ROWS_B5 = (1, 64, 1024)
B7_CASES = ((256, 256), (4096, 500), (16384, 500), (32768, 500),
            (65536, 500))                # (V, k)
N = 16_000
SLEEP_CYCLES = 200_000_000


def time_ms(torch, fn, iters: int) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SLEEP_CYCLES)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def words(torch, t):
    return t.view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("sweep_table_dtypes: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.core.bbit import pack_codes
    from repro_torch.kernels import bbit_linear as bl

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"card: {card}")
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(0)
    bf = torch.bfloat16
    records = []

    def pair(kernel, shape, f32, b16, same, iters):
        turns = [time_ms(torch, fn, iters) for fn in (f32, b16, b16, f32)]
        rec = dict(kernel=kernel, shape=shape, bitwise=same,
                   float32_ms=[turns[0], turns[3]],
                   bfloat16_ms=[turns[1], turns[2]], card=card)
        records.append(rec)
        print(json.dumps(rec))
        if not same:
            raise SystemExit(f"{kernel} {shape}: bfloat16 departs")

    for rows in ROWS_B5:
        packed = torch.from_numpy(pack_codes(rng.integers(
            0, 256, size=(rows, 256)).astype(np.uint16), 8)).to(dev)
        t16 = (0.01 * torch.randn((256, 256, 1), device=dev)).to(bf)
        t32 = t16.float()
        f32 = lambda: bl.bbit_linear_packed_fwd(packed, t32, k=256, bits=8)
        b16 = lambda: bl.bbit_linear_packed_fwd(packed, t16, k=256, bits=8)
        pair("bbit_linear_packed_fwd", f"rows={rows} k=256 b=8", f32, b16,
             torch.equal(words(torch, f32()), words(torch, b16())), 500)
    for v, k in B7_CASES:
        codes = torch.from_numpy(rng.integers(0, v, size=(N, k)).astype(
            np.int32)).to(dev)
        t16 = (0.01 * torch.randn((k, v, 1), device=dev)).to(bf)
        t32 = t16.float()
        f32 = lambda: bl.bbit_linear_fwd(codes, t32)
        b16 = lambda: bl.bbit_linear_fwd(codes, t16)
        pair("bbit_linear_fwd", f"n={N} k={k} V={v} table "
             f"{t32.numel() * 4 / 1e6:.1f}/{t16.numel() * 2 / 1e6:.1f} MB",
             f32, b16, torch.equal(words(torch, f32()), words(torch, b16())),
             50)
        del codes, t16, t32
        torch.cuda.empty_cache()
    packed = torch.from_numpy(pack_codes(rng.integers(
        0, 256, size=(1024, 256)).astype(np.uint16), 8)).to(dev)
    dout = torch.randn((1024, 1), device=dev)
    f32 = lambda: bl.bbit_linear_packed_bwd_dw(packed, dout, 256, k=256,
                                               bits=8)
    b16 = lambda: bl.bbit_linear_packed_bwd_dw(packed, dout, 256, k=256,
                                               bits=8, dtype=bf)
    pair("bbit_linear_packed_bwd_dw", "n=1024 k=256 b=8", f32, b16,
         torch.equal(words(torch, f32().to(bf)), words(torch, b16())), 200)
    codes = torch.from_numpy(rng.integers(0, 1 << 16, size=(N, 500)).astype(
        np.int32)).to(dev)
    dout = torch.randn((N, 1), device=dev)
    f32 = lambda: bl.bbit_linear_bwd_dw(codes, dout, 1 << 16)
    b16 = lambda: bl.bbit_linear_bwd_dw(codes, dout, 1 << 16, bf)
    pair("bbit_linear_bwd_dw", f"n={N} k=500 V=65536 (a cached plan)", f32,
         b16, torch.equal(words(torch, f32().to(bf)), words(torch, b16())),
         50)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(records, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
