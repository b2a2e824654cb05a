#!/usr/bin/env python3
"""Times the VW sketch kernel (B9) over the designs its wrapper chooses
from, and the Hamming kernel (B10) over its row groups a warp, on one
NVIDIA GPU, at the shapes of ``chip_smoke.py``'s train and search phases.

    python3 scripts/sweep_vw_sketch.py [--out sweep.json]
    python3 scripts/sweep_vw_sketch.py --wrappers [--root DIR] [--out f]

The train corpus is ``chip_smoke.py``'s (20,000 synthetic expanded-rcv1
documents, seed 11) in its length-sorted chunks of 256 rows, with
values of ones as on the main path.  B9 runs on three of them: the
middle one (about 490 ids a row, padded to 512), the widest full one
(4,182-4,245, padded to 4,352) and the last, 32 rows of 4,247-4,435 ids
(padded to 4,480).  The sweep times each design at m in {64, 128, 256, 512, 1024,
16384}: "lanes" at each power of two of threads a row whose private
columns fit 128 KiB of shared memory, "slice" at each slice of 256 to
16,384 buckets, every result held to the plain version byte
for byte, beside ``torch.zeros`` of the sketch's shape (the bytes
written alone); the wrapper's own choice (``vw_layout``) is marked.
B10 runs over 3 and 20,000 random rows of w=256 bytes, at 1, 2 and 4
row groups a warp for the large scan.  ``--wrappers`` times only the
public wrappers -- B9 at m=64 and m=2^14 on the three chunks and over
all the corpus's chunks in turn (one pass of the main path), B10 over 3
and 20,000 rows -- and the launch floor (``torch.cuda._sleep(0)``),
using the package under ``--root`` (a checkout; this one by default),
so that two trees can be timed in turns on one card.  Without a CUDA
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

CHUNK = 256
SEED = 2                               # chip_smoke.py's VW_SEED
M_SWEEP = (64, 128, 256, 512, 1024, 1 << 14)
M_MAIN = (64, 1 << 14)                 # VW_EQUAL, VW_WIDE
SWEEP_SMEM = 128 << 10
DESIGNS = {0: "lanes G=", 1: "slice mb="}
HAM_W, HAM_ROWS = 256, (3, 20_000)     # k=256, b=8; typical and full scan


def corpus_chunks(torch, dev):
    """[(name, (ids, ones, nnz))] of every length-sorted chunk of the
    corpus on the card, and the names of the middle, widest full and
    last one."""
    from repro_torch.data.hashed_dataset import _length_sorted_chunks
    from repro_torch.data.packing import pad_rows
    from repro_torch.data.synth_rcv1 import SynthRcv1Config, generate_arrays
    cfg = SynthRcv1Config(seed=11, topic_tokens=150, background_frac=0.35,
                          max_pairs_per_doc=4000, max_triples_per_doc=2000)
    rows, _ = generate_arrays(20_000, cfg)
    out = []
    for sel in _length_sorted_chunks(rows, CHUNK):
        idx, nnz = pad_rows([rows[i] for i in sel])
        idx = torch.from_numpy(idx).to(dev)
        out.append((f"rows={len(sel)} nnz_sum={int(nnz.sum())} "
                    f"pad={idx.shape[1]}", (
                        idx, torch.ones(idx.shape, dtype=torch.float32,
                                        device=dev),
                        torch.from_numpy(nnz).to(dev))))
    picks = {"middle": out[len(out) // 2], "widest full": out[-2],
             "last": out[-1]}
    return out, [(f"{k} {name}", c) for k, (name, c) in picks.items()]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None, help="write the times here")
    ap.add_argument("--wrappers", action="store_true",
                    help="time only the public wrappers and the floor")
    ap.add_argument("--root", default=ROOT,
                    help="checkout whose src/repro_torch to time")
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    import chip_smoke as cs      # puts this checkout's src on the path
    sys.path.insert(0, os.path.join(os.path.abspath(args.root), "src"))
    import torch
    if not torch.cuda.is_available():
        print("sweep_vw_sketch: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import hamming as hd
    from repro_torch.kernels import vw_sketch as vw

    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    rows = []

    def note(kernel, shape, layout, ms, ok, chosen):
        rows.append(dict(kernel=kernel, shape=shape, layout=layout, ms=ms,
                         ok=ok, chosen=chosen))
        print(f"{kernel} {shape} {layout} ms={ms} ok={ok}"
              f"{' (chosen)' if chosen else ''} card={card}", flush=True)
        if not ok:
            raise RuntimeError(f"{kernel} {shape} {layout} is wrong")

    def same(got, want) -> bool:
        return torch.equal(got.view(torch.int32), want.view(torch.int32))

    note("launch_floor", "_sleep(0)", "",
         cs.time_ms(torch, lambda: torch.cuda._sleep(0), 500), True, False)
    every, picked = corpus_chunks(torch, dev)
    for shape, (idx, ones, nnz) in picked:
        n, mx = idx.shape
        for m in (M_MAIN if args.wrappers else M_SWEEP):
            want = vw.vw_sketch_plain(idx, ones, nnz, m, seed=SEED)
            fn = lambda: vw.vw_sketch(idx, ones, nnz, m, seed=SEED)
            note("vw_sketch", f"{shape} m={m}", "wrapper",
                 cs.time_ms(torch, fn, 200), same(fn(), want), True)
            if args.wrappers:
                continue
            note("zeros", f"{shape} m={m}", "torch.zeros", cs.time_ms(
                torch, lambda: torch.zeros((n, m), device=dev), 200),
                True, False)
            chosen = vw.vw_layout(n, mx, m)
            layouts = [(vw.LANES, g) for g in (32, 64, 128, 256, 512)
                       if 4 * m * g <= SWEEP_SMEM]
            layouts += [(vw.SLICE, mb) for mb in (256, 1024, 2048, 4096,
                                                  8192, 16384) if mb <= m]
            for design, param in layouts:
                fn = lambda: vw._launch(idx, ones, nnz, m, SEED, design,
                                        param)
                note("vw_sketch", f"{shape} m={m}",
                     f"{DESIGNS[design]}{param}",
                     cs.time_ms(torch, fn, 200), same(fn(), want),
                     (design, param) == chosen)
    if args.wrappers:
        for m in M_MAIN:
            def one_pass():
                for _, (idx, ones, nnz) in every:
                    vw.vw_sketch(idx, ones, nnz, m, seed=SEED)
            note("vw_sketch", f"all {len(every)} chunks m={m}", "wrapper",
                 cs.time_ms(torch, one_pass, 5, warmup=1), True, True)
    rng = np.random.default_rng(0)
    table = torch.from_numpy(rng.integers(
        0, 256, size=(max(HAM_ROWS), HAM_W)).astype(np.uint8)).to(dev)
    query = table[7].clone()
    for n in HAM_ROWS:
        cands = table[:n].clone()
        want = hd.hamming_distance_plain(query, cands)
        fn = lambda: hd.hamming_distance(query, cands)
        note("hamming_distance", f"n={n} w={HAM_W}", "wrapper",
             cs.time_ms(torch, fn, 500), torch.equal(fn(), want), True)
        if args.wrappers or n < 1000:
            continue
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        chosen = hd.hamming_layout(n, HAM_W, 16, sms)
        for reps in (1, 2, 4):
            lanes = chosen[0]
            warps = -(-n // (32 // lanes) // reps)
            per_block = min(hd.WARPS_PER_BLOCK, warps)
            layout = (lanes, reps, 32 * per_block, -(-warps // per_block))
            fn = lambda: hd._launch(query, cands, 16, layout)
            note("hamming_distance", f"n={n} w={HAM_W}",
                 f"lanes={lanes} reps={reps}", cs.time_ms(torch, fn, 500),
                 torch.equal(fn(), want), layout == chosen)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"card": card, "root": args.root, "rows": rows}, f,
                      indent=1)
    print(f"card: {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
