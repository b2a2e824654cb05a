#!/usr/bin/env python3
"""Times the two kernels of every serving micro-batch, the OPH encode
and pack (B2, ``oph_pack``) and the packed forward (B5,
``bbit_linear_packed_fwd``), over the launch layouts their wrappers
choose from, on one NVIDIA GPU, at the serving engine's shapes.

    python3 scripts/sweep_serving_kernels.py [--out sweep.json]
    python3 scripts/sweep_serving_kernels.py --wrappers [--root DIR] [--out f]

The shapes are ``chip_smoke.py``'s: its 384 synthetic expanded-rcv1
documents (seed 0), the engine's row buckets 1 and 64 (``serve.py``'s
``(1, max_batch)`` without a profile) and its lanes of 2,048 and 8,192
ids (``lane_batch``: real documents of each lane, padded to the lane),
k=256, b=8, C=1 (``configs/rcv1_oph.py``).  B2 runs at each threads a
block (a block a row), with 16-byte and with scalar id loads, every result held to
``oph_pack_plain`` byte for byte; B5 on the codes B2 makes, at each
rows a block, with and without one load a lane's codes, every result
allclose (1e-5) to ``bbit_linear_packed_fwd_plain`` and the same bits
on two calls, beside ``embedding_bag`` of the same sum; the wrappers'
own choices are marked.  The launch floor is timed first:
``torch.cuda._sleep(0)``, and an empty kernel with B2's arguments
launched through the port's ctypes path at the grid, block and shared
memory of each design (``csrc/launch_floor.cu``).

``--wrappers`` times only the public wrappers (B2 with and without
densify, B5 with and without the empty mask) at the four shapes, and
the floors, using the package under ``--root`` (a checkout; this one by
default), so that two trees can be timed in turns on one card.  Without
a CUDA device it exits non-zero.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

ROW_BUCKETS = (1, 64)             # launch/serve.py without a profile
B5_ROWS = (1, 64, 1024)           # serving's buckets, stream_batch
B2_THREADS = (128, 256, 512, 1024)
B5_ROWS_A_BLOCK = (1, 2, 4, 8)
ITERS = 500


def load_chip_smoke():
    """``chip_smoke.py`` of this checkout as a module (its corpus, lane
    batches, timer and constants); it imports no package at load."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None, help="write the times here")
    ap.add_argument("--wrappers", action="store_true",
                    help="time only the public wrappers and the floors")
    ap.add_argument("--root", default=ROOT,
                    help="checkout whose src/repro_torch to time")
    args = ap.parse_args()
    cs = load_chip_smoke()       # puts this checkout's src on the path
    sys.path.insert(0, os.path.join(os.path.abspath(args.root), "src"))
    import torch
    if not torch.cuda.is_available():
        print("sweep_serving_kernels: no CUDA device", file=sys.stderr)
        return 2
    import torch.nn.functional as F
    from repro_torch.core.bbit import unpack_codes_torch
    from repro_torch.core.oph import OPHHash
    from repro_torch.kernels import _build
    from repro_torch.kernels import bbit_linear as bl
    from repro_torch.kernels import fused_encode as fe

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

    def timed(fn, iters=ITERS):
        return cs.time_ms(torch, fn, iters)

    note("launch_floor", "_sleep(0)", "", timed(lambda: torch.cuda._sleep(0)),
         True, False)
    k, bits = cs.K, cs.B
    oa, ob = OPHHash.make(k, 1).params(dev)
    gen = torch.Generator().manual_seed(0)
    table = (0.01 * torch.randn((k, 1 << bits, 1), generator=gen)).to(dev)
    docs = cs.make_corpus(cs.DOCS, seed=0)
    batches = {}
    for lane in cs.NNZ_BUCKETS:
        idx, nnz, _ = cs.lane_batch(torch, dev, docs, lane)
        for n in ROW_BUCKETS:
            batches[(n, lane)] = (idx[:n].contiguous(), nnz[:n].contiguous())

    if "launch_floor" in _build.SIGNATURES:
        floor = _build.load("launch_floor")
        ptr = batches[(1, cs.NNZ_BUCKETS[0])][0].data_ptr()
        smem = 4 * (k + -(-k // 32))
        # (kernel, rows, blocks, threads, shared memory) of each design
        geoms = [("B5", n, -(-n // rows_), 32 * rows_, 0) for n in B5_ROWS
                 for rows_ in ((bl.packed_fwd_layout(
                     n, _build.sm_count(0)),) if args.wrappers
                     else B5_ROWS_A_BLOCK)]
        geoms += [("B2", n, n, threads, smem) for n in ROW_BUCKETS
                  for threads in sorted({fe.oph_pack_layout(lane, k)
                                         for lane in cs.NNZ_BUCKETS})]
        stream = _build.stream(batches[(1, cs.NNZ_BUCKETS[0])][0])
        for name, n, blocks, threads, sm in geoms:
            def empty():
                code = floor.repro_empty_launch(
                    ptr, ptr, ptr, ptr, ptr, ptr, blocks, threads, sm, 0,
                    stream)
                _build.check("launch_floor", code, "empty kernel")
            note("launch_floor", f"empty kernel as {name} n={n}",
                 f"grid={blocks} threads={threads} smem={sm}",
                 timed(empty), True, False)

    # B2 at each shape, and the codes B5 runs on
    codes_of = {}
    for (n, lane), (idx, nnz) in batches.items():
        shape = f"rows={n} lane={lane} nnz_sum={int(nnz.sum())}"
        for densify in ((True, False) if args.wrappers else (True,)):
            want = fe.oph_pack_plain(idx, nnz, oa, ob, k=k, bits=bits,
                                     densify=densify)
            fn = lambda: fe.oph_pack(idx, nnz, oa, ob, k=k, bits=bits,
                                     densify=densify)
            got = fn()
            note("oph_pack", f"{shape} densify={densify}", "wrapper",
                 timed(fn), torch.equal(got[0], want[0])
                 and torch.equal(got[1], want[1]), True)
            if densify:
                codes_of[(n, lane)] = want[0]
        if args.wrappers:
            continue
        chosen = (fe.oph_pack_layout(lane, k),
                  fe.oph_pack_vec(lane, idx.data_ptr()))
        for threads in B2_THREADS:
            for vec in (True, False):
                if vec and not fe.oph_pack_vec(lane, idx.data_ptr()):
                    continue
                fn = lambda: fe._oph_pack_launch(idx, nnz, oa, ob, k, bits,
                                                 True, threads, vec)
                got = fn()
                note("oph_pack", f"{shape} densify=True",
                     f"threads={threads} vec={vec}", timed(fn),
                     torch.equal(got[0], want[0])
                     and torch.equal(got[1], want[1]),
                     (threads, vec) == chosen)

    # B5 on B2's codes of the 8192 lane, repeated to 1,024 rows (the
    # packed gradient's stream_batch)
    base = codes_of[(max(ROW_BUCKETS), max(cs.NNZ_BUCKETS))]
    for n in B5_ROWS:
        packed = base.repeat(-(-n // base.shape[0]), 1)[:n].contiguous()
        flags = torch.rand((n, k), generator=gen) < 0.3
        empty = torch.from_numpy(np.packbits(flags.numpy(), axis=1)).to(dev)
        codes = unpack_codes_torch(packed, k, bits)
        flat = torch.arange(k, device=dev)[None, :] * (1 << bits) + codes
        weight2d = table.view(k * (1 << bits), 1)
        note("embedding_bag", f"rows={n}", "library", timed(
            lambda: F.embedding_bag(flat, weight2d, mode="sum")), True,
            False)
        for em in ((None, empty) if args.wrappers else (None,)):
            want = bl.bbit_linear_packed_fwd_plain(packed, table, k=k,
                                                   bits=bits, empty=em)
            fn = lambda: bl.bbit_linear_packed_fwd(packed, table, k=k,
                                                   bits=bits, empty=em)
            got, again = fn(), fn()
            note("bbit_linear_packed_fwd",
                 f"rows={n} k={k} b={bits} mask={em is not None}", "wrapper",
                 timed(fn), torch.allclose(got, want, rtol=1e-5, atol=1e-5)
                 and torch.equal(got, again), True)
        if args.wrappers:
            continue
        vec_ok = bl.packed_fwd_vec(bits, packed.shape[1], packed.data_ptr())
        chosen = (bl.packed_fwd_layout(n, _build.sm_count(0)), vec_ok)
        for rows_ in B5_ROWS_A_BLOCK:
            for vec in (True, False):
                if vec and not vec_ok:
                    continue
                fn = lambda: bl._packed_fwd_launch(packed, table, k, bits,
                                                   None, rows_, vec)
                got, again = fn(), fn()
                note("bbit_linear_packed_fwd", f"rows={n} k={k} b={bits}",
                     f"rows_a_block={rows_} vec={vec}", timed(fn),
                     torch.allclose(got, want, rtol=1e-5, atol=1e-5)
                     and torch.equal(got, again), (rows_, vec) == chosen)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"card": card, "root": args.root, "rows": rows}, f,
                      indent=1)
    print(f"card: {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
