#!/usr/bin/env python3
"""Times the kernels of every serving micro-batch, the minwise and OPH
encodes and packs (B1, ``minhash_pack``; B2, ``oph_pack``) and the
packed forward (B5, ``bbit_linear_packed_fwd``), over the launch layouts
their wrappers choose from, on one NVIDIA GPU, at the serving engine's
shapes.

    python3 scripts/sweep_serving_kernels.py [--out sweep.json]
    python3 scripts/sweep_serving_kernels.py --wrappers [--root DIR] [--out f]

The shapes are ``chip_smoke.py``'s: its 384 synthetic expanded-rcv1
documents (seed 0), the engine's row buckets 1 and 64 (``serve.py``'s
``(1, max_batch)`` without a profile) and its lanes of 2,048 and 8,192
ids (``lane_batch``: real documents of each lane, padded to the lane),
k=256, b=8, C=1 (``configs/rcv1_oph.py``).  B1 runs at each hash lanes
a thread, lanes a block and warps a block, and at the wrapper's layout
with scalar id loads, also at 1,024 rows (the 64 rows of the 8,192 lane
tiled), where many waves of blocks give its loop's rate; every result
held to ``minhash_pack_plain`` byte for byte; the instruction mix of B1
is counted from ``cuobjdump -sass`` of the built library.  B2 runs at
each threads a block (a block a row), with 16-byte and with scalar id
loads, every result held to ``oph_pack_plain`` byte for byte; B5 on the codes B2 makes, at each
rows a block, with and without one load a lane's codes, every result
allclose (1e-5) to ``bbit_linear_packed_fwd_plain`` and the same bits
on two calls, beside ``embedding_bag`` of the same sum; the wrappers'
own choices are marked.  The launch floor is timed first:
``torch.cuda._sleep(0)``, and an empty kernel with B2's arguments
launched through the port's ctypes path at the grid, block and shared
memory of each design (``csrc/launch_floor.cu``).

``--wrappers`` times only the public wrappers (B1, also at 1,024 rows;
B2 with and without densify; B5 with and without the empty mask) at the
four shapes, and
the floors, using the package under ``--root`` (a checkout; this one by
default), so that two trees can be timed in turns on one card.  Without
a CUDA device it exits non-zero.
"""
from __future__ import annotations

import argparse
import collections
import json
import os
import re
import shutil
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

ROW_BUCKETS = (1, 64)             # launch/serve.py without a profile
B5_ROWS = (1, 64, 1024)           # serving's buckets, stream_batch
B2_THREADS = (128, 256, 512, 1024)
B5_ROWS_A_BLOCK = (1, 2, 4, 8)
B1_LANES_A_THREAD = (1, 2, 4, 8)
B1_LANES_A_BLOCK = (1, 2, 4, 8, 16, 32, 64, 256)
B1_WARPS = (2, 4, 8, 16)
B1_STEADY_ROWS = 1024             # the 64 rows of the 8,192 lane, tiled
ITERS = 500
B1_OPS = ("IMAD", "IMAD.HI.U32", "SHF.R.U32.HI", "LOP3.LUT", "VIMNMX.U32",
          "VIMNMX3.U32", "IMNMX.U32", "LDG.E.128.CONSTANT", "LDS",
          "LDS.128")


def sass_counts(lib_path: str, kernel: str) -> dict:
    """{function: {opcode: count}} of the functions of the library whose
    name holds ``kernel``, from ``cuobjdump -sass`` ({} without it)."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        return {}
    text = subprocess.run([tool, "-sass", lib_path], capture_output=True,
                          text=True, check=True).stdout
    out = {}
    for body in text.split("Function : ")[1:]:
        name = body.split("\n", 1)[0].strip()
        if kernel not in name:
            continue
        ops = collections.Counter()
        for line in body.splitlines():
            hit = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(@!?U?P\w+\s+)?"
                           r"([A-Z][A-Z0-9_.]*)", line)
            if hit:
                ops[hit.group(2)] += 1
        out[name] = dict(ops)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None, help="write the times here")
    ap.add_argument("--wrappers", action="store_true",
                    help="time only the public wrappers and the floors")
    ap.add_argument("--root", default=ROOT,
                    help="checkout whose src/repro_torch to time")
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    import chip_smoke as cs      # puts this checkout's src on the path
    sys.path.insert(0, os.path.join(os.path.abspath(args.root), "src"))
    import torch
    if not torch.cuda.is_available():
        print("sweep_serving_kernels: no CUDA device", file=sys.stderr)
        return 2
    import torch.nn.functional as F
    from repro_torch.core.bbit import unpack_codes_torch
    from repro_torch.core.oph import OPHHash
    from repro_torch.core.universal_hash import MultiplyShiftHash
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
    ma, mb = MultiplyShiftHash.make(k, 1).params(dev)
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
        if hasattr(fe, "minhash_pack_layout"):
            for n in ROW_BUCKETS:
                for lane in cs.NNZ_BUCKETS:
                    lpt, lt, w = fe.minhash_pack_layout(n, k, bits,
                                                        _build.sm_count(0))
                    geoms.append(("B1", n, n * -(-k // (lpt * lt)), 32 * w,
                                  4 * lpt * lt * (w + 1)))
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

    # B1 at each shape, and at 1,024 rows, where many waves of blocks give
    # the loop's rate: the wrapper, then (not with --wrappers) each hash
    # lanes a thread, lanes a block and warps a block, and scalar loads
    b1_shapes = dict(batches)
    idx, nnz = batches[(max(ROW_BUCKETS), max(cs.NNZ_BUCKETS))]
    reps = -(-B1_STEADY_ROWS // idx.shape[0])
    b1_shapes[(B1_STEADY_ROWS, max(cs.NNZ_BUCKETS))] = (
        idx.repeat(reps, 1)[:B1_STEADY_ROWS].contiguous(),
        nnz.repeat(reps)[:B1_STEADY_ROWS].contiguous())
    for (n, lane), (idx, nnz) in b1_shapes.items():
        shape = f"rows={n} lane={lane} nnz_sum={int(nnz.sum())}"
        iters = ITERS if n <= max(ROW_BUCKETS) else 20
        if n <= max(ROW_BUCKETS):
            want = fe.minhash_pack_plain(idx, nnz, ma, mb, bits=bits)
        else:   # the 64 rows' codes, tiled as the rows are
            want = want.repeat(reps, 1)[:n].contiguous()
        fn = lambda: fe.minhash_pack(idx, nnz, ma, mb, bits=bits)
        note("minhash_pack", shape, "wrapper", timed(fn, iters),
             torch.equal(fn(), want), True)
        if args.wrappers:
            continue
        chosen = fe.minhash_pack_layout(n, k, bits, _build.sm_count(0))
        vec0 = fe.oph_pack_vec(lane, idx.data_ptr())
        designs = [(lpt, lanes // lpt, w, vec0) for lpt in B1_LANES_A_THREAD
                   for lanes in B1_LANES_A_BLOCK for w in B1_WARPS
                   if lpt <= lanes <= 32 * lpt and lanes * bits % 8 == 0]
        designs += [(*chosen, False)] if vec0 else []
        for lpt, lt, w, vec in designs:
            fn = lambda: fe._minhash_pack_launch(idx, nnz, ma, mb, bits, lpt,
                                                 lt, w, vec)
            note("minhash_pack", shape,
                 f"lanes_a_thread={lpt} threads={lt} warps={w} vec={vec}",
                 timed(fn, iters), torch.equal(fn(), want),
                 (lpt, lt, w, vec) == (*chosen, vec0))
    lib = _build.library_path("fused_encode")
    for name, ops in sass_counts(str(lib), "minhash_pack_kernel").items():
        print(f"sass: {name}: {sum(ops.values())} instructions; "
              + " ".join(f"{op}={ops.get(op, 0)}" for op in B1_OPS)
              , flush=True)
        rows.append(dict(kernel="minhash_pack", shape="sass", layout=name,
                         ms=None, ok=True, chosen=False, sass=ops))

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
