#!/usr/bin/env python3
"""Times the b-bit linear layer's dW kernels and widened forward on one
NVIDIA GPU over the launch layouts their wrappers choose from, beside the
one-call PyTorch yardsticks: B6 (dW from packed codes) at the packed
gradient's shapes, B7 (forward) and B8 (dW) from widened codes at the
TRON fits' shapes.

    python3 scripts/sweep_bbit_linear.py [--out sweep.json]
    python3 scripts/sweep_bbit_linear.py --wrappers [--root DIR] [--out f]
    python3 scripts/sweep_bbit_linear.py --stages [--out f]
    python3 scripts/sweep_bbit_linear.py --slices [--out f]

B6 runs on ``chip_smoke.py``'s train corpus (20,000 synthetic documents,
seed 11): the minwise codes of ``preprocess_rows`` (k=256, b=8, hash
seed 1) of its first 1,024 rows (the stream batch) and 16,000 rows (the
training rows), packed, without a mask, and the ``oph_zero`` encode of
the same rows with its empty mask; dout normal (numpy seed 0), C=1,
V=256.  Two inputs more at 1,024 rows bracket the sum over rows that
share a code: every row the same code in every bin, and every code of a
32-row group different.  Before any timing, numpy counts on the host how
the train corpus's codes (minwise, oph, oph_zero) share values within the
32-row groups a warp of B6 takes.  B6 runs at each warps a block and
blocks a cluster along the rows (``_packed_dw_launch``), its result held
within 1e-5 of each bin's sum of absolute terms of the plain version and
the same bits on two calls; ``packed_dw_layout``'s choice is marked;
``torch.bincount`` of the same sum beside it.  B7 and B8 run on 16,000
rows of random codes (numpy seed 0) at k=256, V=256 and k=500, V=65536,
C=1: B7 at each bin group (``_fwd_launch``), B8's plan kernel and its sum
at each span of values a block (``_dw_sum_launch``), and
``bbit_linear_bwd_dw`` with its cached plan, each held to its plain
version (B7 within 1e-5 of each row's sum of absolute terms).  Then B7
at the paper's width, k=500 over V=65536 with uniform random codes, at
16,000, 65,536, 98,304, 114,688, 135,480 and 541,919 rows (the smoke
test's training rows; n = V, 1.5V and 1.75V, about ``fwd_slices``'
crossover; the TRON cell's test and training sets): one pass and each
bin-slice width (32-160 bins a slice for a float32 table, 64-320 for
bfloat16), each the one pass's bits, ``fwd_slices``' width marked and
printed, with the gathers a second; beside them the control, one pass
over a V=4096 table (8.2 MB, inside L2) at the same rows.  ``--slices``
runs only that part.

``--wrappers`` times only B6's public wrapper at its six inputs, beside
``torch.bincount``, and the device time of each kernel one call of it
launches (``torch.profiler``), using the package under ``--root`` (a
checkout; this one by default), so that two trees can be timed in turns
on one card.  ``--stages`` builds this checkout's ``csrc/bbit_linear.cu``
once more with ``-DREPRO_DW_STAGES`` (a library apart, under the build
directory) and runs B6 through it at each of the six inputs, at the
layout the wrapper picks: each block's ``clock64`` at the kernel's stage
marks (set up, rows staged, groups summed, warps merged, cluster barrier
passed, dW stored, last barrier passed), and the global timer at its
start and end, printed as the median and largest over the blocks in µs
at the card's maximum SM clock, beside the call's time when queued back
to back and the span from the first block's start to the last one's
end.  The calls are timed as ``chip_smoke.py`` times them.  Without a
CUDA device it exits non-zero.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

N = 16_000
SHAPES = ((256, 8), (500, 16))      # (k, b): configs/rcv1_oph, rcv1_bbit
B6_ROWS = (1024, 16_000)            # stream_batch, the training rows
B6_WARPS = (1, 2, 4, 8, 16)
B6_PARTS = (1, 2, 4, 8)
GROUP = 32                          # rows a warp of B6 takes at once
# B6's stage marks (csrc/bbit_linear.cu, DW_MARK), in order
STAGES = ("set up", "rows staged", "groups summed", "warps merged",
          "cluster barrier", "dW stored", "last barrier")
PROBE_MARKS = 10                    # int64 a block: 7 marks, 8 start, 9 end
# B7's bin slices: the smoke test's training rows, V, 1.5V and 1.75V rows
# (about the crossover), the TRON cell's test and training rows; bins a
# slice by table type; the control's V
SLICE_ROWS = (16_000, 65_536, 98_304, 114_688, 135_480, 541_919)
SLICE_WIDTHS = {"float32": (32, 64, 96, 128, 160),
                "bfloat16": (64, 128, 192, 256, 320)}
CONTROL_V = 4096


def within(got, want, scale) -> bool:
    return bool(((got - want).abs() <= 1e-5 * scale + 1e-6).all())


def shared_codes(codes: np.ndarray, drop=None) -> dict:
    """How the (n, k) codes share values within each 32-row group of a
    bin (rows in ``drop`` (n, k) left out): the share of (group, bin)
    pairs where two rows share a code, the mean share of a group's rows
    whose code another row holds, the mean largest number of rows that
    hold one code, and the share of pairs where all 32 rows hold one."""
    n, k = codes.shape
    g = n // GROUP
    c = codes[:g * GROUP].reshape(g, GROUP, k).transpose(0, 2, 1)
    c = c.reshape(g * k, GROUP).astype(np.int64)
    if drop is not None:
        d = drop[:g * GROUP].reshape(g, GROUP, k).transpose(0, 2, 1)
        c = np.where(d.reshape(g * k, GROUP), -1 - np.arange(GROUP), c)
    s = np.sort(c, axis=1)
    same = s[:, 1:] == s[:, :-1]
    shared = np.zeros_like(s, dtype=bool)
    shared[:, 1:] |= same
    shared[:, :-1] |= same
    run = np.ones(len(s), np.int64)
    cur = np.ones(len(s), np.int64)
    for i in range(1, GROUP):
        cur = np.where(same[:, i - 1], cur + 1, 1)
        run = np.maximum(run, cur)
    return {"pairs": int(len(s)),
            "any_shared": float(same.any(axis=1).mean()),
            "rows_shared": float(shared.mean()),
            "largest_run": float(run.mean()),
            "all_one_code": float((run == GROUP).mean())}


def stage_probe(_build, dev):
    """B6 built with its stage marks (-DREPRO_DW_STAGES) into the build
    directory → run(packed, dout, empty, k, bits, v, warps, parts, vec)
    → (dW, (blocks, 10) int64 marks of that launch)."""
    import ctypes
    import torch
    out = _build.build_dir() / "bbit_linear_stages.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS,
                    "-DREPRO_DW_STAGES", "-o", str(out),
                    str(_build.CSRC / "bbit_linear.cu")], check=True,
                   capture_output=True)
    lib = ctypes.CDLL(str(out))
    launch = lib.repro_bbit_linear_packed_bwd_dw
    launch.argtypes = _build.SIGNATURES["bbit_linear"][
        "repro_bbit_linear_packed_bwd_dw"]
    launch.restype = ctypes.c_int
    lib.repro_bbit_linear_dw_stages.argtypes = [ctypes.c_void_p,
                                                ctypes.c_int]
    lib.repro_bbit_linear_dw_stages.restype = ctypes.c_int

    def call(packed, dout, empty, k, bits, v, warps, parts, vec):
        n, c = dout.shape
        got = torch.empty((k, v, c), dtype=torch.float32, device=dev)
        code = launch(packed.data_ptr(),
                      None if empty is None else empty.data_ptr(),
                      dout.data_ptr(), got.data_ptr(), n, k, bits, v, c,
                      packed.shape[1],
                      0 if empty is None else empty.shape[1], warps, parts,
                      int(vec), 0, dev.index, _build.stream(packed))
        if code:
            raise RuntimeError(f"B6 stage probe: CUDA error {code}")
        return got

    def run(*args):
        got = call(*args)
        torch.cuda.synchronize()
        k, parts = args[3], args[7]
        blocks = -(-k // 8) * parts
        marks = np.zeros((blocks, PROBE_MARKS), np.int64)
        code = lib.repro_bbit_linear_dw_stages(marks.ctypes.data, blocks)
        if code:
            raise RuntimeError(f"B6 stage probe: CUDA error {code}")
        return got, marks

    return call, run


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None, help="write the times here")
    ap.add_argument("--wrappers", action="store_true",
                    help="time only B6's public wrapper")
    ap.add_argument("--stages", action="store_true",
                    help="B6's stage marks at the wrapper's layouts")
    ap.add_argument("--slices", action="store_true",
                    help="only B7's bin slices at the paper's width")
    ap.add_argument("--root", default=ROOT,
                    help="checkout whose src/repro_torch to time")
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    import chip_smoke as cs      # puts this checkout's src on the path
    sys.path.insert(0, os.path.join(os.path.abspath(args.root), "src"))
    import torch
    if not torch.cuda.is_available():
        print("sweep_bbit_linear: no CUDA device", file=sys.stderr)
        return 2
    import torch.nn.functional as F
    from torch.autograd import DeviceType
    from repro_torch.core.bbit import (pack_codes, unpack_codes_torch,
                                       unpack_mask_torch)
    from repro_torch.core.schemes import make_scheme
    from repro_torch.data.hashed_dataset import preprocess_rows
    from repro_torch.data.packing import pad_rows
    from repro_torch.kernels import _build
    from repro_torch.kernels import bbit_linear as bl

    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    rng = np.random.default_rng(0)
    rows = []

    def note(kernel, shape, layout, ms, ok, chosen, **extra):
        rows.append(dict(kernel=kernel, shape=shape, layout=layout, ms=ms,
                         ok=ok, chosen=chosen, **extra))
        more = "".join(f" {key}={val}" for key, val in extra.items())
        print(f"{kernel} {shape} {layout} ms={ms} ok={ok}{more}"
              f"{' (chosen)' if chosen else ''} card={card}", flush=True)
        if not ok:
            raise RuntimeError(f"{kernel} {shape} {layout} is wrong")

    def timed(fn, iters):
        return cs.time_ms(torch, fn, iters)

    if args.slices:
        b7_slices(torch, bl, _build, dev, note, timed)
        return finish(args, card, rows)

    # B6's inputs: the train corpus's codes, and the two brackets
    k, b = cs.K, cs.B
    v = 1 << b
    corpus, _ = cs.make_train_corpus()
    docs = corpus[:max(B6_ROWS)]
    codes = {s: preprocess_rows(docs, k=k, b=b, scheme=s, seed=cs.HASH_SEED,
                                chunk=cs.PREPROCESS_CHUNK, device=dev)
             for s in ("minwise", "oph")}
    zero = make_scheme("oph_zero", k, cs.HASH_SEED)
    zp, ze = [], []
    for lo in range(0, len(docs), cs.PREPROCESS_CHUNK):
        idx, nnz = pad_rows(docs[lo:lo + cs.PREPROCESS_CHUNK])
        p, e = zero.encode_packed(torch.from_numpy(idx).to(dev),
                                  torch.from_numpy(nnz).to(dev), b)
        zp.append(p)
        ze.append(e)
    zero_packed, zero_empty = torch.cat(zp), torch.cat(ze)
    zero_codes = unpack_codes_torch(zero_packed, k, b).cpu().numpy()
    zero_drop = unpack_mask_torch(zero_empty, k).cpu().numpy()
    for n in B6_ROWS:
        for name, c, drop in (("minwise", codes["minwise"], None),
                              ("oph", codes["oph"], None),
                              ("oph_zero", zero_codes, zero_drop)):
            count = shared_codes(c[:n], None if drop is None else drop[:n])
            print(f"shared codes: {name} n={n} k={k} b={b}: "
                  + " ".join(f"{key}={val}" for key, val in count.items()),
                  flush=True)
            rows.append(dict(kernel="shared_codes", shape=f"{name} n={n}",
                             **count))

    inputs = []
    for n in B6_ROWS:
        packed = torch.from_numpy(pack_codes(
            codes["minwise"][:n].astype(np.uint16), b)).to(dev)
        inputs.append((f"n={n} minwise", packed, None))
        inputs.append((f"n={n} oph_zero mask", zero_packed[:n].contiguous(),
                       zero_empty[:n].contiguous()))
    n0 = B6_ROWS[0]
    same = np.zeros((n0, k), np.uint16)
    spread = (np.arange(n0)[:, None] + np.arange(k)[None, :]) % v
    for name, c in (("same code", same), ("distinct codes", spread)):
        inputs.append((f"n={n0} {name}", torch.from_numpy(
            pack_codes(c.astype(np.uint16), b)).to(dev), None))
    douts = {n: torch.from_numpy(np.random.default_rng(0).normal(
        size=(n, 1)).astype(np.float32)).to(dev) for n in B6_ROWS}
    if args.stages:
        mhz = float(cs.nvidia_smi("clocks.max.sm").split()[0])
        call, run = stage_probe(_build, dev)
        for shape, packed, empty in inputs:
            n = packed.shape[0]
            d = douts[n]
            kw = dict(k=k, bits=b, empty=empty)
            want = bl.bbit_linear_packed_bwd_dw_plain(packed, d, v, **kw)
            scale = bl.bbit_linear_packed_bwd_dw_plain(packed, d.abs(), v,
                                                       **kw)
            warps, parts = bl.packed_dw_layout(n)
            vec = bl.packed_fwd_vec(b, packed.shape[1], packed.data_ptr())
            probe = (packed, d, empty, k, b, v, warps, parts, vec)
            ms = timed(lambda: call(*probe), 200)
            got, marks = run(*probe)
            us = marks[:, :len(STAGES)] / mhz      # cycles → µs
            step = np.diff(us, axis=1, prepend=0.0)
            note("bbit_linear_packed_bwd_dw stages",
                 f"{shape} k={k} V={v} C=1", f"warps={warps} parts={parts}",
                 ms, within(got, want, scale), True,
                 blocks=len(marks),
                 span_us=float(marks[:, 9].max() - marks[:, 8].min()) / 1e3,
                 start_spread_us=float(marks[:, 8].max()
                                       - marks[:, 8].min()) / 1e3,
                 sm_mhz=mhz,
                 **{f"{name} us (median/max)":
                    f"{np.median(step[:, i]):.3f}/{step[:, i].max():.3f}"
                    for i, name in enumerate(STAGES)},
                 block_us=f"{np.median(us[:, -1]):.3f}/{us[:, -1].max():.3f}")
        return finish(args, card, rows)
    for shape, packed, empty in inputs:
        n = packed.shape[0]
        d = douts[n]
        kw = dict(k=k, bits=b, empty=empty)
        want = bl.bbit_linear_packed_bwd_dw_plain(packed, d, v, **kw)
        scale = bl.bbit_linear_packed_bwd_dw_plain(packed, d.abs(), v, **kw)
        flat = (torch.arange(k, device=dev)[None, :] * v
                + unpack_codes_torch(packed, k, b).to(torch.int64))
        if empty is not None:   # a dropped bin lands past the table
            flat = torch.where(unpack_mask_torch(empty, k), k * v, flat)
        flat = flat.reshape(-1)
        w_rep = d[:, 0].repeat_interleave(k)
        note("bincount", f"{shape} k={k} V={v} C=1", "library",
             timed(lambda: torch.bincount(flat, weights=w_rep,
                                          minlength=k * v + 1), 200),
             True, False)
        fn = lambda: bl.bbit_linear_packed_bwd_dw(packed, d, v, **kw)
        got = fn()
        ok = within(got, want, scale) and torch.equal(got, fn())
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(20):
                fn()
            torch.cuda.synchronize()
        per = {}    # device µs a call, by kernel
        for e in prof.key_averages():
            us = float(getattr(e, "self_device_time_total", 0) or 0)
            if us > 0 and e.device_type != DeviceType.CPU:
                per[e.key[:60]] = us / 20
        note("bbit_linear_packed_bwd_dw", f"{shape} k={k} V={v} C=1",
             "wrapper", timed(fn, 200), ok, True,
             kernels_us=json.dumps(per))
        if args.wrappers:
            continue
        chosen = bl.packed_dw_layout(n)
        vec = bl.packed_fwd_vec(b, packed.shape[1], packed.data_ptr())
        for warps in B6_WARPS:
            for parts in B6_PARTS:
                fn = lambda: bl._packed_dw_launch(packed, d, v, k, b, empty,
                                                  warps, parts, vec)
                got = fn()
                ok = within(got, want, scale) and torch.equal(got, fn())
                note("bbit_linear_packed_bwd_dw", f"{shape} k={k} V={v} C=1",
                     f"warps={warps} parts={parts}", timed(fn, 200), ok,
                     (warps, parts) == chosen)
    if args.wrappers:
        return finish(args, card, rows)

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
            fn = lambda: bl._fwd_launch(codes, table, group, k)
            ok = within(fn(), want, scale)
            note("bbit_linear_fwd", shape, f"group={group}",
                 timed(fn, 50), ok, group == chosen)
        flat = torch.arange(k, device=dev)[None, :] * v + codes.to(torch.int64)
        note("embedding_bag", shape, "", timed(lambda: F.embedding_bag(
            flat, table.view(k * v, 1), mode="sum"), 50), True, False)
        del want, scale

        dw_want = bl.bbit_linear_bwd_dw_plain(codes, dout, v)
        dw_scale = bl.bbit_linear_bwd_dw_plain(codes, dout.abs(), v)
        plan = bl.bbit_linear_dw_plan(codes, v)
        note("bbit_linear_dw_plan", shape, f"passes={bl.dw_plan_passes(v)}",
             timed(lambda: bl.bbit_linear_dw_plan(codes, v), 20), True,
             True)
        chosen = bl.dw_sum_span(N, v)
        for span in (32, 64, 128, 256, 512, 1024, 2048):
            if span > v:
                continue
            fn = lambda: bl._dw_sum_launch(plan, dout, v, span)
            ok = within(fn(), dw_want, dw_scale)
            note("bbit_linear_dw_sum", shape, f"span={span}",
                 timed(fn, 50), ok, span == chosen)
        note("bbit_linear_bwd_dw", shape, "cached plan",
             timed(lambda: bl.bbit_linear_bwd_dw(codes, dout, v), 50), True,
             True)
        w_rep = dout[:, 0].repeat_interleave(k)
        flat1 = flat.reshape(-1)
        note("bincount", shape, "", timed(lambda: torch.bincount(
            flat1, weights=w_rep, minlength=k * v), 20), True, False)
        del dw_want, dw_scale, plan, flat, flat1, table
        torch.cuda.empty_cache()
    b7_slices(torch, bl, _build, dev, note, timed)
    return finish(args, card, rows)


def b7_slices(torch, bl, _build, dev, note, timed) -> None:
    """B7 at k=500, V=65536 over each bin-slice width and one pass, at
    ``SLICE_ROWS``, beside one pass over a V=4096 table (the control)."""
    k, v = 500, 1 << 16
    l2 = _build.l2_bytes(dev.index)
    print(f"L2 bytes: {l2}", flush=True)
    for n in SLICE_ROWS:
        gen = torch.Generator(device=dev).manual_seed(n)
        codes = torch.randint(0, v, (n, k), dtype=torch.int32, device=dev,
                              generator=gen)
        for name, widths in SLICE_WIDTHS.items():
            table = torch.randn((k, v, 1), device=dev,
                                generator=gen).to(getattr(torch, name))
            shape = f"n={n} k={k} V={v} C=1 {name}"
            one = bl._fwd_launch(codes, table, k, k)
            chosen = bl.fwd_slices(n, k, v, 1, table.element_size(), l2)
            print(f"fwd_slices {shape}: {chosen} bins a slice", flush=True)
            for width in (*widths, k):
                fn = lambda: bl._fwd_launch(codes, table, k, width)
                ms = timed(fn, 20)
                note("bbit_linear_fwd", shape,
                     "one pass" if width == k else f"slices of {width}", ms,
                     torch.equal(fn().view(torch.int32),
                                 one.view(torch.int32)), width == chosen,
                     gathers_g_per_s=round(n * k / ms / 1e6, 3))
            del table, one
        small = codes.remainder_(CONTROL_V)
        table = torch.randn((k, CONTROL_V, 1), device=dev, generator=gen)
        ms = timed(lambda: bl._fwd_launch(small, table, k, k), 20)
        note("bbit_linear_fwd", f"n={n} k={k} V={CONTROL_V} C=1 float32",
             "one pass (control: the table inside L2)", ms, True, False,
             gathers_g_per_s=round(n * k / ms / 1e6, 3))
        del codes, small, table
        torch.cuda.empty_cache()


def finish(args, card: str, rows: list) -> int:
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"card": card, "root": args.root, "rows": rows}, f,
                      indent=1)
    print(f"card: {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
