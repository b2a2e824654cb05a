#!/usr/bin/env python3
"""Smoke run of the PyTorch port's serving path on one NVIDIA GPU.

    python3 chip_smoke.py [--out results.json]

Phases, one line of output each (or more), any failure exits non-zero:

  build    compile src/repro_torch/csrc/*.cu with nvcc for sm_90a, one
           process per source, all at once;
  kernels  each CUDA kernel against its plain torch version on the card,
           at k=256: minhash_pack (B1) and oph_pack (B2) byte for byte
           over b in {1, 2, 4, 8} and ragged nnz up to 8192 (nnz=0 and
           nnz<k included); bbit_linear_packed_fwd (B5) at b=8, C in
           {1, 4}, with and without the empty mask, allclose 1e-5;
  engine   HashedClassifierEngine at the rcv1_oph width (k=256, b=8, 2
           classes) with seeded random weights, for minwise, oph and
           oph_zero: 384 synthetic expanded-rcv1 documents through
           submit / submit_many with the launch counters set to zero just
           before and read just after; the futures must equal score_docs,
           the plain path on the card (allclose 1e-5) and the host numpy
           encode + numpy scores on a subset; then the engine's documents
           per second over a window of several seconds of submit_many
           passes (median and spread over the passes), and one pass under
           torch.profiler for the device's busy time;
  timing   each kernel at the engine's shapes (64 rows x 2048 / 8192
           lanes of real documents) with CUDA events, its plain version,
           B5's one-call PyTorch yardstick (embedding_bag), and the bound
           (the larger of bytes over 3.35 TB/s and operations over the
           card's rate for their type: int32 for B1 and B2, float32 for
           B5).

The last three lines are the card's name and power limit, one JSON
object describing every kernel, and {"ok": true, "device": {...}}.
Without a CUDA device, or outside a checkout of the repository, it exits
non-zero and prints no result.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

K, B, N_CLASSES = 256, 8, 2          # configs/rcv1_oph.py
ROWS = 64                            # serve_max_batch
NNZ_BUCKETS = (2048, 8192)           # launch/serve.py's lanes
DOCS = 384                           # synthetic documents per scheme
RATE_WINDOW_S = 3.0                  # docs/s: passes over at least this
TOL = dict(rtol=1e-5, atol=1e-5)
# H100 SXM data-sheet peaks: HBM3 bytes/s, and float32 outside the
# tensor cores (B5's adds)
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_OPS_PER_S = 67e12
# 32-bit integer operations issue at 64 per SM per clock on Hopper
# (NVIDIA H100 Tensor Core GPU Architecture white paper, SM section);
# the data sheet has no int32 entry, so the rate is this times the
# card's SM count and its maximum SM clock, both read from the card
INT32_OPS_PER_SM_CLOCK = 64
# 32-bit operations per hash: a*t+b, fmix32's 3 shift-xors and 2
# multiplies, then the min (B1) or the bin shift + atomicMin (B2)
OPS_PER_MINHASH = 1 + 8 + 1
OPS_PER_OPH_HASH = 1 + 8 + 2
KERNELS = {
    "minhash_pack": ("src/repro_torch/csrc/fused_encode.cu",
                     "src/repro/kernels/fused_encode.py:128"),
    "oph_pack": ("src/repro_torch/csrc/fused_encode.cu",
                 "src/repro/kernels/fused_encode.py:271"),
    "bbit_linear_packed_fwd": ("src/repro_torch/csrc/bbit_linear.cu",
                               "src/repro/kernels/bbit_linear.py:277"),
}


def fail(msg: str):
    raise RuntimeError(msg)


def nvidia_smi(query: str) -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
        timeout=60).stdout.strip().splitlines()[0]


def card_line() -> str:
    return nvidia_smi("name,power.limit")


def int32_ops_per_s(torch) -> float:
    """Peak 32-bit integer operations per second of card 0."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    mhz = float(nvidia_smi("clocks.max.sm").split()[0])
    rate = sms * INT32_OPS_PER_SM_CLOCK * mhz * 1e6
    print(f"int32 peak: {sms} SMs x {INT32_OPS_PER_SM_CLOCK}/clock x "
          f"{mhz} MHz = {rate:.4g} ops/s")
    return rate


def time_ms(torch, fn, iters: int) -> float:
    """Device time per call: the calls are queued behind a sleep kernel,
    so the card runs them back to back whatever the host's pace."""
    for _ in range(3):
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


def bound(bytes_: float, ops: float, ops_per_s: float):
    t_bytes = bytes_ / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
def phase_build():
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    took = _build.build()
    print(f"build: {json.dumps({n: round(s, 2) for n, s in took.items()})}"
          f" in {time.perf_counter() - t0:.2f} s")
    for name in _build.SIGNATURES:
        log = _build.library_path(name).with_suffix(".log")
        for line in log.read_text().splitlines() if log.exists() else []:
            if "registers" in line or "Compiling entry" in line:
                print(f"build: {name}: {line.strip()}")


def phase_kernels(torch, dev) -> dict:
    from repro_torch.core.bbit import pack_codes
    from repro_torch.core.oph import OPHHash
    from repro_torch.core.universal_hash import MultiplyShiftHash
    from repro_torch.kernels import bbit_linear as bl
    from repro_torch.kernels import fused_encode as fe

    rng = np.random.default_rng(0)
    m = NNZ_BUCKETS[-1]
    idx = torch.from_numpy(
        rng.integers(0, 1 << 31, size=(ROWS, m)).astype(np.int32)).to(dev)
    nnz_np = rng.integers(1, m + 1, size=ROWS).astype(np.int32)
    nnz_np[:4] = [0, 3, K - 1, m]
    nnz = torch.from_numpy(nnz_np).to(dev)
    errs = {}

    def int_err(got, want):
        return int((got.to(torch.int64) - want.to(torch.int64)).abs().max())

    a, b = MultiplyShiftHash.make(K, 1).params(dev)
    for bits in (1, 2, 4, 8):
        got = fe.minhash_pack(idx, nnz, a, b, bits=bits)
        want = fe.minhash_pack_plain(idx, nnz, a, b, bits=bits)
        torch.cuda.synchronize()
        err = int_err(got, want)
        errs["minhash_pack"] = max(errs.get("minhash_pack", 0), err)
        print(f"kernels: minhash_pack k={K} b={bits} rows={ROWS} "
              f"nnz 0..{m}: bytes equal={err == 0}")
        if err:
            fail(f"minhash_pack b={bits} differs from its plain version")

    oa, ob = OPHHash.make(K, 1).params(dev)
    for bits in (1, 2, 4, 8):
        for densify in (True, False):
            got = fe.oph_pack(idx, nnz, oa, ob, k=K, bits=bits,
                              densify=densify)
            want = fe.oph_pack_plain(idx, nnz, oa, ob, k=K, bits=bits,
                                     densify=densify)
            torch.cuda.synchronize()
            err = max(int_err(got[0], want[0]), int_err(got[1], want[1]))
            errs["oph_pack"] = max(errs.get("oph_pack", 0), err)
            print(f"kernels: oph_pack k={K} b={bits} densify={densify} "
                  f"rows={ROWS} nnz 0..{m}: codes and mask equal="
                  f"{err == 0}")
            if err:
                fail(f"oph_pack b={bits} densify={densify} differs")

    codes = rng.integers(0, 1 << B, size=(ROWS, K)).astype(np.uint16)
    packed = torch.from_numpy(pack_codes(codes, B)).to(dev)
    mask = rng.random((ROWS, K)) < 0.3
    mask[0] = True
    empty = torch.from_numpy(np.packbits(mask, axis=1)).to(dev)
    for c in (1, 4):
        table = torch.from_numpy(
            rng.normal(size=(K, 1 << B, c)).astype(np.float32)).to(dev)
        for em in (None, empty):
            got = bl.bbit_linear_packed_fwd(packed, table, k=K, bits=B,
                                            empty=em)
            again = bl.bbit_linear_packed_fwd(packed, table, k=K, bits=B,
                                              empty=em)
            want = bl.bbit_linear_packed_fwd_plain(packed, table, k=K,
                                                   bits=B, empty=em)
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            errs["bbit_linear_packed_fwd"] = max(
                errs.get("bbit_linear_packed_fwd", 0.0), err)
            ok = torch.allclose(got, want, **TOL)
            print(f"kernels: bbit_linear_packed_fwd k={K} b={B} C={c} "
                  f"mask={em is not None}: max_abs_err={err} "
                  f"allclose(1e-5)={ok} run-to-run equal="
                  f"{torch.equal(got, again)}")
            if not ok or not torch.equal(got, again):
                fail("bbit_linear_packed_fwd differs from its plain version")
    return errs


def make_corpus(n: int, seed: int):
    from repro_torch.data.synth_rcv1 import SynthRcv1Config, generate_arrays
    cfg = SynthRcv1Config(seed=seed, topic_tokens=150, background_frac=0.35,
                          max_pairs_per_doc=3000, max_triples_per_doc=1500)
    rows, _ = generate_arrays(n, cfg)
    return rows


def numpy_scores(scheme, docs, table, bias):
    """Host reference: the numpy encode and a float64 gather-sum."""
    from repro_torch.core.bbit import unpack_codes
    from repro_torch.data.packing import pad_rows
    idx, nnz = pad_rows(docs, pad_to_multiple=1)
    packed, empty = scheme.encode_packed_numpy(idx, nnz, B)
    codes = unpack_codes(packed, K, B).astype(np.int64)
    gathered = table[np.arange(K)[None, :], codes].astype(np.float64)
    if empty is not None:
        gathered[np.unpackbits(empty, axis=1, count=K).astype(bool)] = 0.0
    return gathered.sum(axis=1)[:, 0] + bias[0], packed, empty, idx, nnz


def plain_scores(torch, dev, eng, docs):
    from repro_torch.data.packing import pad_rows
    from repro_torch.kernels import bbit_linear as bl
    from repro_torch.kernels import fused_encode as fe
    a, b = eng.scheme.hash_params(dev)
    params = eng.params
    out = []
    for lo in range(0, len(docs), ROWS):
        idx, nnz = pad_rows(docs[lo: lo + ROWS], pad_to_multiple=1)
        idx = torch.from_numpy(idx).to(dev)
        nnz = torch.from_numpy(nnz).to(dev)
        if eng.scheme.name == "minwise":
            packed = fe.minhash_pack_plain(idx, nnz, a, b, bits=B)
            empty = None
        else:
            packed, empty = fe.oph_pack_plain(idx, nnz, a, b, k=K, bits=B,
                                              densify=eng.scheme.densify)
            empty = None if eng.scheme.densify else empty
        logits = bl.bbit_linear_packed_fwd_plain(packed, params["table"],
                                                 k=K, bits=B, empty=empty)
        out.append((logits + params["bias"])[:, 0].cpu().numpy())
    return np.concatenate(out)


def serve_rate(eng, docs) -> dict:
    """Documents per second of submit_many + flush passes over ``docs``,
    repeated for at least RATE_WINDOW_S seconds: the median and spread of
    the per-pass rates, and the rate of the whole window."""
    rates = []
    t_start = time.perf_counter()
    while time.perf_counter() - t_start < RATE_WINDOW_S or len(rates) < 10:
        t0 = time.perf_counter()
        futs = eng.submit_many(docs)
        eng.flush()
        for f in futs:
            f.result(timeout=300)
        rates.append(len(futs) / (time.perf_counter() - t0))
    seconds = time.perf_counter() - t_start
    p10, med, p90 = (float(x) for x in np.percentile(rates, [10, 50, 90]))
    return {"passes": len(rates), "seconds": seconds,
            "window": len(rates) * len(docs) / seconds, "median": med,
            "p10": p10, "p90": p90, "min": min(rates), "max": max(rates)}


def profile_pass(torch, eng, docs) -> dict:
    """One submit_many pass under torch.profiler: the device time it
    records per op (µs) and the window's wall time.  The profiler slows
    the host, so the share is also taken against an unprofiled pass."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        futs = eng.submit_many(docs)
        eng.flush()
        for f in futs:
            f.result(timeout=300)
        wall_ms = (time.perf_counter() - t0) * 1e3
    ops_us = {}
    for e in prof.key_averages():
        us = float(getattr(e, "self_device_time_total", 0) or 0)
        if us > 0:
            ops_us[e.key[:60]] = us
    return {"wall_ms": wall_ms, "device_ms": sum(ops_us.values()) / 1e3,
            "top": sorted(ops_us.items(), key=lambda kv: -kv[1])[:6]}


def phase_engine(torch, dev, docs, card: str) -> dict:
    from repro_torch.kernels import ops
    from repro_torch.models.linear import BBitLinearConfig, init_bbit_linear
    from repro_torch.serving import HashedClassifierEngine

    cfg = BBitLinearConfig(k=K, b=B, n_classes=N_CLASSES)
    launches = {name: 0 for name in KERNELS}
    docs_per_s, profiles = {}, {}
    for scheme in ("minwise", "oph", "oph_zero"):
        gen = torch.Generator().manual_seed(0)
        params = init_bbit_linear(cfg, gen, device=dev)
        params["bias"] = (0.1 * torch.randn(1, generator=gen)).to(dev)
        with HashedClassifierEngine(params, cfg, seed=1, scheme=scheme,
                                    device=dev, max_batch=ROWS,
                                    nnz_buckets=NNZ_BUCKETS,
                                    row_buckets=(1, ROWS)) as eng:
            half = len(docs) // 2
            ops.reset_counts()
            futs = [eng.submit(d) for d in docs[:half]]
            futs += eng.submit_many(docs[half:])
            eng.flush()
            served = np.asarray([f.result(timeout=300) for f in futs],
                                np.float32)
            direct = eng.score_docs(docs)
            counts = ops.counts()

            encode = "minhash_pack" if scheme == "minwise" else "oph_pack"
            for name in (encode, "bbit_linear_packed_fwd"):
                if counts[name] < 1:
                    fail(f"{scheme}: kernel {name} was not launched")
                launches[name] += counts[name]
            stray = {f"{n}_plain": c.value for n, c in ops.PLAIN.items()
                     if c.value}
            if stray:
                fail(f"{scheme}: the main path left the kernels: {stray}")
            if served.shape != (len(docs),) or not np.isfinite(served).all():
                fail(f"{scheme}: scores not finite or of the wrong shape")
            if not np.array_equal(served, direct):
                fail(f"{scheme}: futures differ from score_docs")
            plain = plain_scores(torch, dev, eng, docs)
            err_plain = float(np.abs(served - plain).max())
            if not np.allclose(served, plain, **TOL):
                fail(f"{scheme}: kernels vs plain path {err_plain}")

            sub = docs[:ROWS]
            table = eng.params["table"].cpu().numpy()
            bias = eng.params["bias"].cpu().numpy()
            ref, ref_packed, ref_empty, idx, nnz = numpy_scores(
                eng.scheme, sub, table, bias)
            packed, empty = eng.scheme.encode_packed(
                torch.from_numpy(idx).to(dev), torch.from_numpy(nnz).to(dev),
                B)
            bytes_equal = np.array_equal(packed.cpu().numpy(), ref_packed) \
                and (empty is None) == (ref_empty is None) \
                and (empty is None
                     or np.array_equal(empty.cpu().numpy(), ref_empty))
            err_ref = float(np.abs(served[:ROWS] - ref).max())
            if not bytes_equal or not np.allclose(served[:ROWS], ref, **TOL):
                fail(f"{scheme}: host numpy reference differs "
                     f"(bytes equal={bytes_equal}, max_abs_err={err_ref})")

            nnz_all = np.array([len(d) for d in docs])
            rate = serve_rate(eng, docs)
            docs_per_s[scheme] = rate
            prof = profile_pass(torch, eng, docs)
            profiles[scheme] = prof
            if prof["device_ms"] > 0:
                pass_ms = len(docs) / rate["median"] * 1e3
                prof["busy_share"] = prof["device_ms"] / pass_ms
                busy = (f"device busy {prof['device_ms']} ms in a profiled "
                        f"pass of {prof['wall_ms']} ms, share of an "
                        f"unprofiled pass ({pass_ms} ms) "
                        f"{prof['busy_share']}; top {prof['top']}")
            else:
                busy = "device busy: not measured (no device time traced)"
            print(f"engine: {scheme} profile: {busy}")
            print(f"engine: {scheme} k={K} b={B} docs={len(docs)} nnz "
                  f"{nnz_all.min()}..{nnz_all.max()} (mean "
                  f"{nnz_all.mean():.0f}) launches={counts[encode]}+"
                  f"{counts['bbit_linear_packed_fwd']} batches="
                  f"{eng.stats()['batches_run']} futures==score_docs "
                  f"vs plain max_abs_err={err_plain} vs numpy host ref "
                  f"max_abs_err={err_ref} bytes equal={bytes_equal} "
                  f"card={card}")
            print(f"engine: {scheme} docs/s over {rate['passes']} passes of "
                  f"{len(docs)} docs in {rate['seconds']} s: median "
                  f"{rate['median']} p10 {rate['p10']} p90 {rate['p90']} "
                  f"min {rate['min']} max {rate['max']} whole window "
                  f"{rate['window']} card={card}")
    return {"launches": launches, "docs_per_s": docs_per_s,
            "profiles": profiles}


def lane_batch(torch, dev, docs, lane):
    """ROWS real documents of one nnz lane, padded to the lane's width."""
    from repro_torch.data.packing import pad_rows
    lo = 0 if lane == NNZ_BUCKETS[0] else NNZ_BUCKETS[0]
    pick = [d for d in docs if lo < len(d) <= lane]
    if not pick:
        fail(f"no document of the corpus falls in the {lane} lane")
    rows = [pick[i % len(pick)] for i in range(ROWS)]
    idx, nnz = pad_rows(rows, pad_to_multiple=1)
    full = np.zeros((ROWS, lane), np.int32)
    full[:, :idx.shape[1]] = idx
    return (torch.from_numpy(full).to(dev), torch.from_numpy(nnz).to(dev),
            int(nnz.sum()))


def phase_timing(torch, dev, docs, card: str, int_rate: float) -> dict:
    import torch.nn.functional as F
    from repro_torch.core.bbit import (packed_mask_width, packed_width,
                                       unpack_codes_torch)
    from repro_torch.core.oph import OPHHash
    from repro_torch.core.universal_hash import MultiplyShiftHash
    from repro_torch.kernels import bbit_linear as bl
    from repro_torch.kernels import fused_encode as fe

    a, b = MultiplyShiftHash.make(K, 1).params(dev)
    oa, ob = OPHHash.make(K, 1).params(dev)
    table = (0.01 * torch.randn((K, 1 << B, 1),
                                generator=torch.Generator().manual_seed(0))
             ).to(dev)
    w_bytes, e_bytes = packed_width(K, B), packed_mask_width(K)
    out = {}
    for lane in NNZ_BUCKETS:
        idx, nnz, total_nnz = lane_batch(torch, dev, docs, lane)
        rec = {}
        ms = time_ms(torch, lambda: fe.minhash_pack(idx, nnz, a, b, bits=B),
                     200)
        plain = time_ms(torch, lambda: fe.minhash_pack_plain(
            idx, nnz, a, b, bits=B), 3)
        bnd = bound(4 * total_nnz + 4 * ROWS + 8 * K + ROWS * w_bytes,
                    OPS_PER_MINHASH * K * total_nnz, int_rate)
        rec["minhash_pack"] = dict(ms=ms, plain_ms=plain, bound_ms=bnd[0],
                                   bound_by=bnd[1], library_ms=None)
        ms = time_ms(torch, lambda: fe.oph_pack(idx, nnz, oa, ob, k=K,
                                                bits=B), 200)
        plain = time_ms(torch, lambda: fe.oph_pack_plain(
            idx, nnz, oa, ob, k=K, bits=B), 10)
        bnd = bound(4 * total_nnz + 4 * ROWS + 8 + ROWS * (w_bytes + e_bytes),
                    OPS_PER_OPH_HASH * total_nnz, int_rate)
        rec["oph_pack"] = dict(ms=ms, plain_ms=plain, bound_ms=bnd[0],
                               bound_by=bnd[1], library_ms=None)

        packed, _ = fe.oph_pack(idx, nnz, oa, ob, k=K, bits=B)
        codes = unpack_codes_torch(packed, K, B)
        flat = torch.arange(K, device=dev)[None, :] * (1 << B) + codes
        touched = int(torch.unique(flat).numel())
        ms = time_ms(torch, lambda: bl.bbit_linear_packed_fwd(
            packed, table, k=K, bits=B), 500)
        plain = time_ms(torch, lambda: bl.bbit_linear_packed_fwd_plain(
            packed, table, k=K, bits=B), 50)
        weight2d = table.view(K * (1 << B), 1)
        lib = time_ms(torch, lambda: F.embedding_bag(flat, weight2d,
                                                     mode="sum"), 500)
        bnd = bound(ROWS * w_bytes + 4 * touched + 4 * ROWS, ROWS * K,
                    PEAK_F32_OPS_PER_S)
        rec["bbit_linear_packed_fwd"] = dict(ms=ms, plain_ms=plain,
                                             bound_ms=bnd[0],
                                             bound_by=bnd[1],
                                             library_ms=lib)
        for name, r in rec.items():
            print(f"timing: {name} rows={ROWS} lane={lane} "
                  f"nnz_sum={total_nnz} ms={r['ms']} plain_ms="
                  f"{r['plain_ms']} bound_ms={r['bound_ms']} "
                  f"({r['bound_by']}) library_ms={r['library_ms']} "
                  f"card={card}")
        out[lane] = rec
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None,
                    help="also write every measurement to this JSON file")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    import repro_torch  # noqa: F401 — fails outside a checkout
    dev = torch.device("cuda", 0)
    t_start = time.perf_counter()
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")

    card = card_line()
    int_rate = int32_ops_per_s(torch)
    phase_build()
    errs = phase_kernels(torch, dev)
    docs = make_corpus(DOCS, seed=0)
    engine = phase_engine(torch, dev, docs, card)
    timing = phase_timing(torch, dev, docs, card, int_rate)

    top = NNZ_BUCKETS[-1]
    kernels = []
    for name, (source, replaces) in KERNELS.items():
        rec = timing[top][name]
        kernels.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces,
                        "launches": engine["launches"][name],
                        "max_abs_err": errs[name], **rec})
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"card": card, "int32_ops_per_s": int_rate,
                       "kernels": kernels, "timing": timing,
                       "docs_per_s": engine["docs_per_s"],
                       "profiles": engine["profiles"],
                       "seconds": time.perf_counter() - t_start}, f,
                      indent=1)
    print(f"total: {time.perf_counter() - t_start:.1f} s")
    print(f"card: {card}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
