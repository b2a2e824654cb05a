#!/usr/bin/env python3
"""The LM zoo on a 2 × 2 ``(data, model)`` DeviceMesh over NCCL, a card a
rank, against one card without a mesh: ``chip_smoke.py``'s lm_mesh
phase on a machine with four NVIDIA GPUs.

    python3 scripts/lm_mesh_nccl.py [--out result.json]

Four ranks (rank r on cuda:r, NCCL) build the mesh with
``launch/mesh.py::make_test_mesh(2, 2)`` and run, on params drawn once
from seeded CPU generators:

  * reduced granite-moe (float32, capacity 8 so that no token is
    dropped): expert parallelism with ep = 2 — the loss, prefill's last
    logits and three decode steps, held to the mesh-free model within
    1e-4 (the CPU tests' bound);
  * internlm2-1.8b as registered (bfloat16): prefill of 2 × 512 (one row
    a data rank, heads and features split over 'model') and 32 greedy
    decode steps through ``launch/steps.py``'s builders, held to the
    mesh-free model on cuda:0: the prefill logits within the lm phase's
    bound (16 bfloat16 ulps of the largest logit), the tokens equal, or
    parting only where the two top logits are within that bound (the
    row-parallel matmuls sum their partials in another order).

Rank 0 also runs the mesh-free side.  Every rank then runs four more
decode steps under ``torch.profiler``; rank 0's split of a step (host
ops, collective calls, the rest of the wall; NCCL kernels against the
others on the device) goes into the record.  It prints the card lines,
the errors, prefill and decode ms on the mesh and without, the split,
and one JSON line; any failure exits non-zero.  With fewer than four
cards it exits 2.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCH, BATCH, PROMPT, NEW = "internlm2-1.8b", 2, 512, 32
BF16_TOL = 16 * 2.0 ** -8
REDUCED_TOL = 1e-4
PROFILE_STEPS = 4


def _breakdown(prof, wall_ms: float, steps: int) -> dict:
    """A profiled decode's time a step: the wall, the host ops' self CPU
    time (all, and the collectives' calls: ``_c10d_functional`` ops and
    NCCL's host side), the rest of the wall (Python, DTensor's dispatch
    between ops), and the device time in NCCL kernels against every
    other kernel."""
    from torch.autograd import DeviceType
    out = {"wall_ms": wall_ms / steps, "host_ops_ms": 0.0,
           "host_collective_ms": 0.0, "collective_calls": 0,
           "device_nccl_ms": 0.0, "nccl_kernels": 0,
           "device_other_ms": 0.0}
    for e in prof.key_averages():
        key = e.key.lower()
        if e.device_type == DeviceType.CPU:
            ms = e.self_cpu_time_total / 1e3 / steps
            out["host_ops_ms"] += ms
            if "c10d" in key or "nccl" in key:
                out["host_collective_ms"] += ms
                if key.startswith("_c10d_functional::") and \
                        "wait" not in key and "wrap" not in key:
                    out["collective_calls"] += e.count // steps
            continue
        ms = float(getattr(e, "self_device_time_total", 0) or 0) / 1e3 \
            / steps
        if "nccl" in key:
            out["device_nccl_ms"] += ms
            out["nccl_kernels"] += e.count // steps
        else:
            out["device_other_ms"] += ms
    out["host_rest_ms"] = out["wall_ms"] - out["host_ops_ms"]
    return out


def _rank(rank: int, port: int, out: str) -> None:
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import dataclasses

    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch import tree
    from repro_torch.configs import get_config
    from repro_torch.data.lm_synth import lm_example_stream
    from repro_torch.distributed import shardings as sh
    from repro_torch.launch import steps as S
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.launch.shapes import CellPlan
    from repro_torch.launch.smoke_configs import reduced_config
    from repro_torch.models.api import get_model_api
    from repro_torch.serving import greedy_generate
    from repro_torch.serving.engine import grow_cache

    torch.cuda.set_device(rank)
    dev = torch.device("cuda", rank)
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=4)
    mesh = make_test_mesh(2, 2)
    rec = {"backend": str(dist.get_backend()),
           "mesh_device": mesh.device_type}

    def full(t):
        return t.full_tensor() if sh.is_dtensor(t) else t

    # --- reduced granite-moe: expert parallelism, ep = 2 -----------------
    cfg = dataclasses.replace(reduced_config(get_config(
        "granite-moe-3b-a800m")), moe_capacity=8.0)
    api = get_model_api(cfg)
    params = api.init_params(torch.Generator().manual_seed(0), device=dev)
    rng = np.random.default_rng(1)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (8, 36)).astype(
        np.int32)).to(dev)
    tgts = torch.from_numpy(rng.integers(0, cfg.vocab, (8, 36)).astype(
        np.int32)).to(dev)
    S.set_mesh_for_alignment(mesh)
    dparams = S.shard_tree(params, S.align_pspecs(
        params, api.param_pspecs(mesh)), mesh)
    bs = sh.P(("data",))
    with torch.no_grad():
        loss = float(full(api.loss_fn(dparams, {
            "tokens": sh.distribute(toks, mesh, bs),
            "targets": sh.distribute(tgts, mesh, bs)}, mesh)))
        loss0 = float(api.loss_fn(params, {"tokens": toks,
                                           "targets": tgts}))
        lg, cache = api.prefill(dparams, {"tokens": sh.distribute(
            toks[:, :32], mesh, bs)}, mesh)
        lg0, cache0 = api.prefill(params, {"tokens": toks[:, :32]})
        errs = {"loss": abs(loss - loss0),
                "prefill": float((full(lg) - lg0).abs().max())}
        cache = grow_cache(api.init_cache(8, 36, device=dev),
                           tree.tree_map(full, cache))
        cache0 = grow_cache(api.init_cache(8, 36, device=dev), cache0)
        dcache = S.shard_tree(cache, S.align_pspecs(
            cache, api.cache_pspecs(mesh)), mesh)
        dec = 0.0
        for pos in range(32, 35):
            tok = toks[:, pos:pos + 1]
            d1, dcache = api.decode_step(dparams, {
                "token": sh.distribute(tok, mesh, bs)}, dcache, pos, mesh)
            d0, cache0 = api.decode_step(params, {"token": tok}, cache0,
                                         pos)
            dec = max(dec, float((full(d1) - d0).abs().max()))
        errs["decode"] = dec
    rec["granite_reduced"] = errs
    # --- internlm2-1.8b as registered --------------------------------------
    cfg = get_config(ARCH)
    api = get_model_api(cfg)
    params = api.init_params(torch.Generator().manual_seed(0), device=dev)
    _, np_toks, _ = next(lm_example_stream(BATCH, PROMPT, cfg.vocab,
                                           seed=0))
    prompt = torch.from_numpy(np_toks).to(dev)
    plan = CellPlan(arch=ARCH, shape="prefill", kind="prefill", seq=PROMPT,
                    global_batch=BATCH, n_micro=1, b_local=1)
    pstep, _, pp, _, bps = S.build_prefill_step(api, mesh, plan)
    dparams = S.shard_tree(params, pp, mesh)
    dprompt = S.shard_tree({"tokens": prompt}, bps, mesh)

    def timed(fn, together=True):
        fn()
        torch.cuda.synchronize()
        if together:
            dist.barrier()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        return res, (time.perf_counter() - t0) * 1e3

    with torch.no_grad():
        (lg, cache), prefill_ms = timed(lambda: pstep(dparams, dprompt))
        lg = full(lg)
        dplan = dataclasses.replace(plan, kind="decode", shape="decode",
                                    seq=PROMPT + NEW)
        dstep, _, (_, cps, _, dbps) = S.build_decode_step(api, mesh, dplan)
        grown = grow_cache(api.init_cache(BATCH, PROMPT + NEW, device=dev),
                           tree.tree_map(full, cache))
        dcache = S.shard_tree(grown, cps, mesh)
        nxt = torch.argmax(lg, -1)[:, None].to(torch.int32)
        got = [nxt]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for t in range(1, NEW):
            d, dcache = dstep(dparams, dcache, PROMPT + t - 1,
                              S.shard_tree({"token": nxt}, dbps, mesh))
            nxt = torch.argmax(full(d), -1)[:, None].to(torch.int32)
            got.append(nxt)
        torch.cuda.synchronize()
        decode_ms = (time.perf_counter() - t0) * 1e3 / (NEW - 1)
        # what a decode step is made of: PROFILE_STEPS more steps at the
        # cache's last position under torch.profiler, every rank
        from torch.profiler import ProfilerActivity, profile
        tok = nxt.clone()
        dist.barrier()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(PROFILE_STEPS):
                dstep(dparams, dcache, PROMPT + NEW - 1,
                      S.shard_tree({"token": tok}, dbps, mesh))
            torch.cuda.synchronize()
            prof_ms = (time.perf_counter() - t0) * 1e3
    rec.update(prefill_ms=prefill_ms, decode_ms=decode_ms,
               decode_profile=_breakdown(prof, prof_ms, PROFILE_STEPS))
    got = torch.cat(got, 1).cpu().numpy()
    if rank == 0:
        with torch.no_grad():
            (lg0, _), prefill0_ms = timed(lambda: api.prefill(
                params, {"tokens": prompt}), together=False)
        t0 = time.perf_counter()
        want = greedy_generate(api, params, np_toks, NEW, device=dev)
        generate0_s = time.perf_counter() - t0
        scale = float(lg0.float().abs().max())
        tol = BF16_TOL * max(scale, 1.0)
        parted = None
        diff = np.argwhere(got != want[:, PROMPT:])
        if len(diff):
            pos = int(diff[:, 1].min())
            rows = sorted({int(r) for r, c in diff if c == pos})
            with torch.no_grad():
                ctx, _ = api.prefill(params, {"tokens": torch.from_numpy(
                    want[:, :PROMPT + pos]).to(dev)})
            top = torch.topk(ctx.float()[rows], 2, dim=-1).values
            parted = {"step": pos, "rows": rows,
                      "top2_margin": float((top[:, 0] - top[:, 1]).min())}
        rec.update(prefill_err=float((lg.float() - lg0.float()).abs()
                                     .max()),
                   prefill_tol=tol, prefill_meshfree_ms=prefill0_ms,
                   generate_meshfree_s=generate0_s,
                   tokens_equal=parted is None, parted=parted)
        with open(out, "w") as f:
            json.dump(rec, f)
    dist.barrier()
    dist.destroy_process_group()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None, help="write the record here")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < 4:
        print("lm_mesh_nccl: needs four CUDA devices", file=sys.stderr)
        return 2
    import socket

    import torch.multiprocessing as mp
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    print(f"cards:\n{card}")
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    out = os.path.join(ROOT, "build", "lm_mesh_nccl.json")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    t0 = time.perf_counter()
    mp.spawn(_rank, args=(port, out), nprocs=4)
    with open(out) as f:
        rec = json.load(f)
    rec["seconds"] = time.perf_counter() - t0
    rec["cards"] = card.splitlines()
    g = rec["granite_reduced"]
    print(f"lm_mesh_nccl: 2 x 2 (data, model) over {rec['backend']} on "
          f"{rec['mesh_device']}; reduced granite-moe (ep = 2) vs one card: "
          f"loss {g['loss']:.3g}, prefill {g['prefill']:.3g}, decode "
          f"{g['decode']:.3g} (limit {REDUCED_TOL}); {ARCH}: prefill "
          f"{BATCH} x {PROMPT} {rec['prefill_ms']:.3f} ms (one card "
          f"{rec['prefill_meshfree_ms']:.3f}), logits max|diff| "
          f"{rec['prefill_err']:.4g} (bound {rec['prefill_tol']:.4g}); "
          f"decode {rec['decode_ms']:.3f} ms a step; greedy tokens equal "
          f"one card's: {rec['tokens_equal']}"
          + (f" (parted {json.dumps(rec['parted'])})"
             if rec["parted"] else ""))
    split = {k: round(v, 3) for k, v in rec["decode_profile"].items()}
    print(f"lm_mesh_nccl: a decode step on rank 0 under the profiler, ms "
          f"({PROFILE_STEPS} steps): {json.dumps(split)}")
    bad = [k for k, v in g.items() if not v <= REDUCED_TOL]
    if rec["prefill_err"] > rec["prefill_tol"]:
        bad.append("prefill logits")
    if rec["parted"] and rec["parted"]["top2_margin"] > rec["prefill_tol"]:
        bad.append(f"tokens part at {rec['parted']}")
    if rec["backend"] != "nccl":
        bad.append(f"backend {rec['backend']}")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rec, f, indent=1)
    print(json.dumps(rec))
    if bad:
        print(f"lm_mesh_nccl: FAILED {bad}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
