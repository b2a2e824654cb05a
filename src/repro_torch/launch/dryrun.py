"""Dry-run of every (arch × shape × mesh) cell on local shards (counterpart
of ``repro/launch/dryrun.py``).

For each cell:
  1. a process group of the mesh's size in this process that moves no
     data (``launch/mesh.py::fake_world``) and the production mesh over
     it (16×16, or 2×16×16);
  2. the cell's step (train / prefill / decode) from
     ``launch/steps.py``, its state, cache and batch as DTensors laid out
     by the real specs, their local shards on the meta device (nothing
     is allocated);
  3. one call of the step traced on this rank's shards
     (``launch/roofline.py::trace_step``): a layout the step cannot run
     fails here, and is a fault of the port;
  4. the record: the arguments' local bytes, the peak of the bytes the
     call allocated, the traced FLOPs, bytes and collective schedule;
  5. with probes, the reference's probe arithmetic over small traced
     calls (``launch/probes.py``) and the roofline terms.

It needs no card, no network and no ``XLA_FLAGS``.  Records go to
``<out>/<arch>__<shape>__<mesh>.json``, which ``launch/report.py``
renders.

Usage:
  python -m repro_torch.launch.dryrun --arch internlm2-1.8b --shape train_4k
  python -m repro_torch.launch.dryrun --all --mesh single_pod --no-probes
  python -m repro_torch.launch.dryrun --paper-linear
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback

# the memory a rank holds: one NVIDIA H100 SXM, 80 GB HBM3, as
# torch.cuda.get_device_properties(0).total_memory reports it on the
# card (chip_smoke.py's lm_mesh phase prints it; PERF.md §6)
HBM_BUDGET_BYTES = 85_017_493_504


def _meta_tree(shapes, specs, mesh):
    """DTensors of ``shapes`` (meta tensors or ``BatchShape``s) laid out
    by ``specs``, their local shards on the meta device: nothing is
    allocated, and the ops on them only shape their results."""
    import torch
    from repro_torch.launch import steps as steps_lib
    from repro_torch.models.api import BatchShape
    from repro_torch.tree import tree_map

    def zeros(t):
        return torch.zeros(tuple(t.shape), dtype=t.dtype, device="meta")

    if isinstance(shapes, BatchShape):
        full = zeros(shapes)
    elif isinstance(shapes, dict) and all(
            isinstance(v, BatchShape) for v in shapes.values()):
        full = {k: zeros(v) for k, v in shapes.items()}
    else:
        full = tree_map(zeros, shapes)
    return steps_lib.shard_tree(full, specs, mesh)


def _step_args(api, mesh, plan):
    """(step, args) of the cell's kind, args DTensors on meta shards."""
    import torch
    from repro_torch.launch import steps as steps_lib
    if plan.kind == "train":
        step, state_shapes, state_ps, bshapes, bps = \
            steps_lib.build_lm_train_step(api, mesh, plan)
        state = _meta_tree(state_shapes, state_ps, mesh)
        state = dataclasses.replace(
            state, step=torch.zeros((), dtype=torch.int32, device="meta"))
        return step, (state, _meta_tree(bshapes, bps, mesh))
    if plan.kind == "prefill":
        step, pshapes, pp, bshapes, bps = steps_lib.build_prefill_step(
            api, mesh, plan)
        return step, (_meta_tree(pshapes, pp, mesh),
                      _meta_tree(bshapes, bps, mesh))
    step, (pshapes, cshapes, _, bshapes), (pp, cps, _, bps) = \
        steps_lib.build_decode_step(api, mesh, plan)
    # the length is a 0-d int32 argument of the step, as in the
    # reference; the decode writes at the cache's last position
    return step, (_meta_tree(pshapes, pp, mesh),
                  _meta_tree(cshapes, cps, mesh),
                  torch.zeros((), dtype=torch.int32, device="meta"),
                  _meta_tree(bshapes, bps, mesh))


def cell_argument_bytes(api, mesh, plan) -> int:
    """The local bytes of the cell's step arguments (what ``_cell``
    records as ``memory.argument_bytes``), without tracing the step."""
    from repro_torch.launch import steps as steps_lib
    return steps_lib.local_bytes(_step_args(api, mesh, plan)[1])


def trace_cell(api, mesh, plan, replay: bool = True):
    """Builds the cell's step on meta shards and traces one call →
    (argument bytes, StepTrace).  A train step runs its accumulation
    loop's body once (one microbatch and the update), as XLA's cost
    analysis counts a loop body once; the memory it reaches there is
    the step's, since each microbatch frees its activations.
    ``replay=False`` traces every local call (``roofline.trace_step``)."""
    from repro_torch.launch import steps as steps_lib
    from repro_torch.launch.roofline import trace_step
    step, args = _step_args(api, mesh, plan)
    arg_bytes = steps_lib.local_bytes(args)
    if plan.kind == "decode":
        params, cache, _, batch = args
        _, trace = trace_step(step, params, cache, plan.seq - 1, batch,
                              replay=replay)
    elif plan.kind == "train":
        _, trace = trace_step(lambda st, b: step(st, b, micro_limit=1),
                              *args, replay=replay)
    else:
        _, trace = trace_step(step, *args, replay=replay)
    return arg_bytes, trace


def _mesh_for(multi_pod: bool):
    from repro_torch.launch.mesh import fake_world, make_production_mesh
    fake_world(512 if multi_pod else 256)
    return make_production_mesh(multi_pod=multi_pod)


def _cell(arch: str, shape: str, multi_pod: bool, out_dir: str,
          probes: bool = True, overrides: dict = None,
          replay: bool = True) -> dict:
    from repro_torch.configs.base import get_config
    from repro_torch.distributed import shardings as sh
    from repro_torch.launch import probes as probes_lib
    from repro_torch.launch.roofline import model_flops, roofline_terms
    from repro_torch.launch.shapes import SHAPES, cell_is_skipped, plan_cell
    from repro_torch.models.api import get_model_api

    del out_dir
    cfg = get_config(arch)
    if SHAPES[shape]["seq"] >= 32768:
        # long sequences: the scan form bounds live float32 score buffers
        # to one (q, kv) block, as in the reference's dry-run
        cfg = dataclasses.replace(cfg, attn_impl="scan")
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    mesh_name = "multi_pod" if multi_pod else "single_pod"
    rec = dict(arch=arch, shape=shape, mesh=mesh_name,
               overrides=overrides or {})
    if cell_is_skipped(cfg, shape):
        rec.update(status="skipped",
                   reason="full-attention arch; long_500k requires "
                          "sub-quadratic attention (DESIGN.md §5)")
        return rec

    mesh = _mesh_for(multi_pod)
    n_dev = mesh.size()
    plan = plan_cell(cfg, shape, sh.dp_size(mesh))
    api = get_model_api(cfg)
    t0 = time.time()
    args_b, trace = trace_cell(api, mesh, plan, replay=replay)
    t_trace = time.time() - t0
    temp_b = trace.temp_bytes
    resident = args_b + temp_b        # the state is updated in place
    rec.update(
        status="ok",
        plan=dataclasses.asdict(plan),
        n_devices=n_dev,
        compile_seconds=round(t_trace, 1),
        memory=dict(peak_memory_bytes=resident,
                    argument_bytes=args_b,
                    temp_bytes=temp_b,
                    output_bytes=trace.output_bytes,
                    resident_bytes=resident,
                    hbm_budget_bytes=HBM_BUDGET_BYTES,
                    fits=resident <= HBM_BUDGET_BYTES),
        cost_full_hlo_once=trace.cost.to_dict(),
        traced_ops=trace.n_ops,
    )

    if probes:
        try:
            probe_total, detail = probes_lib.assemble_cell_cost(
                cfg, shape, mesh, plan)
            terms = roofline_terms(probe_total)
            mf = model_flops(cfg, plan.global_batch, plan.seq, plan.kind)
            mf_dev = mf / n_dev
            terms["model_flops_per_dev"] = mf_dev
            terms["hlo_flops_per_dev"] = probe_total.flops
            terms["useful_flops_ratio"] = (
                mf_dev / probe_total.flops if probe_total.flops else 0.0)
            rec["probe_cost"] = probe_total.to_dict()
            rec["probe_detail"] = detail
            rec["roofline"] = terms
        except Exception as e:  # noqa: BLE001 — record probe failures
            rec["probe_error"] = f"{type(e).__name__}: {e}"
            rec["probe_traceback"] = traceback.format_exc()[-2000:]
    return rec


def _paper_linear(multi_pod: bool) -> dict:
    import torch
    from repro_torch.configs.rcv1_bbit import CONFIG as paper
    from repro_torch.launch import steps as steps_lib
    from repro_torch.launch.roofline import roofline_terms, trace_step

    mesh = _mesh_for(multi_pod)
    t0 = time.time()
    step, state_shapes, state_ps, (codes_s, labels_s) = \
        steps_lib.build_linear_train_step(paper, mesh)
    state = _meta_tree(state_shapes, state_ps, mesh)
    state = dataclasses.replace(
        state, step=torch.zeros((), dtype=torch.int32, device="meta"))
    dp = steps_lib.batch_pspecs(mesh, {"c": codes_s, "l": labels_s})
    codes = _meta_tree(codes_s, dp["c"], mesh)
    labels = _meta_tree(labels_s, dp["l"], mesh)
    args_b = steps_lib.local_bytes((state, codes, labels))
    _, trace = trace_step(step, state, codes, labels)
    terms = roofline_terms(trace.cost)
    return dict(
        arch="rcv1-bbit-linear", shape="train_batch65536",
        mesh="multi_pod" if multi_pod else "single_pod",
        status="ok", n_devices=mesh.size(),
        compile_seconds=round(time.time() - t0, 1),
        memory=dict(peak_memory_bytes=args_b + trace.temp_bytes,
                    argument_bytes=args_b,
                    temp_bytes=trace.temp_bytes,
                    fits=True),
        cost_full_hlo_once=trace.cost.to_dict(),
        roofline=terms,
    )


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", default="single_pod",
                    choices=["single_pod", "multi_pod", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--paper-linear", action="store_true")
    ap.add_argument("--no-probes", action="store_true")
    ap.add_argument("--out", default="artifacts/dryrun_torch")
    ap.add_argument("--override", default=None,
                    help="JSON dict of ArchConfig overrides (perf exps)")
    ap.add_argument("--tag", default="")
    ap.add_argument("--no-replay", action="store_true",
                    help="trace every local call, without replaying an "
                         "identical earlier one's counts (the same "
                         "record, slower: times the replay)")
    args = ap.parse_args(argv)

    os.makedirs(args.out, exist_ok=True)
    meshes = (["single_pod", "multi_pod"] if args.mesh == "both"
              else [args.mesh])
    overrides = json.loads(args.override) if args.override else None

    jobs = []
    if args.paper_linear:
        for m in meshes:
            jobs.append(("paper", None, m))
    elif args.all:
        from repro_torch.configs.archs import ALL_ARCHS
        from repro_torch.launch.shapes import ALL_SHAPES
        for arch in ALL_ARCHS:
            for shape in ALL_SHAPES:
                for m in meshes:
                    jobs.append((arch, shape, m))
    else:
        for m in meshes:
            jobs.append((args.arch, args.shape, m))

    for arch, shape, m in jobs:
        multi = m == "multi_pod"
        if arch == "paper":
            rec = _paper_linear(multi)
            name = f"rcv1-bbit-linear__train__{m}{args.tag}.json"
        else:
            try:
                # the roofline table is single-pod only; multi-pod runs
                # prove the layout and the memory without probes
                rec = _cell(arch, shape, multi, args.out,
                            probes=not args.no_probes and not multi,
                            overrides=overrides,
                            replay=not args.no_replay)
            except Exception as e:  # noqa: BLE001
                rec = dict(arch=arch, shape=shape, mesh=m,
                           status="error",
                           error=f"{type(e).__name__}: {e}",
                           traceback=traceback.format_exc()[-3000:])
            name = f"{arch}__{shape}__{m}{args.tag}.json"
        path = os.path.join(args.out, name)
        with open(path, "w") as f:
            json.dump(rec, f, indent=1)
        status = rec.get("status")
        mem = rec.get("memory", {})
        rl = rec.get("roofline", {})
        print(f"[{status}] {arch} × {shape} × {m}"
              f" resident={mem.get('resident_bytes', 0)/2**30:.2f}GiB"
              f" fits={mem.get('fits')}"
              f" dominant={rl.get('dominant')}"
              f" frac={rl.get('roofline_fraction', 0):.3f}"
              f" s={rec.get('compile_seconds')}"
              + (f" err={rec.get('error', rec.get('probe_error',''))[:120]}"
                 if status != "ok" or "probe_error" in rec else ""),
              flush=True)


if __name__ == "__main__":
    main()
