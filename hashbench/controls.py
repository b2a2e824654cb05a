"""Readings that set a cell's limits: the program's sound runs, the
control and the planted faults, each judged by the cell's own check.

    python3 hashbench/controls.py --workload <name> --seeds 1 2 ... \
        --control-seeds 1 2 3 [--out readings.jsonl]

One JSON line a reading: {"kind", "seed", <number>: value, ...}.
``--set KEY=JSON`` overrides keys of the configuration, as for
calibrating a codes' law (``--set label_flip=0.02``).

* ``sound``: the program as the timed path runs it (one fit, or one
  whole pass), judged as a run judges it;
* ``control``: the reference put in the program's place one step below
  what the configuration states: TRON in bfloat16 for the float32 fit;
  for the encodes, which state no precision, the guarantee that a code
  is the minimum over all of a document's nonzeros broken by hashing
  only each row's first ``nnz_median`` ids (the configuration's median
  length, so about half of the documents lose ids);
* faults planted in the program's output (``fault_*``): TRON's start
  returned unchanged, a fit on half of the training rows, an entry of
  the fitted table altered by one; an encode pass with half of each
  chunk's rows left out (zeros), and one byte of every row altered.

Runs on the card at the cell's own size, or with ``--rehearse-cpu`` on
the CPU at its rehearsal size (the tests).  Not run by the benchmark's
own runs.
"""
import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent



def _emit(out, kind, seed, readings):
    line = json.dumps(dict({"kind": kind, "seed": seed}, **readings))
    print(line, flush=True)
    if out is not None:
        out.write(line + "\n")
        out.flush()


def tron_readings(cell, seed, device, control: bool, faults: bool):
    """→ [(kind, readings)] of one seed of a ``fit_loop`` cell: a sound
    fit of every instance (with its iterations, seconds and accuracies),
    and the control and the faults on the instance ``seed`` picks."""
    import time
    import torch
    from hashbench.loops import fit_loop
    from hashbench.reference import tron
    cfg = cell.config
    state = fit_loop.State(cell, device,
                           [fit_loop.make_inputs(cfg, seed, device, inst)
                            for inst in cfg["tron_instance_seeds"]],
                           fit_loop.linear_config(cfg))
    out = []
    fits = []
    for i in range(len(state.data)):
        t0 = time.perf_counter()
        res = fit_loop.run_fit(state, i)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        secs = time.perf_counter() - t0
        fits.append(fit_loop.as_checked(res))
        read = fit_loop.judge(state, [(i, fits[-1])])[0]
        out.append(("sound", dict(read, instance=i, n_iter=res.n_iter,
                                  fit_s=secs, train_acc=res.train_acc,
                                  test_acc=res.test_acc)))
    i = seed % len(state.data)
    judge = lambda fit: dict(fit_loop.judge(state, [(i, fit)])[0],
                             instance=i)
    d, fit = state.data[i], fits[i]
    if faults:
        table, bias = fit[0], fit[1]
        out.append(("fault_unchanged", judge(
            (torch.zeros_like(table), torch.zeros_like(bias), *fit[2:]))))
        altered = table.clone()
        altered.view(-1)[int(d.x_tr[0, 0])] += 1.0
        out.append(("fault_altered", judge((altered, bias, *fit[2:]))))
        half = d.x_tr.shape[0] // 2
        state.data[i] = fit_loop.Data(d.x_tr[:half], d.y_tr[:half],
                                      d.x_te, d.y_te)
        halved = fit_loop.as_checked(fit_loop.run_fit(state, i))
        state.data[i] = d
        out.append(("fault_half", judge(halved)))
    if control:
        r = tron.fit(d.x_tr, d.y_tr, d.x_te, d.y_te,
                     k=cfg["k"], vsize=1 << cfg["b"], C=cfg["C"],
                     dtype=torch.bfloat16, max_iter=cfg["tron_max_iter"],
                     cg_max=cfg["tron_cg_max"], cg_tol=cfg["tron_cg_tol"],
                     grad_tol=cfg["tron_grad_tol"])
        read = judge((r.table, r.bias, r.objective, r.train_acc,
                      r.test_acc))
        out.append(("control", dict(read, n_iter=r.n_iter)))
    return out


def encode_readings(cell, seed, device, control: bool, faults: bool):
    """→ [(kind, readings)] of one seed of an ``encode_passes`` cell."""
    import torch
    from hashbench.loops import encode_passes as ep
    import contextlib
    from hashbench.reference import hashing
    state = ep.setup(cell, seed, device)
    state.outs = ep.one_pass(state, lambda name: contextlib.nullcontext())
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    rows = lambda bad: {"mismatched_rows": bad[0], "rows": bad[1],
                        "fewest_rows_in_a_chunk": bad[2]}
    out = [("sound", rows(ep.judge(state)))]
    if faults:
        def half(ci, local):
            got = state.outs[ci][local].clone()
            got[local >= state.plan[ci].rows // 2] = 0
            return got

        def altered(ci, local):
            got = state.outs[ci][local].clone()
            got[:, 0] ^= 1
            return got
        out.append(("fault_half", rows(ep.judge(state, got=half))))
        out.append(("fault_altered", rows(ep.judge(state, got=altered))))
    if control:
        cfg = cell.config
        fn = ep.REFERENCE[cfg["scheme"]]

        def truncated(ci, local):
            ids, nnz = state.chunks[ci]
            sel = nnz[local].clamp(max=cfg["nnz_median"])
            return fn(ids[local][:, :int(sel.max())].contiguous(), sel,
                      cfg["k"], cfg["b"], state.hash_seed)
        out.append(("control", rows(ep.judge(state, got=truncated))))
    return out


READINGS = {"fit_loop": tron_readings, "encode_passes": encode_readings}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="*", default=[])
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    p.add_argument("--out")
    p.add_argument("--set", nargs="*", default=[], metavar="KEY=JSON",
                   help="configuration keys to override, as for "
                        "calibrating a law (not the benchmark's own runs)")
    p.add_argument("--rehearse-cpu", action="store_true")
    args = p.parse_args(argv)
    sys.path[:1] = [str(ROOT), str(ROOT / "src")]
    import torch
    from hashbench import harness
    cell = harness.load_cell(args.workload, rehearsal=args.rehearse_cpu)
    for item in args.set:
        key, value = item.split("=", 1)
        cell.config[key] = json.loads(value)
    device = torch.device("cpu" if args.rehearse_cpu else "cuda:0")
    readings = READINGS[cell.traffic["loop"]]
    out = open(args.out, "a") if args.out else None
    try:
        for seed in dict.fromkeys(args.seeds + args.control_seeds):
            ctl = seed in args.control_seeds
            for kind, read in readings(cell, seed, device, ctl, ctl):
                _emit(out, kind, seed, read)
    finally:
        if out is not None:
            out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
