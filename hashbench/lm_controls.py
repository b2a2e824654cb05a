"""Readings that set the limits of an ``lm_generate`` cell: the program's
sound runs, the control one precision below the stated one, and planted
faults, each judged by the cell's own readings.

    python3 hashbench/lm_controls.py --workload lm-kimi-k2-longdoc \
        --seeds 1 2 3 [--rehearse-cpu] [--out readings.jsonl]

One JSON line a reading: {"kind", "seed", <reading>: value, ...}.  For
each seed the set-up of a timed run (the seed's weights and prompts, one
cycle of ``greedy_generate``), then on every call of that cycle, against
the float32 reference over the call's own tokens:

* ``sound``: the program, teacher-forced by the call's tokens, as the
  check runs it;
* ``control``: the reference with every matrix product's operands
  rounded to float8_e4m3fn (one scale a tensor) in the program's place:
  the model one precision below the bfloat16 the configuration states;
* faults planted in the program (``fault_*``), fed the same tokens: the
  held experts' outputs left out (their down-projections zero), the
  score-correction bias left out of the choice, and YaRN's mscale² left
  out of the softmax scale.

Runs on the card at the cell's size, or with ``--rehearse-cpu`` at its
rehearsal size.  Not run by the benchmark's own runs.
"""
import argparse
import contextlib
import json
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent


def _emit(out, kind, seed, values):
    line = json.dumps(dict({"kind": kind, "seed": seed}, **values))
    print(line, flush=True)
    if out is not None:
        out.write(line + "\n")
        out.flush()


@contextlib.contextmanager
def _fault(state, name):
    """The program with fault ``name`` planted (params swapped, or a
    function of the model replaced) for the block, through an api built
    afresh (its decode graphs are captured with the fault)."""
    from repro_torch.models import transformer as tf_lib
    from repro_torch.models.api import get_model_api
    params, api = state.params, state.api
    state.api = get_model_api(state.cfg)
    moe = params["layers"]["moe"]
    real_scale = tf_lib.mla_softmax_scale
    if name == "fault_no_routed":
        state.params = dict(params, layers=dict(params["layers"], moe=dict(
            moe, w_down=torch.zeros_like(moe["w_down"]))))
    elif name == "fault_no_bias":
        state.params = dict(params, layers=dict(params["layers"], moe=dict(
            moe, router_bias=torch.zeros_like(moe["router_bias"]))))
    elif name == "fault_no_mscale":
        tf_lib.mla_softmax_scale = lambda cfg: (
            cfg.qk_nope_head_dim + cfg.qk_rope_head_dim) ** -0.5
    try:
        yield
    finally:
        state.params, state.api = params, api
        tf_lib.mla_softmax_scale = real_scale


FAULTS = ("fault_no_routed", "fault_no_bias", "fault_no_mscale")


def seed_readings(cell, seed, device):
    from hashbench.loops import lm_generate as loop
    state = loop.setup(cell, seed, device)
    kinds = {k: [] for k in ("sound", "control") + FAULTS}
    for tokens in state.outs:
        want = loop.reference(state, tokens)
        logits, routes, _ = loop.program_logits(state, tokens)
        kinds["sound"].append(loop.readings((logits, routes), want))
        s0 = tokens.shape[1] - state.max_new
        fp8_logits, fp8_routes = loop.reference(state, tokens, fp8=True)
        kinds["control"].append(loop.readings(
            (fp8_logits, [r[:, :s0] for r in fp8_routes]), want))
        for name in FAULTS:
            with _fault(state, name):
                logits, routes, _ = loop.program_logits(state, tokens)
            kinds[name].append(loop.readings((logits, routes), want))
        del want
    return [(k, loop.summarise(v)) for k, v in kinds.items()]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--rehearse-cpu", action="store_true")
    p.add_argument("--out")
    args = p.parse_args(argv)
    sys.path[:1] = [str(ROOT), str(ROOT / "src")]
    from hashbench import harness
    cell = harness.load_cell(args.workload, rehearsal=args.rehearse_cpu)
    if args.rehearse_cpu:
        device = torch.device("cpu")
    elif torch.cuda.is_available():
        device = torch.device("cuda", 0)
    else:
        print("lm_controls: no CUDA device", file=sys.stderr)
        return 3
    out = open(args.out, "a") if args.out else None
    try:
        for seed in args.seeds:
            for kind, values in seed_readings(cell, seed, device):
                _emit(out, kind, seed, values)
    finally:
        if out is not None:
            out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
