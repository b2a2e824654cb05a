"""The long-document LM cell at the rehearsal size on the CPU: a sound run
is correct; its control (the reference one precision below bfloat16, in
the program's place) and its planted faults fail a limit; the MLA
roofline's counts and the new readers.  The harness's look for a chip is
skipped (``run_cell`` on the CPU)."""
import dataclasses
import time

import pytest
import torch

from hashbench import harness, lm_controls, trace
from hashbench.roofline import mla

CPU = torch.device("cpu")
LM = "lm-kimi-k2-longdoc"


def run(workload, trace_=False):
    cell = harness.load_cell(workload, rehearsal=True)
    return harness.run_cell(cell, 2 ** 31 + 77, 0.2, trace_, "cpu",
                            time.perf_counter())


def test_a_sound_run_is_correct():
    out = run(LM)
    assert out["result"]["correct"]
    assert out["result"]["metrics"]["encode_docs_per_s"]["value"] > 0


def test_the_lm_control_and_faults_fail_a_limit():
    cell = harness.load_cell(LM, rehearsal=True)
    limits = cell.check["limits"]
    got = dict(lm_controls.seed_readings(cell, 11, CPU))
    over = {k: [n for n in limits if v[n] > limits[n]]
            for k, v in got.items()}
    assert not over["sound"]
    assert over["control"]
    for name in ("fault_no_routed", "fault_no_mscale"):
        assert over[name], name


def test_a_token_the_timed_call_did_not_pick_fails_the_check():
    """The check holds the window's own tokens: one generated token
    changed, as a fault in greedy_generate's loop would change it, fails
    ``rerun_token_diff``'s limit."""
    from hashbench.loops import lm_generate
    cell = harness.load_cell(LM, rehearsal=True)
    state = lm_generate.setup(cell, 12, CPU)
    out = state.outs[0].copy()
    s0 = out.shape[1] - state.max_new
    out[0, s0 + 3] = (out[0, s0 + 3] + 1) % state.cfg.vocab
    state.outs = [out]
    readings, failed = lm_generate.check(state)
    assert readings["rerun_token_diff"] >= 1
    assert failed


def test_mla_counts_of_the_published_cut():
    from repro_torch.configs import get_config
    m = dataclasses.asdict(get_config("kimi-k2-instruct-ep32"))
    att = mla.attention_flops(m, 2, 32768) + mla.attention_flops(m, 1, 65536)
    # 9 layers × (44.0 + 88.0) TFLOP
    assert att == pytest.approx(1.1875e15, rel=1e-3)
    assert mla.token_flops(m) == pytest.approx(3.538e9, rel=1e-3)
    cycle = mla.prefill_flops(m, 2, 32768) + mla.prefill_flops(m, 1, 65536)
    assert cycle == pytest.approx(1.651e15, rel=1e-3)


def _record(**kw):
    base = dict(calls=0, wall_s=1.0, counters={}, spans={}, values={},
                shapes={}, peaks=None, profile=None)
    base.update(kw)
    return trace.Record(**base)


@pytest.mark.parametrize("metric", (
    "lm.prefill_mfu", "lm.mla_roofline", "lm.moe_rows_per_call",
    "lm.decode_ms_per_step", "lm.device_idle"))
def test_a_reader_finds_nothing_in_an_empty_run(metric):
    assert harness.reader(metric)(_record()) is None


def test_the_lm_readers_read_counters_and_spans():
    rec = _record(calls=4, counters={"lm.moe_rows": 524288,
                                     "span.lm.decode_step.calls": 60,
                                     "span.lm.decode_step.ns": 600_000_000})
    assert harness.reader("lm.moe_rows_per_call")(rec) == 131072
    assert harness.reader("lm.decode_ms_per_step")(rec) == pytest.approx(10)
