"""The readers of the program's own spans and counters: each gives its
value on a synthetic record and none where its counters are absent (a
program without them) or read nothing; a traced CPU rehearsal of the TRON
cell carries the program's ``span.*`` and ``tron.*`` counters."""
import time

import pytest

from hashbench import harness
from hashbench.trace import Record

TRON = "tron-bbit-k500-b16"


def record(counters, calls=4, wall_s=2.0):
    return Record(calls=calls, wall_s=wall_s, counters=counters, spans={},
                  values={}, shapes={}, peaks=None, profile=None)


def span(name, calls, ns):
    return {f"span.{name}.calls": calls, f"span.{name}.ns": ns,
            f"span.{name}.self_ns": ns}


TRON_COUNTERS = {
    "tron.host_reads": 800, "tron.cg_steps": 180,
    "bbit_linear_bwd_dw_plan_hits": 225, "bbit_linear_bwd_dw_plans": 0,
    "trainer.h2d_bytes": 0, "trainer.d2h_bytes": 28_000_000,
    **span("tron.read", 800, 1_200_000_000),
    **span("trainer.accuracy", 4, 60_000_000),
}
ENCODE_COUNTERS = {
    **span("scheme.encode_packed", 70, 7_000_000),
    **span("dispatch.choose", 70, 1_400_000),
    **span("kernel.alloc", 70, 700_000),
}

CASES = [
    ("tron.host_reads_per_fit", TRON_COUNTERS, 200.0),
    ("tron.read_wait_pct", TRON_COUNTERS, 60.0),
    ("tron.cg_steps_per_fit", TRON_COUNTERS, 45.0),
    ("tron.plan_hit_pct", TRON_COUNTERS, 100.0),
    ("tron.copy_mb_per_fit", TRON_COUNTERS, 7.0),
    ("tron.accuracy_ms_per_fit", TRON_COUNTERS, 15.0),
    ("encode.program_us_per_call", ENCODE_COUNTERS, 100.0),
    ("encode.dispatch_us_per_call", ENCODE_COUNTERS, 20.0),
    ("encode.alloc_us_per_call", ENCODE_COUNTERS, 10.0),
]


@pytest.mark.parametrize("metric,counters,want", CASES)
def test_reader_gives_its_value(metric, counters, want):
    assert harness.reader(metric)(record(counters)) == pytest.approx(want)


@pytest.mark.parametrize("metric", [m for m, _, _ in CASES])
def test_reader_gives_none_without_its_counters(metric):
    """The parent program has none of these counters."""
    old = {"bbit_linear_fwd": 100, "bbit_linear_bwd_dw": 50,
           "bbit_linear_bwd_dw_plans": 0, "minhash_pack": 35}
    assert harness.reader(metric)(record(old)) is None


@pytest.mark.parametrize("metric", [m for m, _, _ in CASES
                                    if m != "tron.copy_mb_per_fit"])
def test_reader_gives_none_where_tracing_recorded_nothing(metric):
    """Spans at zero (no profiler ran), and B8 built and served no plan
    (its plain version ran)."""
    zero = {k: 0 for k in {**TRON_COUNTERS, **ENCODE_COUNTERS}}
    if metric in ("tron.host_reads_per_fit", "tron.cg_steps_per_fit"):
        zero = {}                     # counters always on: only absent
    assert harness.reader(metric)(record(zero)) is None


def test_plan_hit_share_counts_builds_in_the_window():
    got = harness.reader("tron.plan_hit_pct")(record(
        {"bbit_linear_bwd_dw_plan_hits": 3, "bbit_linear_bwd_dw_plans": 1}))
    assert got == pytest.approx(75.0)


def test_traced_rehearsal_carries_the_programs_counters(monkeypatch):
    """A traced run of the TRON cell at the rehearsal size on the CPU: its
    record holds every ``span.*`` and ``tron.*`` counter of the program
    (the spans at zero: no profiler records on the CPU), and the
    counter readers report."""
    seen = []
    real = harness.reader

    def spy(metric):
        read = real(metric)

        def wrapped(rec):
            seen.append(rec)
            return read(rec)
        return wrapped

    monkeypatch.setattr(harness, "reader", spy)
    cell = harness.load_cell(TRON, rehearsal=True)
    out = harness.run_cell(cell, 2 ** 31 + 91, 0.2, True, "cpu",
                           time.perf_counter())
    assert out["result"]["correct"]
    counters = seen[0].counters
    for name in ("tron.host_reads", "tron.cg_steps", "trainer.h2d_bytes",
                 "trainer.d2h_bytes", "bbit_linear_bwd_dw_plan_hits"):
        assert name in counters, name
    spans = {k for k in counters if k.startswith("span.")}
    for name in ("trainer.fit", "trainer.accuracy", "tron.minimize",
                 "tron.iter", "tron.cg_step", "tron.read"):
        assert f"span.{name}.ns" in spans, name
    assert all(counters[k] == 0 for k in spans)
    metrics = out["result"]["metrics"]
    fits = out["window"].calls
    assert metrics["tron.host_reads_per_fit"]["value"] == \
        counters["tron.host_reads"] / fits > 0
    assert metrics["tron.cg_steps_per_fit"]["value"] > 0
    assert metrics["tron.copy_mb_per_fit"]["value"] == 0.0
    for name in ("tron.read_wait_pct", "tron.accuracy_ms_per_fit",
                 "tron.plan_hit_pct"):
        assert name not in metrics, name
