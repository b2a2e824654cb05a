"""The reader of the Hessian product's kept curvature: the share of TRON's
Hessian products that reused their iterate's ℓ″, on synthetic records, none
where the program has neither counter (a program that recomputes X·w in
every product), and read from a traced CPU rehearsal of the TRON cell."""
import time

import pytest

from hashbench import harness
from hashbench.trace import Record

TRON = "tron-bbit-k500-b16"
METRIC = "tron.curvature_reuse_pct"
HITS, BUILDS = "trainer.curvature_hits", "trainer.curvature_builds"


def record(counters, calls=4, wall_s=2.0):
    return Record(calls=calls, wall_s=wall_s, counters=counters, spans={},
                  values={}, shapes={}, peaks=None, profile=None)


@pytest.mark.parametrize("counters,want", [
    ({HITS: 168, BUILDS: 32}, 84.0),
    ({HITS: 3, BUILDS: 1}, 75.0),
    ({HITS: 5}, 100.0),
    ({BUILDS: 2}, 0.0),      # every product at a new iterate: a reading
])
def test_reader_gives_its_value(counters, want):
    assert harness.reader(METRIC)(record(counters)) == pytest.approx(want)


@pytest.mark.parametrize("counters", [
    {"bbit_linear_fwd": 100, "bbit_linear_bwd_dw": 50,
     "tron.host_reads": 200, "tron.cg_steps": 45},
    {HITS: 0, BUILDS: 0},
    {},
])
def test_reader_gives_none_without_products(counters):
    """The parent program has neither counter; a window with no Hessian
    product reads nothing either."""
    assert harness.reader(METRIC)(record(counters)) is None


def test_traced_rehearsal_reads_the_kept_curvature(monkeypatch):
    """A traced run of the TRON cell at the rehearsal size on the CPU
    carries both counters, and its share lies strictly between 0 and 100:
    some products reuse ℓ″, and every iterate with a product builds one."""
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
    out = harness.run_cell(cell, 2 ** 31 + 97, 0.2, True, "cpu",
                           time.perf_counter())
    assert out["result"]["correct"]
    counters = seen[0].counters
    hits, builds = counters[HITS], counters[BUILDS]
    assert hits > 0 and builds > 0
    got = out["result"]["metrics"][METRIC]["value"]
    assert got == pytest.approx(100.0 * hits / (hits + builds))
    assert 0 < got < 100
