"""The reader of B7's slice schedule: the share of B7's calls that walked
the bins in L2-sized slices, on synthetic records, and none where the
program has no such counter (one pass over all bins in every call) or
launched no B7 (a CPU run takes the plain version)."""
import pytest

from hashbench import harness
from hashbench.trace import Record

METRIC = "tron.b7_sliced_pct"
SLICED = "bbit_linear_fwd_sliced"


def record(counters, calls=4, wall_s=2.0):
    return Record(calls=calls, wall_s=wall_s, counters=counters, spans={},
                  values={}, shapes={}, peaks=None, profile=None)


@pytest.mark.parametrize("counters,want", [
    ({"bbit_linear_fwd": 340, SLICED: 340}, 100.0),
    ({"bbit_linear_fwd": 340, SLICED: 330}, 97.05882352941177),
    ({"bbit_linear_fwd": 200, "bbit_linear_fwd_bf16": 200, SLICED: 100},
     25.0),
    ({"bbit_linear_fwd": 85, SLICED: 0}, 0.0),   # every call one pass
])
def test_reader_gives_its_value(counters, want):
    assert harness.reader(METRIC)(record(counters)) == pytest.approx(want)


@pytest.mark.parametrize("counters", [
    {"bbit_linear_fwd": 340, "bbit_linear_bwd_dw": 186,
     "bbit_linear_bwd_dw_plan_hits": 186},
    {"bbit_linear_fwd": 0, SLICED: 0},
    {"bbit_linear_fwd_plain": 340, SLICED: 0},
    {},
])
def test_reader_gives_none_without_the_counter_or_launches(counters):
    """The parent program has no slice counter; a window with no launch of
    B7 (the plain version on the CPU) reads nothing either."""
    assert harness.reader(METRIC)(record(counters)) is None
