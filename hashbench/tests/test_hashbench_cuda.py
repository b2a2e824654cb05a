"""On the card (marked ``cuda``; skips without one): each cell at its
rehearsal size through the kernels, correct, with no plain call."""
import time

import pytest

from hashbench import harness


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ("tron-bbit-k500-b16",
                                      "encode-minwise-k500-b16",
                                      "encode-oph-k256-b8"))
def test_a_small_cell_runs_on_the_kernels(cuda_device, workload):
    cell = harness.load_cell(workload, rehearsal=True)
    name = [m["name"] for m in cell.per_layer
            if m["name"].endswith("plain_calls")][0]
    out = harness.run_cell(cell, 2 ** 31 + 5, 0.5, True, cuda_device,
                           time.perf_counter())
    result = out["result"]
    assert result["correct"], out["checks"]
    assert result["metrics"][name]["value"] == 0
    assert result["device"]["busy_s"] > 0
