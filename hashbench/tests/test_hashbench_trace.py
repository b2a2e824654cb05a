"""The reduction of a profile: busy and idle time within the window, the
harness's spans left off the device's timeline, gaps charged to the
innermost host operation."""
import types

import pytest
from torch.autograd import DeviceType

from hashbench import trace


def event(name, start, end, device=False):
    return types.SimpleNamespace(
        name=lambda: name, start_ns=lambda: start,
        duration_ns=lambda: end - start,
        device_type=lambda: DeviceType.CUDA if device else DeviceType.CPU)


def profile(events):
    results = types.SimpleNamespace(events=lambda: events)
    return types.SimpleNamespace(
        profiler=types.SimpleNamespace(kineto_results=results))


def test_busy_idle_and_charged_gaps():
    events = [
        event(trace.WINDOW, 0, 1000),
        event("encode_packed", 0, 400), event("cudaLaunchKernel", 100, 150),
        event("encode_packed", 0, 1000, device=True),     # a mirrored span
        event("kernel_a", 200, 500, device=True),
        event("kernel_a", 450, 600, device=True),         # overlaps
        event("memcpy", 800, 900, device=True),
        event("kernel_b", 950, 1200, device=True),        # clipped at 1000
        event("cudaDeviceSynchronize", 600, 800),
    ]
    p = trace.read_profile(profile(events), ["encode_packed"])
    assert p.window_s == pytest.approx(1e-6)
    assert p.busy_s == pytest.approx(550e-9)             # 200-600, 800-900, 950-1000
    assert p.kernel_s["kernel_a"] == pytest.approx(450e-9)
    assert p.kernel_s["kernel_b"] == pytest.approx(50e-9)
    assert "encode_packed" not in p.kernel_s
    gaps = dict(p.idle_gaps)
    # 0-200 (midpoint 100: the launch, shorter than the span holding it),
    # 600-800 (the sync), 900-950 (no host event: idle)
    assert gaps["cudaLaunchKernel"] == pytest.approx(200e-9)
    assert gaps["cudaDeviceSynchronize"] == pytest.approx(200e-9)
    assert gaps["idle"] == pytest.approx(50e-9)
    assert sum(gaps.values()) == pytest.approx(p.window_s - p.busy_s)


def test_a_profile_without_the_window_is_refused():
    with pytest.raises(RuntimeError):
        trace.read_profile(profile([event("x", 0, 1)]))
