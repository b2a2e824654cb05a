"""What a traced run records, and the readers' view of it.

The window runs under ``torch.profiler`` (CPU and CUDA activities) inside
a span named ``WINDOW``.  ``read_profile`` reduces the profile to the
device time of each kernel by name, the device's busy seconds within
the window (the union of every kernel, copy and set on the device), the
window's length, the device operations that took most time, and the
idle gaps, each charged to the innermost host operation running at its
midpoint.  The harness's spans, which the profiler mirrors on the
device's timeline, are not device work and are left out there.
``Record`` carries that, with the window's counters, spans
and shapes, to the per-layer readers (``metrics/<name>.py``).
"""
from __future__ import annotations

import dataclasses
import heapq
from collections import defaultdict
from typing import Dict, Iterable, List, Optional, Tuple

WINDOW = "hashbench.window"
NAME_CHARS = 80


@dataclasses.dataclass
class Profile:
    kernel_s: Dict[str, float]
    busy_s: float
    window_s: float
    device_ops: List[Tuple[str, float]]
    idle_gaps: List[Tuple[str, float]]


def _merge(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[Tuple[int, int]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


def _charge_gaps(gaps: List[Tuple[int, int]],
                 host: List[Tuple[int, int, str]]) -> Dict[str, float]:
    """Seconds of each gap, by the shortest host event holding its
    midpoint ('idle' where none does)."""
    points = sorted(((s + e) // 2, e - s) for s, e in gaps)
    host = sorted(host)
    out: Dict[str, float] = defaultdict(float)
    active: list = []
    i = 0
    for t, length in points:
        while i < len(host) and host[i][0] <= t:
            s, e, name = host[i]
            heapq.heappush(active, (e - s, e, name))
            i += 1
        while active and active[0][1] < t:
            heapq.heappop(active)
        out[active[0][2] if active else "idle"] += length * 1e-9
    return out


def read_profile(prof, spans: Iterable[str] = ()) -> Profile:
    """``spans``: the names of the harness's spans, which the profiler
    mirrors on the device's timeline."""
    from torch.autograd import DeviceType
    mirrored = set(spans) | {WINDOW}
    device, host = [], []
    window = None
    for e in prof.profiler.kineto_results.events():
        s = e.start_ns()
        end = s + e.duration_ns()
        if e.device_type() == DeviceType.CUDA:
            if e.name() not in mirrored:
                device.append((s, end, e.name()))
        else:
            name = e.name()
            if name == WINDOW:
                window = (s, end)
            else:
                host.append((s, end, name))
    if window is None:
        raise RuntimeError(f"the profile holds no {WINDOW} span")
    w0, w1 = window
    kernel_s: Dict[str, float] = defaultdict(float)
    clipped = []
    for s, e, name in device:
        s, e = max(s, w0), min(e, w1)
        if e > s:
            kernel_s[name] += (e - s) * 1e-9
            clipped.append((s, e))
    busy = _merge(clipped)
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    idle = _charge_gaps(gaps, [h for h in host if h[1] > w0 and h[0] < w1])
    top = lambda d: [[name[:NAME_CHARS], sec] for name, sec in
                     sorted(d.items(), key=lambda kv: -kv[1])[:10]]
    return Profile(dict(kernel_s), sum(e - s for s, e in busy) * 1e-9,
                   (w1 - w0) * 1e-9, top(kernel_s), top(idle))


@dataclasses.dataclass
class Record:
    """One run's window, as the per-layer readers see it.

    ``calls``: the timed calls completed (fits, or encode passes);
    ``wall_s``: the window's host seconds; ``counters``: the change of
    ``repro_torch.kernels.ops.counts()`` over the window; ``spans``:
    {name: (calls, host seconds)} of the harness's spans around calls
    into the program; ``values``: per-call readings the loop kept
    (``n_iter``); ``shapes``: what the roofline counts need; ``peaks``:
    ``roofline.peaks.for_device``; ``profile``: the device trace (None
    where there is none)."""

    calls: int
    wall_s: float
    counters: Dict[str, int]
    spans: Dict[str, Tuple[int, float]]
    values: Dict[str, list]
    shapes: dict
    peaks: Optional[dict]
    profile: Optional[Profile]

    def counter(self, *names: str) -> int:
        return sum(self.counters.get(n, 0) for n in names)

    def plain_calls(self) -> int:
        return sum(v for n, v in self.counters.items()
                   if n.endswith("_plain"))

    def kernel_seconds(self, parts: Iterable[str]) -> Optional[float]:
        """Device seconds of the kernels whose names hold one of
        ``parts``; None without a trace or where none ran."""
        if self.profile is None:
            return None
        t = sum(sec for name, sec in self.profile.kernel_s.items()
                if any(p in name for p in parts))
        return t if t > 0 else None

    def idle_percent(self) -> Optional[float]:
        p = self.profile
        if p is None or p.window_s <= 0:
            return None
        return 100.0 * (1.0 - p.busy_s / p.window_s)
