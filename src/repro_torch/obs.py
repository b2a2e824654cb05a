"""The port's counters and spans, read through ``kernels.ops.counts()``.

Counters are always on: kernel launches, plain-version calls, B8's plans,
a fit's copies, TRON's host reads.  Each is a ``LaunchCount`` registered
by name (``counter``).  A run shows that its main path went through the
kernels by setting the counts to zero just before it and reading them
just after (``chip_smoke.py``, the engine's ``stats()``).

Spans (``with span(name): ...``) record only while a ``torch.profiler``
profile records or after ``enable()``; off, a span costs one check of
``torch._C._autograd._profiler_enabled()``.  On, each name keeps its
calls, total nanoseconds and self nanoseconds (the total less the time
its child spans cover, on a per-thread stack: the serving engine
launches from its drain thread).  While a profiler records, a span also
enters ``torch._C._profiler._RecordFunctionFast(name)``, so it lands in
the trace as a host operation on the device trace's clock, with no
mirror on the device's timeline (``record_function`` would add one, as
a user annotation).  ``counts()`` shows each span's totals as
``span.<name>.calls``, ``span.<name>.ns`` and ``span.<name>.self_ns``,
zero while tracing is off.

Neither changes a result: with tracing on or off the program computes
the same bits.
"""
from __future__ import annotations

import contextlib
import threading
import time
from typing import Dict, List, Optional

import torch

_profiling = torch._C._autograd._profiler_enabled
# absent in some torch builds: spans then keep their totals only
_FAST = getattr(torch._C._profiler, "_RecordFunctionFast", None)


class LaunchCount:
    """A thread-safe event count (the engine launches from its drain
    thread while callers may score synchronously)."""

    def __init__(self):
        self._n = 0
        self._lock = threading.Lock()

    def add(self, n: int = 1) -> None:
        with self._lock:
            self._n += n

    def reset(self) -> None:
        with self._lock:
            self._n = 0

    @property
    def value(self) -> int:
        return self._n


_LOCK = threading.Lock()
_COUNTERS: Dict[str, LaunchCount] = {}
_SPANS: Dict[str, List[int]] = {}       # name -> [calls, ns, self ns]
_LOCAL = threading.local()
_enabled = False


def counter(name: str, count: Optional[LaunchCount] = None) -> LaunchCount:
    """The counter registered as ``name``, registering ``count`` (or a new
    one) the first time; another counter under a taken name raises."""
    with _LOCK:
        have = _COUNTERS.get(name)
        if have is None:
            have = _COUNTERS[name] = (LaunchCount() if count is None
                                      else count)
        elif count is not None and count is not have:
            raise ValueError(f"obs: the counter {name!r} is registered")
    return have


def declare(*names: str) -> None:
    """Spans shown by ``counts()`` (at zero) before they first record."""
    with _LOCK:
        for name in names:
            _SPANS.setdefault(name, [0, 0, 0])


def enable(on: bool = True) -> None:
    """Spans record with no profiler running too (``on``), or only under
    one (``enable(False)``, the default)."""
    global _enabled
    _enabled = on


def counts() -> Dict[str, int]:
    """Every counter by name, and each span's calls, ns and self ns."""
    with _LOCK:
        out = {name: c.value for name, c in _COUNTERS.items()}
        for name, (calls, ns, self_ns) in _SPANS.items():
            out[f"span.{name}.calls"] = calls
            out[f"span.{name}.ns"] = ns
            out[f"span.{name}.self_ns"] = self_ns
    return out


def reset() -> None:
    """Every counter and span total to zero."""
    with _LOCK:
        for c in _COUNTERS.values():
            c.reset()
        for tot in _SPANS.values():
            tot[:] = [0, 0, 0]


_OFF = contextlib.nullcontext()


class _Span:
    __slots__ = ("name", "fast", "t0", "child")

    def __init__(self, name: str, profiling: bool):
        self.name = name
        self.fast = _FAST(name) if profiling and _FAST is not None else None

    def __enter__(self):
        self.child = 0
        if self.fast is not None:
            self.fast.__enter__()
        stack = getattr(_LOCAL, "stack", None)
        if stack is None:
            stack = _LOCAL.stack = []
        stack.append(self)
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter_ns() - self.t0
        stack = _LOCAL.stack
        stack.pop()
        if stack:
            stack[-1].child += dt
        if self.fast is not None:
            self.fast.__exit__(None, None, None)
        with _LOCK:
            tot = _SPANS.setdefault(self.name, [0, 0, 0])
            tot[0] += 1
            tot[1] += dt
            tot[2] += dt - self.child
        return False


def span(name: str):
    """A context manager timing ``name`` while tracing is on (a profiler
    records, or ``enable()``), a no-op otherwise."""
    profiling = _profiling()
    if profiling or _enabled:
        return _Span(name, profiling)
    return _OFF
