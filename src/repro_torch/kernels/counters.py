"""Counters of kernel launches and of plain-version calls (``kernels.ops``).

A run shows that its main path went through the kernels by setting the
counts to zero just before it and reading them just after
(``chip_smoke.py``, the engine's ``stats()``).
"""
from __future__ import annotations

import threading


class LaunchCount:
    """A thread-safe event count (the engine launches from its drain
    thread while callers may score synchronously)."""

    def __init__(self):
        self._n = 0
        self._lock = threading.Lock()

    def add(self) -> None:
        with self._lock:
            self._n += 1

    def reset(self) -> None:
        with self._lock:
            self._n = 0

    @property
    def value(self) -> int:
        return self._n
