"""Admission control: bounded in-flight work, fast rejection, drain (a
copy of ``repro/serving/admission.py``, standard library only).

The batcher's lanes and its dispatch queue are bounded; the one place
unbounded queueing could creep back in is the network front door.  An
``AdmissionController`` closes that hole with a single rule: the rows
admitted but not yet answered never exceed ``limit``.

  * BUDGET — ``limit`` defaults to what the engine pipeline can
    genuinely hold concurrently: ``(pipeline depth + 1) dispatched or
    draining batches × the max row bucket per batch × the number of
    nnz lanes`` (``for_engine``).  Rows beyond that would only sit in
    an unbounded queue inflating tail latency, so they are REJECTED
    FAST instead: ``Overloaded`` → HTTP 429 with ``Retry-After``, the
    client's signal to back off or go to another replica.  A single
    request asking for more rows than the whole budget can never be
    admitted and is rejected immediately for the same reason.
  * DRAIN — ``begin_drain()`` flips the controller one-way into
    refusing all new work (``Draining`` → HTTP 503) while already-
    admitted rows keep their slots until released; ``wait_idle()``
    blocks until the last one finishes.  Together with the batcher's
    ``close()`` flush contract this yields the shutdown guarantee: no
    request is ever silently dropped — each either resolves normally
    or is refused with a clear retriable status before any work is
    done on it.

Thread-safe; ``acquire``/``release`` are O(1) under one lock shared
with the idle-waiter condition.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Dict, Optional


class Overloaded(RuntimeError):
    """In-flight budget exhausted — reject fast, retry after a beat."""

    def __init__(self, message: str, retry_after_s: float):
        super().__init__(message)
        self.retry_after_s = retry_after_s


class Draining(RuntimeError):
    """The server is shutting down and refuses new work."""


class AdmissionController:
    def __init__(self, limit: int, retry_after_s: float = 0.05):
        if limit < 1:
            raise ValueError(f"in-flight limit must be >= 1, got {limit}")
        self.limit = int(limit)
        self.retry_after_s = float(retry_after_s)
        self._cond = threading.Condition()
        self._inflight = 0
        self._draining = False
        self.admitted = 0          # rows ever admitted
        self.rejected = 0          # rows refused with Overloaded
        self.refused_draining = 0  # rows refused because draining

    @classmethod
    def for_engine(cls, engine, retry_after_s: float = 0.05,
                   headroom: float = 1.0) -> "AdmissionController":
        """Budget derived from the engine's real concurrency: one batch
        being assembled plus ``pipeline_depth`` dispatched batches, per
        nnz lane, each at the largest row bucket."""
        depth = getattr(engine.batcher, "depth", 1)
        rows = max(engine.row_buckets)
        lanes = max(len(engine.nnz_buckets), 1)
        limit = max(1, int((depth + 1) * rows * lanes * headroom))
        return cls(limit, retry_after_s=retry_after_s)

    # ------------------------------------------------------ lifecycle ----
    @property
    def inflight(self) -> int:
        with self._cond:
            return self._inflight

    @property
    def draining(self) -> bool:
        with self._cond:
            return self._draining

    def acquire(self, rows: int = 1) -> None:
        """Admit ``rows`` units of work or raise (never queues)."""
        if rows < 1:
            raise ValueError(f"rows must be >= 1, got {rows}")
        with self._cond:
            if self._draining:
                self.refused_draining += rows
                raise Draining("server is draining; no new work accepted")
            if self._inflight + rows > self.limit:
                self.rejected += rows
                raise Overloaded(
                    f"in-flight budget exhausted ({self._inflight}"
                    f"/{self.limit} rows in flight, {rows} requested)",
                    retry_after_s=self.retry_after_s)
            self._inflight += rows
            self.admitted += rows

    def release(self, rows: int = 1) -> None:
        with self._cond:
            self._inflight -= rows
            if self._inflight < 0:          # release without acquire
                self._inflight = 0
            if self._inflight == 0:
                self._cond.notify_all()

    @contextlib.contextmanager
    def slot(self, rows: int = 1):
        self.acquire(rows)
        try:
            yield
        finally:
            self.release(rows)

    def begin_drain(self) -> None:
        """One-way flip into refusing new work (idempotent)."""
        with self._cond:
            self._draining = True
            self._cond.notify_all()

    def wait_idle(self, timeout: Optional[float] = None) -> bool:
        """Block until every admitted row has been released (True) or
        the timeout expires (False)."""
        with self._cond:
            return self._cond.wait_for(lambda: self._inflight == 0,
                                       timeout=timeout)

    def snapshot(self) -> Dict:
        with self._cond:
            return {"inflight": self._inflight, "limit": self.limit,
                    "draining": self._draining,
                    "admitted": self.admitted,
                    "rejected": self.rejected,
                    "refused_draining": self.refused_draining}
