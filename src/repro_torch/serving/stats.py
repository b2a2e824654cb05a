"""Rolling serving statistics: latency window, tenants, nnz histogram.

Production serving needs live numbers without a metrics dependency and
without a hot-path lock fight.  Two primitives, both O(1) per request
and lock-cheap (one short critical section around an index bump —
percentile math happens on a copied slice at ``snapshot()`` time, never
under the lock):

  * ``StatsWindow`` — a fixed-size ring buffer of per-request
    ``(done_at, latency, rows)`` samples plus per-tenant request
    counters.  ``snapshot()`` returns rolling p50/p95/p99 latency,
    rows/s over the window's actual time span, error and total counts.
    Old samples fall out by being overwritten, so the window always
    reflects *recent* traffic — exactly what ``GET /status`` should
    show after a traffic shift, not a lifetime average.

  * ``NnzHistogram`` — power-of-two-binned counts of observed document
    sizes (bin ``j`` holds nnz in ``(2^(j-1), 2^j]``), feeding
    ``suggest_buckets()``: re-derive a padded-width bucket grid from
    live traffic instead of static config.  The suggestion covers
    ``coverage`` of the observed mass with at most ``max_buckets``
    pow-2 edges placed at cumulative-count quantiles, so a skewed
    workload (say, everything around nnz≈40 under a default grid that
    starts at 128) converges to a tighter grid with ~3× less padding
    per batch.  Traffic above the grid still serves — the engine grows
    past the top bucket by powers of two, it just pays a compile.
"""
from __future__ import annotations

import collections
import threading
import time
from typing import Dict, Optional, Sequence, Tuple

import numpy as np


class StatsWindow:
    """Fixed-size ring of per-request samples; thread-safe."""

    def __init__(self, size: int = 2048):
        if size < 1:
            raise ValueError(f"window size must be >= 1, got {size}")
        self.size = size
        self._lat = np.zeros(size, np.float64)     # seconds
        self._rows = np.zeros(size, np.int64)
        self._done = np.zeros(size, np.float64)    # perf_counter stamps
        self._n = 0                                # lifetime count
        self._errors = 0
        self._tenants: collections.Counter = collections.Counter()
        self._lock = threading.Lock()

    def record(self, latency_s: float, rows: int = 1,
               tenant: Optional[str] = None, error: bool = False) -> None:
        now = time.perf_counter()
        with self._lock:
            i = self._n % self.size
            self._lat[i] = latency_s
            self._rows[i] = rows
            self._done[i] = now
            self._n += 1
            if error:
                self._errors += 1
            if tenant is not None:
                self._tenants[str(tenant)] += rows

    def record_batch(self, latency_s: float, count: int,
                     tenant: Optional[str] = None) -> None:
        """``count`` identical single-row samples under ONE lock
        acquisition + vectorized ring write — the batch front door's
        cache-hit path resolves whole chunks at the same instant, and
        per-row ``record`` locking is measurable at that rate."""
        if count <= 0:
            return
        now = time.perf_counter()
        with self._lock:
            idx = (self._n + np.arange(count)) % self.size
            self._lat[idx] = latency_s
            self._rows[idx] = 1
            self._done[idx] = now
            self._n += count
            if tenant is not None:
                self._tenants[str(tenant)] += count

    @property
    def count(self) -> int:
        return self._n

    def snapshot(self) -> Dict:
        """Rolling percentiles + throughput over the live window (copy
        under the lock, math outside it)."""
        with self._lock:
            m = min(self._n, self.size)
            lat = self._lat[:m].copy()
            rows = self._rows[:m].copy()
            done = self._done[:m].copy()
            n, errors = self._n, self._errors
            tenants = dict(self._tenants)
        out = {"count": n, "errors": errors, "window": m,
               "per_tenant_rows": tenants,
               "p50_ms": 0.0, "p95_ms": 0.0, "p99_ms": 0.0,
               "rows_per_s": 0.0, "window_span_s": 0.0}
        if m == 0:
            return out
        ms = lat * 1e3
        out["p50_ms"] = float(np.percentile(ms, 50))
        out["p95_ms"] = float(np.percentile(ms, 95))
        out["p99_ms"] = float(np.percentile(ms, 99))
        # throughput over the span the window actually covers; a
        # single-sample window has no span — report 0 rather than inf
        span = float(done.max() - done.min())
        out["window_span_s"] = span
        if span > 0:
            out["rows_per_s"] = float(rows.sum()) / span
        return out


def _pow2_edge(n: int) -> int:
    """Smallest power of two >= n (n >= 1)."""
    return 1 << max(int(n) - 1, 0).bit_length()


class NnzHistogram:
    """Pow-2-binned document-size counts; thread-safe, O(1) record."""

    MAX_BIN = 32          # nnz up to 2^32 — beyond any real document

    def __init__(self):
        self._counts = [0] * (self.MAX_BIN + 1)
        self._lock = threading.Lock()

    def record(self, n: int) -> None:
        j = min(max(int(n) - 1, 0).bit_length(), self.MAX_BIN)
        with self._lock:
            self._counts[j] += 1

    def record_many(self, ns: Sequence[int]) -> None:
        """Batch ``record`` under one lock acquisition."""
        if not ns:
            return
        with self._lock:
            for n in ns:
                j = min(max(int(n) - 1, 0).bit_length(), self.MAX_BIN)
                self._counts[j] += 1

    @property
    def total(self) -> int:
        with self._lock:
            return sum(self._counts)

    def counts(self) -> Dict[int, int]:
        """→ {pow2_upper_edge: count} for non-empty bins."""
        with self._lock:
            c = list(self._counts)
        return {1 << j: c[j] for j in range(len(c)) if c[j]}

    def suggest_buckets(self, max_buckets: int = 6,
                        coverage: float = 0.995,
                        min_samples: int = 64) -> Optional[Tuple[int, ...]]:
        """Derive a padded-width bucket grid from observed traffic.

        Drops the ``1 - coverage`` upper tail (one outlier must not pin
        a giant top bucket), then places at most ``max_buckets`` pow-2
        edges at cumulative-count quantiles so each bucket carries a
        comparable share of traffic.  Returns ``None`` when fewer than
        ``min_samples`` documents have been seen — too little signal to
        re-derive a grid from.
        """
        if max_buckets < 1:
            raise ValueError(f"max_buckets must be >= 1, got {max_buckets}")
        with self._lock:
            c = list(self._counts)
        total = sum(c)
        if total < min_samples:
            return None
        # cutoff bin: smallest prefix holding >= coverage of the mass
        target = coverage * total
        cum, cutoff = 0, len(c) - 1
        for j, cnt in enumerate(c):
            cum += cnt
            if cum >= target:
                cutoff = j
                break
        live = [j for j in range(cutoff + 1) if c[j]]
        if not live:
            return None
        if len(live) <= max_buckets:
            return tuple(1 << j for j in live)
        # thin to quantile edges; the cutoff bin always stays (it is
        # what makes the grid cover `coverage` of traffic)
        covered = sum(c[: cutoff + 1])
        edges, cum, want = [], 0, 1
        for j in live:
            cum += c[j]
            if cum >= covered * want / max_buckets:
                edges.append(j)
                want += 1
        if edges[-1] != live[-1]:
            edges[-1] = live[-1]
        return tuple(1 << j for j in sorted(set(edges)))
