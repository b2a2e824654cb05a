"""Dynamic request batching for the serving engine (``DynamicBatcher``
and ``BucketBatcher`` of ``repro/serving/batcher.py``, on the port's own
modules).  Both share the submit()→Future contract.

``DynamicBatcher`` — the classic single-queue front half: requests
queue up, a background worker drains up to ``max_batch`` at a time (or
whatever arrived within ``max_wait_ms``), runs them as one batch and
resolves per-request futures.  One queue means one shape lane, and the
worker waits on each batch before it pads the next.

``BucketBatcher`` — shape-bucketed, overlapped micro-batching:

  * LANE ROUTING — ``route(item)`` assigns each request a lane key at
    submit time (the engine keys lanes by padded-nnz bucket), so
    requests only ever batch with shape-compatible peers and a giant
    document never inflates a small batch's padding;
  * OVERLAP — the drain thread pads and DISPATCHES a batch (CUDA
    launches return before the device finishes) and immediately
    starts padding the next one, while a separate resolver thread
    blocks on the device→host sync and resolves futures.  Up to
    ``depth`` dispatched batches wait in a bounded queue (backpressure:
    the drain thread stalls rather than flooding the device), so host
    padding of batch N+1 overlaps device compute of batch N;
  * DETERMINISTIC CLOSE — ``close()`` refuses new submits, flushes
    every pending request (or fails its future if the dispatch fn
    raises) and joins both threads; no future ever hangs.
  * OBSERVABILITY — ``depths()`` snapshots per-lane occupancy and the
    in-flight dispatch queue; a ``ft.watchdog.StepWatchdog`` over
    per-batch dispatch+resolve latency backs ``health()``: a drain or
    resolve call stuck past ``stall_after_s`` (or far past the rolling
    median) reports ``degraded`` so a front end can fail its health
    check instead of letting clients hang on silent futures.
  * ADAPTIVE BUCKETS — ``submit`` records each item's size (``size``
    hook, default ``len``) into a pow-2 histogram;
    ``suggest_buckets()`` re-derives a lane grid from that observed
    traffic (see ``serving.stats.NnzHistogram``).

On ``close()`` of either, every future returned by a successful
``submit`` is done (result or exception) before ``close`` returns, and
a ``submit`` racing with ``close`` either wins (its future resolves) or
raises ``RuntimeError`` — it cannot silently hang.
"""
from __future__ import annotations

import collections
import queue
import threading
import time
from concurrent.futures import Future
from typing import Callable, Dict, Hashable, List, Optional, Sequence, \
    Tuple

from repro_torch.ft.watchdog import StepWatchdog
from repro_torch.serving.stats import NnzHistogram

_CLOSE = object()          # queue sentinel: enqueued once, after the
                           # last accepted submit (submits after close
                           # raise, so nothing ever follows it)


def _set_result(fut: Future, out) -> None:
    """Resolve a future a client may have cancel()ed meanwhile (a
    pending concurrent.futures.Future always accepts cancel): a raw
    set_result would raise InvalidStateError and either kill the
    worker thread or poison its batch-mates' futures."""
    if not fut.done():
        try:
            fut.set_result(out)
        except Exception:  # noqa: BLE001 — lost the cancel race
            pass


def _set_exception(fut: Future, exc: BaseException) -> None:
    if not fut.done():
        try:
            fut.set_exception(exc)
        except Exception:  # noqa: BLE001 — lost the cancel race
            pass


class DynamicBatcher:
    def __init__(self, run_batch: Callable[[List], List],
                 max_batch: int = 64, max_wait_ms: float = 2.0):
        self._run_batch = run_batch
        self.max_batch = max_batch
        self.max_wait = max_wait_ms / 1000.0
        self._q: "queue.Queue" = queue.Queue()
        self._lock = threading.Lock()
        self._closed = False
        self._worker = threading.Thread(target=self._loop, daemon=True)
        self._worker.start()
        self.batches_run = 0
        self.requests_served = 0

    def submit(self, item) -> Future:
        fut: Future = Future()
        with self._lock:
            if self._closed:
                raise RuntimeError("DynamicBatcher is closed")
            self._q.put((item, fut))
        return fut

    def _drain(self) -> Tuple[List[Tuple[object, Future]], bool]:
        """→ (items, closing).  FIFO queue + single consumer: once the
        close sentinel surfaces, every accepted request has already
        been drained (possibly into this very batch)."""
        items: List[Tuple[object, Future]] = []
        try:
            first = self._q.get(timeout=0.05)
        except queue.Empty:
            return items, False
        if first is _CLOSE:
            return items, True
        items.append(first)
        deadline = time.perf_counter() + self.max_wait
        while len(items) < self.max_batch:
            timeout = deadline - time.perf_counter()
            if timeout <= 0:
                break
            try:
                nxt = self._q.get(timeout=timeout)
            except queue.Empty:
                break
            if nxt is _CLOSE:
                return items, True
            items.append(nxt)
        return items, False

    def _loop(self) -> None:
        closing = False
        while not closing:
            batch, closing = self._drain()
            if not batch:
                continue
            inputs = [b[0] for b in batch]
            try:
                outputs = self._run_batch(inputs)
                for (_, fut), out in zip(batch, outputs):
                    _set_result(fut, out)
            except Exception as e:  # noqa: BLE001
                for _, fut in batch:
                    _set_exception(fut, e)
            self.batches_run += 1
            self.requests_served += len(batch)

    def close(self) -> None:
        """Flush-or-fail every pending request, then join the worker.

        Requests already accepted are still batched and resolved (or
        failed with ``run_batch``'s exception); submits from here on
        raise.  Idempotent.  Raises if the worker cannot flush within
        the timeout — returning silently would break the every-future-
        is-done contract."""
        with self._lock:
            if not self._closed:
                self._closed = True
                self._q.put(_CLOSE)
        self._worker.join(timeout=60.0)
        if self._worker.is_alive():
            raise RuntimeError(
                "DynamicBatcher worker failed to flush within 60s — "
                "pending futures may be unresolved (run_batch stuck?)")


class BucketBatcher:
    """Per-lane micro-batching with dispatch/resolve overlap.

    ``route(item) -> key`` picks the lane; ``dispatch(key, items) ->
    handle`` runs on the drain thread (pad + async device dispatch —
    it must NOT block on device completion); ``resolve(handle) ->
    per-item results`` runs on the resolver thread (the blocking
    device→host sync lives here, off the drain loop).

    A lane is drained when it reaches its cap (``lane_caps[key]`` where
    given — the cost model's measured throughput-optimal micro-batch
    for that lane — else the global ``max_batch``) or its oldest
    request has waited ``max_wait_ms``; a full lane dispatches
    immediately (never queues behind another lane's not-yet-ripe head),
    otherwise lanes compete oldest-head-first so none starves.  At most
    ``depth`` dispatched-but-unresolved batches are in flight (bounded
    handoff queue).
    """

    def __init__(self, dispatch: Callable[[Hashable, List], object],
                 resolve: Callable[[object], Sequence],
                 route: Callable[[object], Hashable],
                 max_batch: int = 64, max_wait_ms: float = 2.0,
                 depth: int = 2,
                 size: Callable[[object], int] = len,
                 watchdog: Optional[StepWatchdog] = None,
                 stall_after_s: float = 10.0,
                 lane_caps: Optional[Dict[Hashable, int]] = None):
        if depth < 1:
            raise ValueError(f"pipeline depth must be >= 1, got {depth}")
        self._dispatch = dispatch
        self._resolve = resolve
        self._route = route
        self._size = size
        self.max_batch = max_batch
        self.lane_caps = dict(lane_caps or {})
        self.max_wait = max_wait_ms / 1000.0
        self.depth = depth
        self._cond = threading.Condition()
        self._lanes: dict = {}     # key -> deque[(item, fut, t_enq)]
        self._flush_before = -1.0  # heads enqueued at/before this are ripe
        self._closed = False
        self._resq: "queue.Queue" = queue.Queue(maxsize=depth)
        self.batches_run = 0
        self.requests_served = 0
        self.size_hist = NnzHistogram()
        # per-batch dispatch+resolve latency window; a batch far past
        # the rolling median flags slow, and a dispatch/resolve call
        # that never returns shows up as a live stall in ``health()``
        self.watchdog = watchdog or StepWatchdog(threshold=4.0,
                                                 window=64,
                                                 escalate_after=3)
        self.stall_after_s = stall_after_s
        self._dispatch_started: Optional[float] = None
        self._resolve_started: Optional[float] = None
        self._drainer = threading.Thread(target=self._drain_loop,
                                         daemon=True, name="serve-drain")
        self._resolver = threading.Thread(target=self._resolve_loop,
                                          daemon=True,
                                          name="serve-resolve")
        self._drainer.start()
        self._resolver.start()

    def submit(self, item) -> Future:
        fut: Future = Future()
        key = self._route(item)
        try:
            n = int(self._size(item))
        except TypeError:
            n = 0
        with self._cond:
            if self._closed:
                raise RuntimeError("BucketBatcher is closed")
            self._lanes.setdefault(key, collections.deque()).append(
                (item, fut, time.perf_counter()))
            self._cond.notify()
        self.size_hist.record(n)
        return fut

    def flush(self) -> None:
        """Ripen every currently queued head NOW: the drain thread
        dispatches all pending lanes without waiting out ``max_wait``.
        For end-of-stream clients and graceful drain — a caller that
        knows no more traffic is coming should not leave the tail
        request sitting in a half-full lane for a full coalescing
        window.  Requests submitted after the call batch normally."""
        with self._cond:
            self._flush_before = time.perf_counter()
            self._cond.notify_all()

    # ------------------------------------------------- observability --
    def depths(self) -> Dict:
        """Queue-depth snapshot: per-lane occupancy + dispatched-but-
        unresolved batches (the bounded overlap queue)."""
        with self._cond:
            lanes = {key: len(lane) for key, lane in self._lanes.items()
                     if lane}
        return {"lanes": lanes, "queued": sum(lanes.values()),
                "inflight_batches": self._resq.qsize(),
                "depth": self.depth}

    def suggest_buckets(self, max_buckets: int = 6,
                        coverage: float = 0.995,
                        min_samples: int = 64):
        """Lane grid re-derived from the observed item-size histogram
        (``None`` until ``min_samples`` items have been seen)."""
        return self.size_hist.suggest_buckets(
            max_buckets=max_buckets, coverage=coverage,
            min_samples=min_samples)

    def health(self) -> Dict:
        """→ {"state": "ok"|"degraded", ...}.  Degraded when the drain
        (dispatch) or resolver thread has been inside one call longer
        than ``stall_after_s`` — the precursor to every client future
        hanging — or when the watchdog escalated a persistent-straggler
        verdict on recent batches."""
        now = time.perf_counter()
        stalled, stalled_s = None, 0.0
        for name, t0 in (("dispatch", self._dispatch_started),
                         ("resolve", self._resolve_started)):
            if t0 is not None and now - t0 > self.stall_after_s:
                if now - t0 > stalled_s:
                    stalled, stalled_s = name, now - t0
        state = "degraded" if (stalled or self.watchdog.escalations) \
            else "ok"
        return {"state": state, "stalled_thread": stalled,
                "stalled_s": round(stalled_s, 3),
                "slow_batches": len(self.watchdog.flagged_steps),
                "escalations": len(self.watchdog.escalations)}

    def _lane_cap(self, key) -> int:
        cap = self.lane_caps.get(key, self.max_batch)
        return max(1, min(int(cap), self.max_batch))

    def _pick_locked(self):
        """→ (key, head_enq_time, full) or None.  A FULL lane (≥ its
        cap) wins outright — it is dispatchable NOW and must not
        wait behind an older-but-not-yet-ripe head in another lane;
        otherwise the oldest head (latency fairness)."""
        best = None
        for key, lane in self._lanes.items():
            if not lane:
                continue
            if len(lane) >= self._lane_cap(key):
                return (key, lane[0][2], True)
            if best is None or lane[0][2] < best[1]:
                best = (key, lane[0][2], False)
        return best

    def _drain_loop(self) -> None:
        while True:
            with self._cond:
                batch = key = None
                while True:
                    pick = self._pick_locked()
                    if pick is None:
                        if self._closed:
                            break
                        self._cond.wait()
                        continue
                    key, t_head, full = pick
                    lane = self._lanes[key]
                    age = time.perf_counter() - t_head
                    if (full or self._closed or age >= self.max_wait
                            or t_head <= self._flush_before):
                        batch = [lane.popleft() for _ in
                                 range(min(len(lane),
                                           self._lane_cap(key)))]
                        break
                    # head not ripe: sleep at most until it is (an
                    # incoming submit notifies earlier)
                    self._cond.wait(timeout=self.max_wait - age)
            if batch is None:       # closed + everything flushed
                self._resq.put(_CLOSE)
                return
            futs = [f for _, f, _ in batch]
            t_disp = time.perf_counter()
            self._dispatch_started = t_disp
            try:
                handle = self._dispatch(key, [x for x, _, _ in batch])
            except Exception as e:  # noqa: BLE001
                self._dispatch_started = None
                for f in futs:
                    _set_exception(f, e)
                continue
            self._dispatch_started = None
            self.batches_run += 1
            self._resq.put((handle, futs, t_disp))  # bounded → backpressure

    def _resolve_loop(self) -> None:
        while True:
            entry = self._resq.get()
            if entry is _CLOSE:
                return
            handle, futs, t_disp = entry
            self._resolve_started = time.perf_counter()
            try:
                outs = self._resolve(handle)
                for f, out in zip(futs, outs):
                    _set_result(f, out)
            except Exception as e:  # noqa: BLE001
                for f in futs:
                    _set_exception(f, e)
            self._resolve_started = None
            self.requests_served += len(futs)
            # one watchdog step per batch: dispatch → futures resolved
            self.watchdog.end_step(
                self.batches_run,
                duration=time.perf_counter() - t_disp)

    def close(self) -> None:
        """Flush every lane (or fail futures on dispatch/resolve
        errors), then join both threads.  Idempotent.  Raises if the
        pipeline cannot flush within the timeout — returning silently
        would break the every-future-is-done contract."""
        with self._cond:
            self._closed = True
            self._cond.notify_all()
        self._drainer.join(timeout=60.0)
        self._resolver.join(timeout=60.0)
        if self._drainer.is_alive() or self._resolver.is_alive():
            raise RuntimeError(
                "BucketBatcher failed to flush within 60s — pending "
                "futures may be unresolved (dispatch/resolve stuck?)")

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
