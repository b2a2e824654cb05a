"""Serving engine for the b-bit hashed classifier (counterpart of
``repro/serving/engine.py::HashedClassifierEngine``).

Raw sparse documents are served through one pass per micro-batch:

  raw idx/nnz ─▶ scheme.encode_packed (hash → b-bit → pack: kernel B1
  for minwise, B2 for oph / oph_zero) ─▶ bbit_scores_packed (packed
  linear kernel B5) ─▶ scores

so codes travel packed (ceil(k·b/8) bytes per row) and are unpacked in
registers.  Batching is the reference's (``serving.batcher.BucketBatcher``):
documents route to nnz-bucket lanes, a drained batch pads its rows to a
power-of-two row bucket, the drain thread launches batch N+1 while the
card runs batch N, and a resolver thread waits on each batch's CUDA
event and resolves its futures.  ``replicas=N`` keeps one copy of the
weights on each of cuda:0..N-1 and round-robins micro-batches across
them.

Devices: ``device=None`` means ``cuda:0`` and raises when CUDA is
absent; ``device="cpu"`` runs the kernels' plain torch versions.

Empty documents (nnz = 0): zero-coded OPH (``oph_zero``) scores them as
the bias (every bin empty → every contribution masked); ``minwise`` and
densified ``oph`` have no empty semantics and reject them.

Weights are versioned: the live params are one immutable ``WeightSet``,
``swap_weights`` publishes a new one with a single reference swap, and
every score carries the version that produced it (``.version``).
"""
from __future__ import annotations

import threading
import time
from concurrent.futures import Future
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.schemes import make_scheme
from repro_torch.data.packing import bucket_width, pad_rows
from repro_torch.devices import DeviceLike, replica_devices
from repro_torch.kernels import ops
from repro_torch.models.linear import BBitLinearConfig, bbit_scores_packed
from repro_torch.serving.batcher import BucketBatcher
from repro_torch.serving.reload import WeightSet
from repro_torch.serving.stats import StatsWindow

DEFAULT_NNZ_BUCKETS = (128, 512, 2048, 8192, 32768)


class VersionedScore(float):
    """A score that knows which model version produced it — a plain
    ``float`` everywhere (math, JSON, numpy) plus ``.version``."""
    __slots__ = ("version",)

    def __new__(cls, value, version: str):
        obj = super().__new__(cls, value)
        obj.version = version
        return obj


class VersionedVector(np.ndarray):
    """Multiclass twin of ``VersionedScore``: an ndarray row of scores
    carrying ``.version``."""

    def __new__(cls, arr, version: str):
        obj = np.asarray(arr).view(cls)
        obj.version = version
        return obj

    def __array_finalize__(self, obj):
        if obj is not None:
            self.version = getattr(obj, "version", None)


def _grow_bucket(n: int, buckets: Sequence[int]) -> int:
    """Pad width for an nnz of ``n``: the smallest fixed bucket that
    fits, growing by powers of two past the largest one."""
    for b in buckets:
        if n <= b:
            return b
    return bucket_width(n, floor=buckets[-1])


class HashedClassifierEngine:
    def __init__(self, params, cfg: BBitLinearConfig, seed: int = 0,
                 max_batch: int = 64, max_wait_ms: float = 2.0,
                 scheme: str = "minwise", *,
                 device: DeviceLike = None,
                 replicas: int = 1,
                 nnz_buckets: Sequence[int] = DEFAULT_NNZ_BUCKETS,
                 row_buckets: Optional[Sequence[int]] = None,
                 precompile: bool = True,
                 pipeline_depth: int = 2,
                 stats_window: int = 2048,
                 version: str = "v0"):
        self.cfg = cfg
        self.scheme = make_scheme(scheme, cfg.k, seed)
        # zero-coded schemes give an empty doc exact semantics (every
        # bin empty → contributions masked out → score == bias)
        self._allows_empty = getattr(self.scheme, "densify", True) is False
        self.nnz_buckets = tuple(sorted(int(b) for b in nnz_buckets))
        if not self.nnz_buckets:
            raise ValueError("need at least one nnz bucket")
        if row_buckets is None:
            top = bucket_width(max_batch, floor=1)
            row_buckets = tuple(1 << i for i in range(top.bit_length()))
        self.row_buckets = tuple(sorted(int(r) for r in row_buckets))

        self.devices = replica_devices(device, replicas)
        for dev in self.devices:
            self.scheme.hash_params(dev)
        self._weights = WeightSet(version=version,
                                  params=self._stage(params),
                                  created_at=time.time())
        self.reloads = 0
        self._swap_lock = threading.Lock()
        self._rr = 0
        self._rr_lock = threading.Lock()
        self.device_batches = [0] * len(self.devices)
        self.stats_window = StatsWindow(stats_window)
        self._started_at = time.time()

        self.precompile_seconds = 0.0
        if precompile:
            self._precompile()

        self.batcher = BucketBatcher(
            self._dispatch_batch, self._resolve_batch,
            route=lambda doc: self._nnz_bucket(len(doc)),
            max_batch=max_batch, max_wait_ms=max_wait_ms,
            depth=pipeline_depth)

    # ---------------------------------------------------------- weights --
    def _stage(self, params) -> Tuple[dict, ...]:
        """Checks ``params`` against the config and copies them onto every
        replica device (float32, contiguous, owned by the engine)."""
        shapes = {"table": (self.cfg.k, 1 << self.cfg.b, self.cfg.n_out),
                  "bias": (self.cfg.n_out,)}
        if set(params) != set(shapes):
            raise ValueError(f"params must have keys {sorted(shapes)}, got "
                             f"{sorted(params)}")
        for name, shape in shapes.items():
            if tuple(params[name].shape) != shape:
                raise ValueError(
                    f"params[{name!r}] has shape {tuple(params[name].shape)}"
                    f", the config needs {shape} — a hot swap cannot "
                    "change k/b/n_classes")
        host = {name: (params[name] if isinstance(params[name], torch.Tensor)
                       else torch.from_numpy(np.array(params[name],
                                                      np.float32)))
                for name in shapes}
        staged = tuple(
            {name: t.to(device=dev, dtype=torch.float32,
                        copy=True).contiguous()
             for name, t in host.items()}
            for dev in self.devices)
        for dev in self.devices:
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
        return staged

    # ---------------------------------------------------------- buckets --
    def _nnz_bucket(self, n: int) -> int:
        return _grow_bucket(n, self.nnz_buckets)

    def _row_bucket(self, n: int) -> int:
        for r in self.row_buckets:
            if n <= r:
                return r
        return bucket_width(n, floor=self.row_buckets[-1])

    def _precompile(self) -> None:
        """On the card: build and load the kernels and run every
        (row bucket, nnz bucket) lane shape once per replica, so the
        first requests pay neither the build nor first-shape
        allocations.  The CPU has nothing to build."""
        t0 = time.perf_counter()
        w = self._weights
        for d, dev in enumerate(self.devices):
            if dev.type != "cuda":
                continue
            for m in self.nnz_buckets:
                for r in self.row_buckets:
                    idx = np.zeros((r, m), np.int32)
                    nnz = np.ones((r,), np.int32)
                    _, event = self._launch(dev, idx, nnz, w.on(d))
                    event.synchronize()
        self.precompile_seconds = time.perf_counter() - t0

    # ----------------------------------------------------------- scoring --
    def _validate(self, doc, *, check_neg: bool = True) -> np.ndarray:
        """1-D non-negative int64 ids.  ``check_neg=False`` leaves the
        negativity check to the caller's one pass over a whole batch."""
        if (type(doc) is np.ndarray and doc.dtype == np.int64
                and doc.ndim == 1):
            arr = doc       # canonical already: skip asarray/issubdtype
        else:
            arr = np.asarray(doc)
            if arr.ndim != 1 or not np.issubdtype(arr.dtype, np.integer):
                raise TypeError(
                    f"doc must be a 1-D integer id array, got shape "
                    f"{arr.shape} dtype {arr.dtype}")
            arr = arr.astype(np.int64, copy=False)
        if check_neg and arr.size and int(arr.min()) < 0:
            raise ValueError("doc has negative feature indices")
        if arr.size == 0 and not self._allows_empty:
            raise ValueError(
                f"empty document: scheme {self.scheme.name!r} has no "
                "empty semantics (its min over zero hashes is sentinel "
                "garbage) — reject upstream or serve with the "
                "zero-coded 'oph_zero' scheme, whose all-empty-bins "
                "path scores it as the bias")
        return arr

    def _next_device(self) -> int:
        with self._rr_lock:
            d = self._rr % len(self.devices)
            self._rr += 1
        return d

    def _score(self, idx: torch.Tensor, nnz: torch.Tensor,
               params: dict) -> torch.Tensor:
        packed, empty = self.scheme.encode_packed(idx, nnz, self.cfg.b)
        return bbit_scores_packed(params, packed, self.cfg,
                                  empty_packed=empty)

    def _launch(self, dev: torch.device, idx: np.ndarray, nnz: np.ndarray,
                params: dict):
        """Copies one padded batch to ``dev`` and launches its scoring;
        → (scores, CUDA event recorded after the launches, or None on
        the CPU).  Does not wait for the card."""
        if dev.type != "cuda":
            return self._score(torch.from_numpy(idx), torch.from_numpy(nnz),
                               params), None
        with torch.cuda.device(dev):
            scores = self._score(torch.from_numpy(idx).to(dev),
                                 torch.from_numpy(nnz).to(dev), params)
            event = torch.cuda.Event()
            event.record()
        return scores, event

    def _dispatch_batch(self, key: int, docs: List[np.ndarray],
                        device_index: Optional[int] = None,
                        weights: Optional[WeightSet] = None) -> Tuple:
        """Pads ``docs`` to the (row bucket, key) lane shape and launches
        the scorer (drain thread; the wait happens in ``_resolve_batch``).
        Reads the live ``WeightSet`` once, so the whole batch scores
        against one version."""
        w = self._weights if weights is None else weights
        n = len(docs)
        rows = self._row_bucket(n)
        # pad_rows owns the id-folding policy (indices ≥ 2^31 fold to
        # [0, 2^31)); only the padding to the lane's shape happens here
        packed_idx, packed_nnz = pad_rows(docs, pad_to_multiple=1)
        idx = np.zeros((rows, key), np.int32)
        nnz = np.zeros((rows,), np.int32)
        idx[:n, :packed_idx.shape[1]] = packed_idx
        nnz[:n] = packed_nnz
        d = self._next_device() if device_index is None else device_index
        self.device_batches[d] += 1
        scores, event = self._launch(self.devices[d], idx, nnz, w.on(d))
        return scores, n, w.version, event

    def _resolve_batch(self, handle: Tuple) -> List:
        host = self._to_host(handle)
        version = handle[2]
        if host.ndim == 1:
            return [VersionedScore(x, version) for x in host]
        return [VersionedVector(row, version) for row in host]

    @staticmethod
    def _to_host(handle: Tuple) -> np.ndarray:
        scores, n, _, event = handle
        if event is not None:
            event.synchronize()
        return scores[:n].cpu().numpy()

    # ------------------------------------------------------------- API ----
    def submit(self, doc: Sequence[int], tenant: Optional[str] = None):
        """Validate + route one doc; returns a Future of its score (a
        ``VersionedScore``).  Resolve latency and the optional
        ``tenant`` feed the stats window."""
        arr = self._validate(doc)
        t0 = time.perf_counter()
        fut = self.batcher.submit(arr)

        def _record(f, t0=t0, tenant=tenant):
            self.stats_window.record(
                time.perf_counter() - t0, rows=1, tenant=tenant,
                error=(not f.cancelled()
                       and f.exception() is not None))

        fut.add_done_callback(_record)
        return fut

    def submit_many(self, docs: Sequence[Sequence[int]],
                    tenant: Optional[str] = None) -> List[Future]:
        """Batch ``submit``: identical routing and results, with the
        negativity check done in one pass over the whole batch."""
        arrs = [self._validate(d, check_neg=False) for d in docs]
        if not arrs:
            return []
        cat = (np.concatenate(arrs) if len(arrs) > 1
               else np.asarray(arrs[0]))
        if cat.size and int(cat.min()) < 0:
            raise ValueError("doc has negative feature indices")
        t0 = time.perf_counter()
        futs = []

        def _record(f, t0=t0, tenant=tenant):
            self.stats_window.record(
                time.perf_counter() - t0, rows=1, tenant=tenant,
                error=(not f.cancelled()
                       and f.exception() is not None))

        for arr in arrs:
            fut = self.batcher.submit(arr)
            fut.add_done_callback(_record)
            futs.append(fut)
        return futs

    def score_docs(self, docs: Sequence[Sequence[int]],
                   device_index: Optional[int] = None,
                   weights: Optional[WeightSet] = None) -> np.ndarray:
        """Synchronous batch scoring, bypassing the batcher.
        Thread-safe.  ``weights`` pins the batch to a specific
        ``WeightSet``."""
        items = [self._validate(d) for d in docs]
        key = self._nnz_bucket(max((len(d) for d in items), default=1))
        return self._to_host(self._dispatch_batch(
            key, items, device_index=device_index, weights=weights))

    # ------------------------------------------------- versioned weights --
    @property
    def params(self) -> dict:
        """The replica-0 params of the live version."""
        return self._weights.params[0]

    @property
    def version(self) -> str:
        return self._weights.version

    def current_weights(self) -> WeightSet:
        """The live immutable WeightSet (pin it to score version-exact
        across a reload)."""
        return self._weights

    def swap_weights(self, params, version: Optional[str] = None) -> str:
        """Atomically publish a new weight version: the new set is
        checked and copied onto every replica first, then swapped in
        with one reference assignment; in-flight batches keep the set
        they captured.  Returns the new version string."""
        with self._swap_lock:
            staged = self._stage(params)
            version = version or f"v{self.reloads + 1}"
            self._weights = WeightSet(version=version, params=staged,
                                      created_at=time.time())
            self.reloads += 1
        return version

    # -------------------------------------------------------- stats -------
    def stats(self) -> dict:
        """Thread-safe operability snapshot: rolling latency percentiles,
        rows/s and per-tenant counts, queue depths and per-lane
        occupancy, reload counters, the batcher's health, and the
        kernel launch counts of the serving path."""
        snap = self.stats_window.snapshot()
        depths = self.batcher.depths()
        snap.update(
            version=self._weights.version,
            reloads=self.reloads,
            uptime_s=time.time() - self._started_at,
            precompile_seconds=self.precompile_seconds,
            batches_run=self.batcher.batches_run,
            requests_served=self.batcher.requests_served,
            devices=[str(d) for d in self.devices],
            device_batches=list(self.device_batches),
            lanes={str(k): v for k, v in depths["lanes"].items()},
            queued=depths["queued"],
            inflight_batches=depths["inflight_batches"],
            pipeline_depth=depths["depth"],
            nnz_buckets=list(self.nnz_buckets),
            row_buckets=list(self.row_buckets),
            health=self.batcher.health(),
            kernels=ops.counts(),
        )
        return snap

    def flush(self):
        """Dispatch every queued request now instead of waiting out the
        coalescing window."""
        self.batcher.flush()

    def close(self):
        self.batcher.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
