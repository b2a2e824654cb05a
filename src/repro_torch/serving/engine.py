"""Serving engine for the b-bit hashed classifier, and the LM zoo's
``greedy_generate`` (counterpart of ``repro/serving/engine.py``).

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

``fused=False`` keeps the reference's widened two-step selectable: the
raw-minima encode (``scheme.encode_device``: kernel B3 for minwise, B4
for OPH) to int32 (n, k) codes, then ``bbit_scores`` (the widened
linear kernel B7).  ``oph_zero``'s masked product has no kernel in
either package (``ops.bbit_linear_masked``, counted on the
``bbit_linear_fwd`` plain counter).

``dedup_cache=True`` puts the band-keyed duplicate-traffic score cache
(``serving.dedup.DedupCache``) in front of the batcher: one host-side
encode pass over a whole ``submit_many`` batch gives each document its
band-signature probe and its packed bytes (the same bytes as B1/B2),
a guarded hit returns the cached resolved future without touching the
card, and ``swap_weights`` invalidates the cache under its swap lock.

``adapt_every=N`` re-derives the nnz lane grid from the batcher's
observed size histogram every N submits (``adapt_buckets``) on a
background thread: the new (row × nnz × replica) shapes run once on
each card first, then the grid is swapped.

Row buckets: the static power-of-two grid up to ``max_batch``, unless a
cost-model profile (``perf.set_profile`` / ``maybe_load_profile``) holds
the ``serve_score`` curve of this (k, b, scheme) over every lane, and
``row_buckets`` is left ``None``: then each lane keeps the buckets
``perf.suggest_row_buckets`` gives it and drains at the cap
``perf.suggest_lane_caps`` gives it (``docs/DESIGN.md`` §2.5).
``stats()`` reports both and the cost model's ``dispatch`` section.
"""
from __future__ import annotations

import threading
import time
from concurrent.futures import Future
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import perf, tree
from repro_torch.core.schemes import make_scheme
from repro_torch.data.packing import bucket_width, pad_rows
from repro_torch.devices import (DeviceLike, replica_devices,
                                 resolve_device)
from repro_torch.kernels import ops
from repro_torch.models.linear import (BBitLinearConfig, bbit_scores,
                                       bbit_scores_packed, param_tensor)
from repro_torch.retrieval.bands import band_geometry, band_keys_packed
from repro_torch.serving.batcher import BucketBatcher
from repro_torch.serving.dedup import DedupCache
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
                 fused: bool = True,
                 device: DeviceLike = None,
                 replicas: int = 1,
                 nnz_buckets: Sequence[int] = DEFAULT_NNZ_BUCKETS,
                 row_buckets: Optional[Sequence[int]] = None,
                 precompile: bool = True,
                 pipeline_depth: int = 2,
                 stats_window: int = 2048,
                 adapt_every: int = 0,
                 version: str = "v0",
                 dedup_cache: bool = False,
                 dedup_entries: int = 4096,
                 dedup_rows_per_band: int = 4,
                 dedup_probe_bands: int = 4):
        self.cfg = cfg
        self.scheme = make_scheme(scheme, cfg.k, seed)
        self.fused = fused
        # duplicate-traffic short-circuit: band-signature probe + exact
        # packed-code guard, after the host-side encode and before the
        # card (see serving/dedup.py for the contract)
        self.dedup: Optional[DedupCache] = None
        if dedup_cache:
            band_geometry(cfg.k, cfg.b, dedup_rows_per_band)
            self.dedup = DedupCache(max_entries=dedup_entries,
                                    version=version)
            self._dedup_rows_per_band = int(dedup_rows_per_band)
            self._dedup_probe_bands = int(dedup_probe_bands)
        # zero-coded schemes give an empty doc exact semantics (every
        # bin empty → contributions masked out → score == bias)
        self._allows_empty = getattr(self.scheme, "densify", True) is False
        self.nnz_buckets = tuple(sorted(int(b) for b in nnz_buckets))
        if not self.nnz_buckets:
            raise ValueError("need at least one nnz bucket")
        # per-nnz-lane row buckets and drain caps from the measured
        # serve_score cost curve (a perf profile); without one, or with
        # explicit row_buckets, the static pow-2 grid applies to every lane
        self._lane_row_buckets: Dict[int, Tuple[int, ...]] = {}
        self._lane_caps: Dict[int, int] = {}
        if row_buckets is None:
            top = bucket_width(max_batch, floor=1)
            row_buckets = tuple(1 << i for i in range(top.bit_length()))
            suggestion = perf.suggest_row_buckets(
                cfg.k, cfg.b, scheme, max_batch, self.nnz_buckets)
            if suggestion:
                self._lane_row_buckets = {
                    int(m): tuple(sorted(int(r) for r in rb))
                    for m, rb in suggestion.items()}
                row_buckets = tuple(sorted(
                    {r for rb in self._lane_row_buckets.values()
                     for r in rb}))
            caps = perf.suggest_lane_caps(
                cfg.k, cfg.b, scheme, max_batch, self.nnz_buckets)
            if caps:
                self._lane_caps = {int(m): int(c) for m, c in caps.items()}
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
        self.adapt_every = int(adapt_every)
        self.rebuckets = 0
        self._submits = 0
        self._adapting = threading.Event()
        self._started_at = time.time()

        # (row bucket, nnz bucket, replica) shapes that ran on a card;
        # compile_misses (the reference's name) counts batches of a shape
        # that no warm-up ran
        self._warmed: set = set()
        self.compile_misses = 0
        self.precompile_seconds = 0.0
        if precompile:
            self._precompile()

        self.batcher = BucketBatcher(
            self._dispatch_batch, self._resolve_batch,
            route=lambda doc: self._nnz_bucket(len(doc)),
            max_batch=max_batch, max_wait_ms=max_wait_ms,
            depth=pipeline_depth, lane_caps=self._lane_caps)

    # ---------------------------------------------------------- weights --
    def _stage(self, params) -> Tuple[dict, ...]:
        """Checks ``params`` against the config and copies them onto every
        replica device (contiguous, owned by the engine): a bfloat16
        tensor, or numpy array of bfloat16 words, stays bfloat16, as the
        reference's ``device_put`` keeps it (B5 reads it in place); any
        other becomes float32."""
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
                       else param_tensor(params[name]))
                for name in shapes}
        staged = []
        for dev in self.devices:
            staged.append({name: t.to(device=dev, dtype=(
                t.dtype if t.dtype == torch.bfloat16 else torch.float32),
                copy=True).contiguous() for name, t in host.items()})
            if dev.type == "cuda":
                # resident before the swap: wait on the copies (the
                # device's current stream), not on the whole device
                with torch.cuda.device(dev):
                    copied = torch.cuda.Event()
                    copied.record()
                copied.synchronize()
        return tuple(staged)

    # ---------------------------------------------------------- buckets --
    def _nnz_bucket(self, n: int) -> int:
        return _grow_bucket(n, self.nnz_buckets)

    def _row_buckets_for(self, key: Optional[int]) -> Tuple[int, ...]:
        if key is not None:
            lane = self._lane_row_buckets.get(int(key))
            if lane:
                return lane
        return self.row_buckets

    def _row_bucket(self, n: int, key: Optional[int] = None) -> int:
        buckets = self._row_buckets_for(key)
        for r in buckets:
            if n <= r:
                return r
        return bucket_width(n, floor=buckets[-1])

    def _precompile(self) -> None:
        """On the card: build and load the kernels and run every
        (row bucket, nnz bucket) lane shape once per replica, so the
        first requests pay neither the build nor first-shape
        allocations.  The CPU has nothing to build."""
        t0 = time.perf_counter()
        self._precompile_grid(self.nnz_buckets, self.row_buckets)
        self.precompile_seconds = time.perf_counter() - t0

    def _precompile_grid(self, nnz_buckets: Sequence[int],
                         row_buckets: Sequence[int]) -> None:
        """Runs each not-yet-run (row, nnz, replica) shape of a lane grid
        once on its card and waits for it."""
        w = self._weights
        for d, dev in enumerate(self.devices):
            if dev.type != "cuda":
                continue
            for m in nnz_buckets:
                lane_rows = self._lane_row_buckets.get(int(m))
                for r in (lane_rows if lane_rows else row_buckets):
                    if (r, m, d) in self._warmed:
                        continue
                    idx = np.zeros((r, m), np.int32)
                    nnz = np.ones((r,), np.int32)
                    _, event = self._launch(dev, idx, nnz, w.on(d))
                    event.synchronize()
                    self._warmed.add((r, m, d))

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
        if not self.fused:
            # the widened two-step: raw-minima encode (B3/B4) → int32
            # codes → B7 (oph_zero: the masked product, no kernel)
            codes, empty = self.scheme.encode_device(idx, nnz, self.cfg.b)
            return bbit_scores(params, codes, self.cfg, empty=empty)
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
        rows = self._row_bucket(n, key)
        # pad_rows owns the id-folding policy (indices ≥ 2^31 fold to
        # [0, 2^31)); only the padding to the lane's shape happens here
        packed_idx, packed_nnz = pad_rows(docs, pad_to_multiple=1)
        idx = np.zeros((rows, key), np.int32)
        nnz = np.zeros((rows,), np.int32)
        idx[:n, :packed_idx.shape[1]] = packed_idx
        nnz[:n] = packed_nnz
        d = self._next_device() if device_index is None else device_index
        dev = self.devices[d]
        self.device_batches[d] += 1
        scores, event = self._launch(dev, idx, nnz, w.on(d))
        shape_key = (rows, key, d)
        if dev.type == "cuda" and shape_key not in self._warmed:
            self.compile_misses += 1
            self._warmed.add(shape_key)
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

    # ----------------------------------------------------- dedup cache ----
    def _dedup_keys(self, arrs: Sequence[np.ndarray],
                    cat: Optional[np.ndarray] = None) -> List[Tuple]:
        """One host-side hash pass over a whole batch → each doc's
        (band-signature probe, full packed bytes, empty bytes), the
        cache's (probe, guard) pairs.  The bytes equal the card's encode
        (B1/B2: the same id folding through ``pad_rows``' policy, the
        same hash words), and the encode does not depend on the pad
        width, so a key computed in any batch equals the key computed
        alone.  One pass a batch amortizes numpy's fixed cost a call."""
        ragged = getattr(self.scheme, "encode_packed_numpy_ragged", None)
        if ragged is not None:
            # no padded intermediate: concat + fold (pad_rows' id-folding
            # policy) + one ragged encode
            lens = np.fromiter((a.size for a in arrs), dtype=np.int64,
                               count=len(arrs))
            if cat is None:
                cat = (np.concatenate(arrs) if len(arrs) > 1
                       else np.asarray(arrs[0]))
            tokens = (cat & np.int64((1 << 31) - 1)).astype(np.int32)
            packed, empty = ragged(tokens, lens, self.cfg.b)
        else:
            idx, nnz = pad_rows(list(arrs), pad_to_multiple=1)
            packed, empty = self.scheme.encode_packed_numpy(
                idx, nnz, self.cfg.b)
        keys = band_keys_packed(packed, self.cfg.k, self.cfg.b,
                                self._dedup_rows_per_band)
        sigs = keys[:, :self._dedup_probe_bands].tolist()
        return [(tuple(s), packed[i].tobytes(),
                 None if empty is None else empty[i].tobytes())
                for i, s in enumerate(sigs)]

    def _dedup_key(self, arr: np.ndarray):
        return self._dedup_keys([arr])[0]

    def _submit_dedup(self, arr: np.ndarray, key: Optional[Tuple] = None):
        """Cache short-circuit: a hit returns an already-resolved Future
        (no batcher, no card); a miss dispatches normally and fills the
        cache when its batch resolves.  The cached object is the
        resolved batcher Future itself, shared by every later hit: a
        finished Future does not change (``add_done_callback`` runs at
        once, ``cancel`` does nothing)."""
        sig, packed, empty = self._dedup_key(arr) if key is None else key
        version = self._weights.version
        hit = self.dedup.get(sig, packed, empty, version, nnz=arr.size)
        if hit is not None:
            return hit
        return self._submit_dedup_miss(arr, (sig, packed, empty), version)

    def _submit_dedup_miss(self, arr: np.ndarray, key: Tuple,
                           version: str):
        """Miss leg of the dedup path: normal batcher dispatch plus a
        cache fill when the batch resolves."""
        sig, packed, empty = key
        fut = self.batcher.submit(arr)
        cache = self.dedup

        def _fill(f):
            if f.cancelled() or f.exception() is not None:
                return
            result = f.result()
            cache.put(sig, packed, empty, f,
                      getattr(result, "version", version))

        fut.add_done_callback(_fill)
        return fut

    # ------------------------------------------------------------- API ----
    def submit(self, doc: Sequence[int], tenant: Optional[str] = None):
        """Validate + route one doc; returns a Future of its score (a
        ``VersionedScore``).  Resolve latency and the optional
        ``tenant`` feed the stats window."""
        arr = self._validate(doc)
        t0 = time.perf_counter()
        if self.dedup is not None:
            fut = self._submit_dedup(arr)
        else:
            fut = self.batcher.submit(arr)

        def _record(f, t0=t0, tenant=tenant):
            self.stats_window.record(
                time.perf_counter() - t0, rows=1, tenant=tenant,
                error=(not f.cancelled()
                       and f.exception() is not None))

        fut.add_done_callback(_record)
        if self.adapt_every:
            self._submits += 1
            if self._submits % self.adapt_every == 0:
                self._adapt_async()
        return fut

    def submit_many(self, docs: Sequence[Sequence[int]],
                    tenant: Optional[str] = None) -> List[Future]:
        """Batch ``submit``: identical routing and results, with the
        negativity check done in one pass over the whole batch and,
        with the dedup cache on, the whole batch's keys from one host
        encode pass (``_dedup_keys``)."""
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

        if self.dedup is not None:
            keys = self._dedup_keys(arrs, cat=cat)
            version = self._weights.version
            hits = self.dedup.get_many(keys, version,
                                       [a.size for a in arrs])
            n_hits = 0
            for i, arr in enumerate(arrs):
                if hits[i] is not None:
                    # a resolved shared Future; its stats are recorded
                    # in one batched call below
                    futs.append(hits[i])
                    n_hits += 1
                    continue
                fut = self._submit_dedup_miss(arr, keys[i], version)
                fut.add_done_callback(_record)
                futs.append(fut)
            if n_hits:
                self.stats_window.record_batch(
                    time.perf_counter() - t0, n_hits, tenant=tenant)
        else:
            for arr in arrs:
                fut = self.batcher.submit(arr)
                fut.add_done_callback(_record)
                futs.append(fut)
        if self.adapt_every:
            before = self._submits
            self._submits += len(arrs)
            if (before // self.adapt_every
                    != self._submits // self.adapt_every):
                self._adapt_async()
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
            if self.dedup is not None:
                # the same critical section as the swap: no window where
                # new-version traffic can hit an old-version score
                self.dedup.invalidate(version)
            self.reloads += 1
        return version

    # ------------------------------------------------- adaptive buckets --
    def _adapt_async(self) -> None:
        """Starts one background re-derivation (a submit never waits on
        warm-ups; overlapping triggers collapse into one)."""
        if self._adapting.is_set():
            return
        self._adapting.set()

        def run():
            try:
                self.adapt_buckets()
            finally:
                self._adapting.clear()

        threading.Thread(target=run, daemon=True,
                         name="serve-adapt").start()

    def adapt_buckets(self, max_buckets: Optional[int] = None,
                      coverage: float = 0.995) -> Tuple[int, ...]:
        """Re-derives the nnz lane grid from observed traffic.

        Runs any new (row × nnz × replica) shapes on their cards first,
        then swaps the grid, so traffic after the swap meets only warm
        shapes.  Returns the current grid unchanged until the batcher
        has seen enough samples, or when the suggestion is the live
        grid.  Requests racing the swap route on whichever grid they
        caught; both grids are warm."""
        suggestion = self.batcher.suggest_buckets(
            max_buckets=max_buckets or len(self.nnz_buckets),
            coverage=coverage)
        if not suggestion or tuple(suggestion) == self.nnz_buckets:
            return self.nnz_buckets
        self._precompile_grid(suggestion, self.row_buckets)
        self.nnz_buckets = tuple(suggestion)   # route() reads this live
        self.rebuckets += 1
        return self.nnz_buckets

    # -------------------------------------------------------- stats -------
    def stats(self) -> dict:
        """Thread-safe operability snapshot (the ``GET /status`` body):
        rolling latency percentiles, rows/s and per-tenant counts, queue
        depths and per-lane occupancy, warm-up, reload and re-bucket
        counters, the batcher's health, the dedup cache's counters, and
        the kernel launch counts of the serving path."""
        snap = self.stats_window.snapshot()
        depths = self.batcher.depths()
        snap.update(
            version=self._weights.version,
            reloads=self.reloads,
            uptime_s=time.time() - self._started_at,
            compile_misses=self.compile_misses,
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
            lane_row_buckets={str(m): list(rb) for m, rb
                              in self._lane_row_buckets.items()},
            lane_caps={str(m): c for m, c in self._lane_caps.items()},
            rebuckets=self.rebuckets,
            health=self.batcher.health(),
            dispatch=perf.dispatch_report(),
            kernels=ops.counts(),
            dedup=(dict(self.dedup.stats(), enabled=True,
                        rows_per_band=self._dedup_rows_per_band,
                        probe_bands=self._dedup_probe_bands)
                   if self.dedup is not None else {"enabled": False}),
        )
        return snap

    def flush(self):
        """Dispatch every queued request now instead of waiting out the
        coalescing window (end-of-stream clients, graceful drain)."""
        self.batcher.flush()

    def close(self):
        self.batcher.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


def grow_cache(full, cache):
    """A prefill ``cache`` in ``full`` (an ``init_cache`` of the decode
    length), leaf by leaf: written at the start of the one axis where the
    shapes differ (the sequence axis), or cast to ``full``'s dtype where
    they agree."""
    def grow(f: torch.Tensor, pre: torch.Tensor) -> torch.Tensor:
        if f.shape == pre.shape:
            return pre.to(f.dtype)
        axis = [i for i, (a, c) in enumerate(zip(f.shape, pre.shape))
                if a != c][0]
        f.narrow(axis, 0, pre.shape[axis]).copy_(pre)
        return f

    return tree.tree_map(grow, full, cache)


@torch.no_grad()
def greedy_generate(api, params, prompt: np.ndarray, max_new: int,
                    max_len: Optional[int] = None,
                    extras: Optional[dict] = None,
                    device=None) -> np.ndarray:
    """Greedy decode of the LM zoo's ``api`` (``models/api.py``): prefill
    of ``prompt`` (B, S0) int32, the cache grown into ``init_cache(B,
    max_len)``, then ``max_new - 1`` cached decode steps → int32 (B, S0 +
    max_new).  ``params`` and ``extras`` (modality inputs) live on
    ``device`` (``None`` is ``cuda:0``).  The tokens stay on the device:
    each step's argmax (the first maximum, as numpy's) feeds the next
    step, and the tokens come back to the host once, at the end."""
    dev = resolve_device(device)
    b, s0 = prompt.shape
    if max_new <= 0:
        return np.asarray(prompt, dtype=np.int32).copy()
    max_len = max_len or (s0 + max_new)
    prompt_t = torch.as_tensor(np.asarray(prompt, np.int32), device=dev)
    batch = {"tokens": prompt_t}
    if extras:
        batch.update({k: torch.as_tensor(v, device=dev)
                      for k, v in extras.items()})
    logits, cache = api.prefill(params, batch)
    cache = grow_cache(api.init_cache(b, max_len, device=dev), cache)
    out = torch.empty((b, s0 + max_new), dtype=torch.int32, device=dev)
    out[:, :s0] = prompt_t
    out[:, s0] = torch.argmax(logits, dim=-1)
    for t in range(1, max_new):
        logits, cache = api.decode_step(
            params, {"token": out[:, s0 + t - 1:s0 + t]}, cache, s0 + t - 1)
        out[:, s0 + t] = torch.argmax(logits, dim=-1)
    return out.cpu().numpy()
