"""Duplicate-traffic score cache keyed by minhash band signatures (a
copy of ``repro/serving/dedup.py``: the port imports nothing of
``repro``).

The million-user serving case is heavy on duplicates — many clients
posting the same viral document.  The codes the engine already computes
are a content fingerprint, so a bounded LRU over them short-circuits
the device entirely: a repeat document costs one host-side hash pass
(``scheme.encode_packed_numpy`` — the same bytes as the device encode,
kernels B1 and B2) plus a dict probe, instead of a padded device
round-trip.

Key contract (bands are the probe, full-code equality is the guard):

  * PROBE — the dict key is the tuple of the first ``probe_bands`` LSH
    band keys of the packed code row (``retrieval.bands``).  A subset
    on purpose: all bands concatenated would just *be* the full code.
  * GUARD — a probe hit only returns a score after exact bytes-equality
    of the full packed code (and the ``oph_zero`` empty bitmask).  Band
    collisions of non-identical docs are counted (``guard_rejects``)
    and miss — no false-positive score can ever leave the cache.  The
    host encode is bit-exact vs the device encode per scheme, so
    byte-equality here transfers exactly to score-equality there
    (``chip_smoke.py``'s serve phase re-proves it on the card).
  * VERSION — every entry is pinned to the ``WeightSet`` version that
    produced its score; ``invalidate(new_version)`` (called under the
    engine's swap lock) atomically drops everything, and a late
    ``put`` racing a swap is discarded (``stale_drops``).

Hit/miss/eviction/bytes counters surface through ``engine.stats()`` →
``GET /status``; hit document sizes feed an ``NnzHistogram`` (the same
adaptive-bucket primitive the batcher uses) so operators can see WHICH
traffic is duplicated.
"""
from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.serving.stats import NnzHistogram

_SIG_KEY_BYTES = 8      # one uint64 per probe band


class DedupCache:
    """Bounded LRU: band-signature probe → (packed code, score)."""

    def __init__(self, max_entries: int = 4096, *, version: str = "v0"):
        if max_entries < 1:
            raise ValueError(f"max_entries must be >= 1, got {max_entries}")
        self.max_entries = int(max_entries)
        self._lock = threading.Lock()
        # sig -> (packed bytes, empty bytes | None, result, version)
        self._entries: "OrderedDict[Tuple[int, ...], Tuple]" = OrderedDict()
        self._bytes = 0
        self._version = version
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.insertions = 0
        self.guard_rejects = 0
        self.stale_drops = 0
        self.invalidations = 0
        self.hit_sizes = NnzHistogram()

    @staticmethod
    def _entry_bytes(sig, packed: bytes, empty: Optional[bytes],
                     result) -> int:
        size = _SIG_KEY_BYTES * len(sig) + len(packed)
        if empty is not None:
            size += len(empty)
        size += getattr(result, "nbytes", 8)
        return size

    def get(self, sig: Tuple[int, ...], packed: bytes,
            empty: Optional[bytes], version: str,
            nnz: Optional[int] = None):
        """Probe → guarded lookup; returns the cached result or None."""
        with self._lock:
            entry = self._entries.get(sig)
            if entry is None:
                self.misses += 1
                return None
            e_packed, e_empty, result, e_version = entry
            if e_packed != packed or e_empty != empty:
                self.guard_rejects += 1
                self.misses += 1
                return None
            if e_version != version:
                # belt over the invalidate() suspenders: a stale entry
                # must never serve a new version's traffic
                self.misses += 1
                return None
            self._entries.move_to_end(sig)
            self.hits += 1
        if nnz is not None:
            self.hit_sizes.record(nnz)
        return result

    def get_many(self, keys, version: str,
                 sizes: Optional[Sequence[int]] = None) -> List:
        """Batched ``get``: same probe → guard → version pipeline per
        key, but ONE lock acquisition for the whole chunk (per-row
        locking is a measurable slice of the hit path at batch-front-
        door rates).  ``keys`` is a sequence of (sig, packed, empty)
        triples; returns a same-length list with None at misses."""
        out = []
        hit_sizes = []
        with self._lock:
            for i, (sig, packed, empty) in enumerate(keys):
                entry = self._entries.get(sig)
                if entry is None:
                    self.misses += 1
                    out.append(None)
                    continue
                e_packed, e_empty, result, e_version = entry
                if e_packed != packed or e_empty != empty:
                    self.guard_rejects += 1
                    self.misses += 1
                    out.append(None)
                    continue
                if e_version != version:
                    self.misses += 1
                    out.append(None)
                    continue
                self._entries.move_to_end(sig)
                self.hits += 1
                out.append(result)
                if sizes is not None:
                    hit_sizes.append(sizes[i])
        if hit_sizes:
            self.hit_sizes.record_many(hit_sizes)
        return out

    def put(self, sig: Tuple[int, ...], packed: bytes,
            empty: Optional[bytes], result, version: str) -> None:
        """Insert after a miss resolves; drops stale-version writes."""
        with self._lock:
            if version != self._version:
                self.stale_drops += 1
                return
            old = self._entries.pop(sig, None)
            if old is not None:
                self._bytes -= self._entry_bytes(sig, old[0], old[1], old[2])
            self._entries[sig] = (packed, empty, result, version)
            self._bytes += self._entry_bytes(sig, packed, empty, result)
            self.insertions += 1
            while len(self._entries) > self.max_entries:
                k, (p, e, r, _) = self._entries.popitem(last=False)
                self._bytes -= self._entry_bytes(k, p, e, r)
                self.evictions += 1

    def invalidate(self, version: str) -> None:
        """New weight version ⇒ every cached score is wrong: one
        atomic clear (the engine calls this under its swap lock)."""
        with self._lock:
            self._entries = OrderedDict()
            self._bytes = 0
            self._version = version
            self.invalidations += 1

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def stats(self) -> Dict[str, object]:
        with self._lock:
            hits, misses = self.hits, self.misses
            out = {
                "entries": len(self._entries),
                "max_entries": self.max_entries,
                "bytes": self._bytes,
                "hits": hits,
                "misses": misses,
                "evictions": self.evictions,
                "insertions": self.insertions,
                "guard_rejects": self.guard_rejects,
                "stale_drops": self.stale_drops,
                "invalidations": self.invalidations,
                "version": self._version,
            }
        out["hit_rate"] = hits / (hits + misses) if hits + misses else 0.0
        out["hit_nnz"] = {str(e): c for e, c
                          in self.hit_sizes.counts().items()}
        return out
