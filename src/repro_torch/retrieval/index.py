"""Banded LSH inverted index over packed b-bit code rows (counterpart of
``repro/retrieval/index.py``).

Insert puts each document's k/r band keys into per-band posting dicts
on the host; a query takes the union of the posting lists of its bands
(any shared band makes a candidate, probability ~R^r for resemblance R)
and ranks the candidates by exact packed Hamming similarity through
``kernels.ops.hamming_topk`` on the index's device (kernel B10 on the
card).  Deletes tombstone the slot: posting entries go at once, the row
keeps its place.  The index is for densified fixed-width codes (minwise,
oph).
"""
from __future__ import annotations

import threading
from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np
import torch

from repro_torch.core.bbit import packed_width
from repro_torch.devices import DeviceLike, resolve_device
from repro_torch.kernels import ops
from repro_torch.retrieval.bands import band_geometry, band_keys_packed


class BandedLSHIndex:
    """Insert/query/delete over packed codes, banded at r rows/band;
    distances run on ``device`` (default ``cuda:0``)."""

    def __init__(self, k: int, b: int, rows_per_band: int = 4, *,
                 device: DeviceLike = None):
        self.k = int(k)
        self.b = int(b)
        self.rows_per_band = int(rows_per_band)
        self.n_bands = band_geometry(self.k, self.b, self.rows_per_band)
        self.width = packed_width(self.k, self.b)
        self.device = resolve_device(device)
        self._lock = threading.Lock()
        self._rows: List[np.ndarray] = []          # slot -> packed row
        self._ids: List[Optional[object]] = []     # slot -> id | tombstone
        self._slot_of: Dict[object, int] = {}
        self._postings: List[Dict[int, Set[int]]] = [
            {} for _ in range(self.n_bands)]

    def __len__(self) -> int:
        return len(self._slot_of)

    def _keys(self, packed: np.ndarray) -> np.ndarray:
        return band_keys_packed(packed, self.k, self.b, self.rows_per_band)

    def insert(self, ids: Sequence[object], packed: np.ndarray) -> None:
        """Adds rows; an already-present id is replaced (delete+insert)."""
        packed = np.atleast_2d(np.asarray(packed, dtype=np.uint8))
        if packed.shape[1] != self.width:
            raise ValueError(
                f"expected packed width {self.width}, got {packed.shape[1]}")
        if len(ids) != packed.shape[0]:
            raise ValueError("ids/rows length mismatch")
        keys = self._keys(packed)
        with self._lock:
            for i, doc_id in enumerate(ids):
                if doc_id in self._slot_of:
                    self._delete_locked(doc_id)
                slot = len(self._rows)
                self._rows.append(packed[i].copy())
                self._ids.append(doc_id)
                self._slot_of[doc_id] = slot
                for j in range(self.n_bands):
                    self._postings[j].setdefault(
                        int(keys[i, j]), set()).add(slot)

    def _delete_locked(self, doc_id: object) -> None:
        slot = self._slot_of.pop(doc_id)
        keys = self._keys(self._rows[slot][None, :])[0]
        for j in range(self.n_bands):
            key = int(keys[j])
            bucket = self._postings[j].get(key)
            if bucket is not None:
                bucket.discard(slot)
                if not bucket:
                    del self._postings[j][key]
        self._ids[slot] = None

    def delete(self, ids: Sequence[object]) -> int:
        """Removes ids (missing ones ignored); returns how many existed."""
        removed = 0
        with self._lock:
            for doc_id in ids:
                if doc_id in self._slot_of:
                    self._delete_locked(doc_id)
                    removed += 1
        return removed

    def candidates(self, packed_q: np.ndarray,
                   probe_bands: Optional[int] = None) -> List[int]:
        """Sorted candidate slots colliding with the query in ≥1 of the
        first ``probe_bands`` bands (all bands by default)."""
        packed_q = np.asarray(packed_q, dtype=np.uint8).reshape(1, -1)
        keys = self._keys(packed_q)[0]
        probe = self.n_bands if probe_bands is None else min(
            int(probe_bands), self.n_bands)
        out: Set[int] = set()
        with self._lock:
            for j in range(probe):
                out |= self._postings[j].get(int(keys[j]), set())
        return sorted(out)

    def query(
        self,
        packed_q: np.ndarray,
        top_k: int = 10,
        probe_bands: Optional[int] = None,
    ) -> Tuple[List[object], np.ndarray]:
        """One query row → (ids, float32 sims) of its top-k band-collision
        candidates, ranked by exact packed Hamming similarity."""
        packed_q = np.asarray(packed_q, dtype=np.uint8).reshape(-1)
        if packed_q.shape[0] != self.width:
            raise ValueError(
                f"expected packed width {self.width}, got {packed_q.shape[0]}")
        slots = self.candidates(packed_q, probe_bands)
        if not slots:
            return [], np.zeros((0,), dtype=np.float32)
        with self._lock:
            cands = np.stack([self._rows[s] for s in slots])
        idx, sims = ops.hamming_topk(
            torch.from_numpy(packed_q).to(self.device),
            torch.from_numpy(cands).to(self.device),
            k=self.k, bits=self.b, topk=top_k)
        ids = [self._ids[slots[i]] for i in idx.cpu().tolist()]
        return ids, sims.cpu().numpy()

    def stats(self) -> Dict[str, object]:
        with self._lock:
            buckets = sum(len(p) for p in self._postings)
            posting_refs = sum(len(s) for p in self._postings
                               for s in p.values())
            # rows + per-band entries (a uint64 key and slot refs, ~16 B
            # each as a flat-array bound: the scaling, not Python's cost)
            bytes_est = (len(self._rows) * self.width
                         + 16 * (buckets + posting_refs))
            return {
                "entries": len(self._slot_of),
                "tombstones": len(self._rows) - len(self._slot_of),
                "bands": self.n_bands,
                "rows_per_band": self.rows_per_band,
                "band_bits": self.rows_per_band * self.b,
                "buckets": buckets,
                "posting_refs": posting_refs,
                "bytes_est": bytes_est,
            }
