"""Hashing a corpus into b-bit codes, and the packed shard archive
(counterpart of ``repro/data/hashed_dataset.py``).

``preprocess_rows`` takes the reference's route: each length-sorted
chunk goes through ``make_scheme(...).encode_device`` — the raw-minima
encode (B3 for minwise, B4 for OPH), then densify or zero-coding and the
b-bit mask on the device — for every scheme and every b ≤ 16.  The exact
families (``mod_prime``) take the reference's numpy path.
``preprocess_rows_packed`` and ``preprocess_and_save`` stream the fused
packed encode (B1, B2).  As in the reference, ``PIPELINE_DEPTH`` chunks
stay in flight: chunk i+1 is copied to the card and encoded before chunk
i's result is read, through pinned host buffers and ``non_blocking``
copies, with a CUDA event marking when a chunk's bytes are on the host.

Shard format (format_version 4, written by ``preprocess_and_save``; the
reference's layout, byte for byte; v1–v3 archives read unchanged):

  <root>/meta.json                   {format_version, scheme, k, b,
                                      family, seed, n, shards,
                                      packed_width, shard_checksums,
                                      seconds_hashing, total_nnz,
                                      mnnz_per_s}
  <root>/hashed_00000.codes.npy      packed uint8 (rows, ceil(kb/8))
  <root>/hashed_00000.labels.npy     int32 (rows,)
  <root>/hashed_00000.rows.npy       int64 (rows,) original row ids
  <root>/hashed_00000.empty.npy      packed uint8 (rows, ceil(k/8))
                                     [oph_zero only — empty-bin
                                      bitmask, np.packbits layout]

Shards hold contiguous runs of the length-sorted processing order; the
``rows`` array records original positions, so ``load_hashed`` restores
the original row order.  ``HashedShardWriter`` records a CRC32 per shard
file (``shard_checksums``); ``verify_shard`` recomputes them on demand.
``load_packed_shard`` retries transient ``OSError``s with bounded
deterministic backoff; a read that keeps failing records the shard in
``quarantined_shards`` and raises ``ShardReadError``.  An armed
``ft.faults`` plan's ``shard_read`` events fire inside that retry loop.
Training reads packed rows straight off the mmap'd shards
(``iter_hashed_batches``) and never widens a shard on the host.
"""
from __future__ import annotations

import collections
import json
import logging
import os
import time
import zlib
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.bbit import (bbit_codes, pack_codes, packed_width,
                                   unpack_codes)
from repro_torch.core.minhash import minhash_numpy
from repro_torch.core.oph import OPH_EMPTY_CODE
from repro_torch.core.schemes import make_scheme
from repro_torch.core.universal_hash import make_hash_family
from repro_torch.data.packing import pad_rows
from repro_torch.devices import DeviceLike, resolve_device
from repro_torch.ft import faults
from repro_torch.ft.retry import BackoffPolicy

FORMAT_VERSION = 4

log = logging.getLogger("repro_torch.data")

# transient-read policy: small, capped, jitter-free (deterministic)
READ_RETRIES = 2
READ_BACKOFF = BackoffPolicy(base_s=0.01, factor=2.0, cap_s=0.25,
                             jitter_frac=0.0)

# shards whose reads exhausted their retries or failed their CRCs, by
# archive root
quarantined_shards: Dict[str, List[int]] = {}

# chunks in flight on the device before the oldest is read back: chunk
# i+1 is copied and encoded while chunk i computes
PIPELINE_DEPTH = 2


class ShardReadError(RuntimeError):
    """A shard read kept failing after bounded retries (persistent
    corruption or a dead disk, as opposed to a transient hiccup)."""

    def __init__(self, msg: str, *, root: str, shard: int,
                 attempts: int):
        super().__init__(msg)
        self.root = root
        self.shard = shard
        self.attempts = attempts


class ShardCorruptionError(RuntimeError):
    """``verify_shard`` found bytes that contradict the recorded CRCs."""


def _length_sorted_chunks(rows: Sequence[np.ndarray],
                          chunk: int) -> Iterator[np.ndarray]:
    """Index arrays of ≤ ``chunk`` rows, shortest documents first, so a
    heavy-tailed corpus does not pad every chunk to its longest row."""
    order = np.argsort([len(r) for r in rows], kind="stable")
    for lo in range(0, len(rows), chunk):
        yield order[lo: lo + chunk]


def _to_device(arr: np.ndarray, dev: torch.device) -> torch.Tensor:
    """A host array on ``dev``.  On a card the copy goes from pinned
    memory, ``non_blocking``, so the host does not wait for the work
    queued before it (a pageable copy waits for the whole stream)."""
    t = torch.from_numpy(arr)
    if dev.type != "cuda":
        return t
    return t.pin_memory().to(dev, non_blocking=True)


def _start_host_copy(ts: Sequence[Optional[torch.Tensor]]):
    """Starts copying device tensors (``None`` passes) into pinned host
    buffers → (host tensors, the CUDA event after the copies, or None
    for CPU tensors, which are on the host already)."""
    dev = next(t for t in ts if t is not None).device
    if dev.type != "cuda":
        return list(ts), None
    host = [None if t is None else
            torch.empty(t.shape, dtype=t.dtype, pin_memory=True).copy_(
                t, non_blocking=True) for t in ts]
    done = torch.cuda.Event()
    done.record(torch.cuda.current_stream(dev))
    return host, done


def _stream_encoded(rows: Sequence[np.ndarray], k: int, b: int, *,
                    scheme: str, family: str, seed: int, chunk: int,
                    packed: bool, dev: torch.device):
    """Yields (sel, codes, empty|None) per length-sorted chunk: uint8
    packed rows and the packbits empty mask (``packed=True``), or uint16
    codes with the ``OPH_EMPTY_CODE`` sentinel applied.  Up to
    ``PIPELINE_DEPTH`` chunks are in flight: chunk i+1 is queued before
    chunk i's result is read, which waits on chunk i's copy event only."""
    if scheme == "minwise" and family != "multiply_shift":
        # exact offline families (mod-prime / permutation): numpy path
        fam = make_hash_family(family, k, seed)
        for sel in _length_sorted_chunks(rows, chunk):
            idx, nnz = pad_rows([rows[i] for i in sel], pad_to_multiple=1)
            mask = np.arange(idx.shape[1])[None, :] < nnz[:, None]
            codes = bbit_codes(minhash_numpy(idx, mask, fam), b)
            yield sel, (pack_codes(codes, b) if packed else codes), None
        return
    if scheme != "minwise" and family != "multiply_shift":
        raise ValueError(f"scheme {scheme!r} only supports the "
                         "multiply_shift family")
    sch = make_scheme(scheme, k, seed)

    def _materialize(sel, host, done):
        if done is not None:
            done.synchronize()
        vals, empty = (None if t is None else t.numpy() for t in host)
        if packed:
            # row padding (if any) falls off here
            return sel, vals[: len(sel)], (
                None if empty is None else empty[: len(sel)])
        out = vals.astype(np.uint16)
        if empty is not None:
            out[empty] = OPH_EMPTY_CODE
        return sel, out, None

    pending = collections.deque()
    for sel in _length_sorted_chunks(rows, chunk):
        idx, nnz = pad_rows([rows[i] for i in sel], bucket=True)
        if packed:
            # the row count is bucketed too (a ragged last chunk → the
            # next power of two, nnz=0 filler rows that fall off above)
            n_pad = min(chunk, 1 << max(3, (len(sel) - 1).bit_length()))
            if n_pad > len(sel):
                idx = np.pad(idx, ((0, n_pad - len(sel)), (0, 0)))
                nnz = np.pad(nnz, (0, n_pad - len(sel)))
        idx_t, nnz_t = _to_device(idx, dev), _to_device(nnz, dev)
        enc = (sch.encode_packed(idx_t, nnz_t, b) if packed
               else sch.encode_device(idx_t, nnz_t, b))
        pending.append((sel, *_start_host_copy(enc)))
        if len(pending) >= PIPELINE_DEPTH:
            yield _materialize(*pending.popleft())
    while pending:
        yield _materialize(*pending.popleft())


def preprocess_rows(rows: Sequence[np.ndarray], k: int, b: int, *,
                    scheme: str = "minwise",
                    family: str = "multiply_shift", seed: int = 0,
                    chunk: int = 1024,
                    device: DeviceLike = None) -> np.ndarray:
    """Hashes rows → uint16 codes (n, k) on the host, the reference's
    integers.  ``scheme`` 'minwise' (k hash evaluations per nonzero),
    'oph' (one, densified) or 'oph_zero' (one, empty bins marked
    ``OPH_EMPTY_CODE``, so b ≤ 15); ``family`` 'multiply_shift', or for
    minwise the exact 'mod_prime'; 1 ≤ b ≤ 16.  Runs on ``device``
    (default ``cuda:0``)."""
    dev = resolve_device(device)
    out = np.empty((len(rows), k), dtype=np.uint16)
    for sel, codes, _ in _stream_encoded(
            rows, k, b, scheme=scheme, family=family, seed=seed,
            chunk=chunk, packed=False, dev=dev):
        out[sel] = codes
    return out


def preprocess_rows_packed(
    rows: Sequence[np.ndarray], k: int, b: int, *,
    scheme: str = "minwise", family: str = "multiply_shift", seed: int = 0,
    chunk: int = 1024, device: DeviceLike = None,
) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """Fused streaming encode → (packed uint8 (n, ceil(k·b/8)), packbits
    empty mask (n, ceil(k/8)) for ``oph_zero``, else None): the bytes of
    ``pack_codes(preprocess_rows(...), b)``, with only the packed rows
    leaving the device.  Runs on ``device`` (default ``cuda:0``)."""
    dev = resolve_device(device)
    out = np.empty((len(rows), packed_width(k, b)), dtype=np.uint8)
    emp: Optional[np.ndarray] = None
    for sel, pk, em in _stream_encoded(
            rows, k, b, scheme=scheme, family=family, seed=seed,
            chunk=chunk, packed=True, dev=dev):
        out[sel] = pk
        if em is not None:
            if emp is None:
                emp = np.zeros((len(rows), (k + 7) // 8), dtype=np.uint8)
            emp[sel] = em
    return out, emp


def _crc(arr: np.ndarray) -> int:
    return zlib.crc32(np.ascontiguousarray(arr).tobytes())


class HashedShardWriter:
    """Streaming format-v4 shard writer: append packed chunks as they
    arrive, flush ``rows_per_shard``-row shards incrementally, so
    ``preprocess_and_save`` never holds more than one shard of rows."""

    def __init__(self, root: str, k: int, b: int, *, n_total: int,
                 scheme: str = "minwise", family: str = "multiply_shift",
                 seed: int = 0, n_shards: int = 1):
        os.makedirs(root, exist_ok=True)
        self.root = root
        self.k, self.b = k, b
        self.scheme, self.family, self.seed = scheme, family, seed
        self.n_total = int(n_total)
        self.n_shards = n_shards
        self.rows_per_shard = max(1, -(-self.n_total // n_shards))
        self._codes, self._labels, self._rows, self._empty = [], [], [], []
        self._buffered = 0
        self._shard = 0
        self._closed = False
        self._checksums: List[dict] = []
        # None until the first append decides; every later append must
        # agree, or a shard's .empty.npy rows would desync from its codes
        self._has_empty: Optional[bool] = None

    def append(self, row_ids: np.ndarray, packed: np.ndarray,
               labels: np.ndarray,
               empty: Optional[np.ndarray] = None) -> None:
        row_ids = np.asarray(row_ids, dtype=np.int64)
        packed = np.ascontiguousarray(packed)
        labels = np.asarray(labels, dtype=np.int32)
        if not len(row_ids) == len(packed) == len(labels):
            raise ValueError(
                f"append row mismatch: {len(row_ids)} row_ids, "
                f"{len(packed)} code rows, {len(labels)} labels")
        has_empty = empty is not None
        if self._has_empty is not None and has_empty != self._has_empty:
            raise ValueError(
                "inconsistent empty mask: this writer has seen "
                f"empty={'arrays' if self._has_empty else 'None'} so far "
                f"but this append passes empty="
                f"{'an array' if has_empty else 'None'} — a shard's "
                ".empty.npy rows must stay in lockstep with its codes")
        if has_empty:
            empty = np.ascontiguousarray(empty)
            if len(empty) != len(row_ids):
                raise ValueError(
                    f"append row mismatch: {len(row_ids)} row_ids but "
                    f"{len(empty)} empty-mask rows")
        # commit the mode only after every validation passed: a failed
        # append leaves the writer reusable
        self._has_empty = has_empty
        if has_empty:
            self._empty.append(empty)
        self._codes.append(packed)
        self._labels.append(labels)
        self._rows.append(row_ids)
        self._buffered += len(row_ids)
        while self._buffered >= self.rows_per_shard:
            self._flush(self.rows_per_shard)

    @staticmethod
    def _take(parts, count):
        out, rest, got = [], [], 0
        for p in parts:
            if got >= count:
                rest.append(p)
            elif got + len(p) <= count:
                out.append(p)
                got += len(p)
            else:
                out.append(p[: count - got])
                rest.append(p[count - got:])
                got = count
        return np.concatenate(out) if out else None, rest

    def _flush(self, count: int) -> None:
        count = min(count, self._buffered)
        if count == 0:
            return
        base = os.path.join(self.root, f"hashed_{self._shard:05d}")
        codes, self._codes = self._take(self._codes, count)
        labels, self._labels = self._take(self._labels, count)
        rows, self._rows = self._take(self._rows, count)
        np.save(base + ".codes.npy", codes)
        np.save(base + ".labels.npy", labels)
        np.save(base + ".rows.npy", rows)
        crcs = {"codes": _crc(codes), "labels": _crc(labels),
                "rows": _crc(rows)}
        if self._has_empty:
            empty, self._empty = self._take(self._empty, count)
            np.save(base + ".empty.npy", empty)
            crcs["empty"] = _crc(empty)
        self._checksums.append(crcs)
        self._buffered -= count
        self._shard += 1

    def close(self, stats: Optional[dict] = None) -> dict:
        """Flushes the remainder and writes meta.json; returns meta."""
        if self._closed:
            raise RuntimeError("writer already closed")
        self._flush(self._buffered)
        self._closed = True
        meta = dict(format_version=FORMAT_VERSION, scheme=self.scheme,
                    k=self.k, b=self.b, family=self.family, seed=self.seed,
                    n=self.n_total, shards=self._shard,
                    packed_width=packed_width(self.k, self.b),
                    shard_checksums=self._checksums)
        if stats:
            meta.update(stats)
        with open(os.path.join(self.root, "meta.json"), "w") as f:
            json.dump(meta, f)
        return meta


def save_hashed(root: str, codes: np.ndarray, labels: np.ndarray, k: int,
                b: int, *, scheme: str = "minwise",
                family: str = "multiply_shift", seed: int = 0,
                n_shards: int = 1) -> None:
    """Version-2 bulk writer: an (n, k) uint16 code matrix → round-robin
    ``.npz`` shards, for callers that hold the full matrix."""
    os.makedirs(root, exist_ok=True)
    n = codes.shape[0]
    meta = dict(format_version=2, scheme=scheme, k=k, b=b,
                family=family, seed=seed, n=int(n), shards=n_shards)
    with open(os.path.join(root, "meta.json"), "w") as f:
        json.dump(meta, f)
    empty = codes == OPH_EMPTY_CODE if scheme == "oph_zero" else None
    if empty is not None:
        codes = np.where(empty, np.uint16(0), codes)
    for s in range(n_shards):
        arrays = dict(codes=pack_codes(codes[s::n_shards], b),
                      labels=labels[s::n_shards].astype(np.int32))
        if empty is not None:
            arrays["empty"] = np.packbits(empty[s::n_shards], axis=1)
        np.savez(os.path.join(root, f"hashed_{s:05d}.npz"), **arrays)


def _read_meta(root: str) -> dict:
    with open(os.path.join(root, "meta.json")) as f:
        meta = json.load(f)
    meta.setdefault("format_version", 1)
    meta.setdefault("scheme", "minwise")      # v1 archives predate OPH
    return meta


def _load_shard(root: str, meta: dict, s: int, mmap_mode: Optional[str]
                ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """One shard → (codes uint16 (rows, k), labels, original row ids):
    ``load_packed_shard``'s bytes, widened on the host with the
    ``OPH_EMPTY_CODE`` sentinel applied."""
    k, b = meta["k"], meta["b"]
    packed, labels, rows, empty = load_packed_shard(
        root, s, meta=meta, mmap=mmap_mode is not None)
    codes = unpack_codes(np.asarray(packed), k, b)
    if empty is not None:
        mask = np.unpackbits(np.asarray(empty), axis=1,
                             count=k).astype(bool)
        codes = np.where(mask, OPH_EMPTY_CODE, codes)
    return codes, labels, rows


def iter_hashed(root: str, shard_ids: Optional[Sequence[int]] = None, *,
                mmap: bool = True
                ) -> Iterator[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """Yields (codes uint16 (rows, k), labels int32, original row ids)
    one shard at a time; v3+ shards are mmap'd (``mmap=True``)."""
    meta = _read_meta(root)
    ids = range(meta["shards"]) if shard_ids is None else shard_ids
    mode = "r" if (mmap and meta["format_version"] >= 3) else None
    for s in ids:
        yield _load_shard(root, meta, s, mmap_mode=mode)


def load_packed_shard(root: str, s: int, *, meta: Optional[dict] = None,
                      mmap: bool = True
                      ) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
                                 Optional[np.ndarray]]:
    """One shard without widening → (packed uint8 (rows, ceil(k·b/8)),
    labels int32, original row ids int64, packed empty bitmask | None);
    v3+ arrays come back mmap'd with ``mmap=True``, v1/v2 ``.npz``
    shards decompress one shard."""
    meta = _read_meta(root) if meta is None else meta
    if meta["format_version"] >= 3:
        mode = "r" if mmap else None

        def _open():
            if faults._ACTIVE is not None:
                faults.on_shard_read(root, s)
            base = os.path.join(root, f"hashed_{s:05d}")
            packed = np.load(base + ".codes.npy", mmap_mode=mode)
            labels = np.asarray(np.load(base + ".labels.npy",
                                        mmap_mode=mode))
            rows = np.asarray(np.load(base + ".rows.npy", mmap_mode=mode))
            epath = base + ".empty.npy"
            empty = (np.load(epath, mmap_mode=mode)
                     if os.path.exists(epath) else None)
            return packed, labels, rows, empty

        # bounded retry-with-backoff on transient I/O errors; a read that
        # keeps failing is quarantined and raised with its context
        attempts = READ_RETRIES + 1
        for attempt in range(attempts):
            try:
                return _open()
            except FileNotFoundError:
                raise            # a missing shard file is not transient
            except OSError as e:
                last = e
                if attempt + 1 < attempts:
                    log.warning(
                        "transient error reading shard %d of %r "
                        "(attempt %d/%d): %s — retrying",
                        s, root, attempt + 1, attempts, e)
                    time.sleep(READ_BACKOFF.delay_s(attempt))
        quarantined_shards.setdefault(root, []).append(int(s))
        log.error(
            "shard %d of %r failed all %d read attempts — quarantined "
            "(run verify_shard to check recorded CRCs): %s",
            s, root, attempts, last)
        raise ShardReadError(
            f"shard {s} of {root!r} failed all {attempts} read "
            f"attempts: {last}", root=root, shard=int(s),
            attempts=attempts) from last
    z = np.load(os.path.join(root, f"hashed_{s:05d}.npz"))
    rows = np.arange(s, meta["n"], meta["shards"], dtype=np.int64)
    return (z["codes"], z["labels"], rows,
            z["empty"] if "empty" in z else None)


def verify_shard(root: str, s: int,
                 meta: Optional[dict] = None) -> Optional[dict]:
    """Recomputes shard ``s``'s file CRC32s against ``meta.json`` (v4+):
    the recomputed dict on success, None for an archive without
    checksums, ``ShardCorruptionError`` naming every mismatching file
    otherwise (and the shard quarantined)."""
    meta = _read_meta(root) if meta is None else meta
    recorded = meta.get("shard_checksums")
    if not recorded or s >= len(recorded):
        return None
    packed, labels, rows, empty = load_packed_shard(
        root, s, meta=meta, mmap=False)
    got = {"codes": _crc(packed), "labels": _crc(labels),
           "rows": _crc(rows)}
    if empty is not None:
        got["empty"] = _crc(empty)
    bad = [name for name, want in recorded[s].items()
           if got.get(name) != int(want)]
    if bad:
        quarantined_shards.setdefault(root, []).append(int(s))
        log.error("shard %d of %r is corrupt: CRC mismatch on %s",
                  s, root, bad)
        raise ShardCorruptionError(
            f"shard {s} of {root!r} is corrupt: CRC mismatch on "
            f"{bad} (recorded {recorded[s]}, recomputed {got})")
    return got


def iter_packed(root: str, shard_ids: Optional[Sequence[int]] = None, *,
                mmap: bool = True
                ) -> Iterator[Tuple[np.ndarray, np.ndarray, np.ndarray,
                                    Optional[np.ndarray]]]:
    """Yields ``load_packed_shard`` tuples one shard at a time."""
    meta = _read_meta(root)
    ids = range(meta["shards"]) if shard_ids is None else shard_ids
    for s in ids:
        yield load_packed_shard(root, s, meta=meta, mmap=mmap)


def iter_hashed_batches(
    root: str, batch_size: int, *,
    shard_ids: Optional[Sequence[int]] = None,
    perm_seed=None, mmap: bool = True, drop_remainder: bool = False,
) -> Iterator[Tuple[np.ndarray, np.ndarray, np.ndarray,
                    Optional[np.ndarray]]]:
    """Minibatches of packed rows straight off the shards: (packed uint8
    (B, ceil(k·b/8)), labels int32 (B,), original row ids int64 (B,),
    packed empty bitmask (B, ceil(k/8)) | None).

    ``perm_seed`` (an int or a tuple of ints, such as the trainer's
    ``(seed, epoch)``) permutes each shard's rows as a pure function of
    (*perm_seed, shard id), the reference's permutation, so a restarted
    consumer replays identical batches; a shard's last partial batch is
    yielded unless ``drop_remainder``.
    """
    meta = _read_meta(root)
    ids = range(meta["shards"]) if shard_ids is None else shard_ids
    for s in ids:
        packed, labels, rows, empty = load_packed_shard(
            root, s, meta=meta, mmap=mmap)
        n = packed.shape[0]
        if n == 0:
            continue
        if batch_size > n:
            raise ValueError(
                f"batch_size={batch_size} exceeds shard {s}'s {n} rows "
                f"({root!r}); use batch_size <= the smallest shard, or "
                "re-shard the archive with fewer shards")
        if perm_seed is None:
            order = np.arange(n)
        else:
            ent = (tuple(perm_seed) if isinstance(perm_seed, (tuple, list))
                   else (perm_seed,))
            order = np.random.default_rng(
                np.random.SeedSequence(ent + (int(s),))).permutation(n)
        stop = (n - batch_size + 1) if drop_remainder else n
        for lo in range(0, max(stop, 0), batch_size):
            sel = order[lo: lo + batch_size]
            yield (np.ascontiguousarray(packed[sel]), labels[sel],
                   rows[sel],
                   None if empty is None
                   else np.ascontiguousarray(empty[sel]))


def shard_row_counts(root: str) -> list:
    """Rows per shard without loading shard data (v3+: mmap'd shape
    reads; v1/v2: the round-robin formula)."""
    meta = _read_meta(root)
    if meta["format_version"] >= 3:
        return [int(np.load(os.path.join(root, f"hashed_{s:05d}.labels.npy"),
                            mmap_mode="r").shape[0])
                for s in range(meta["shards"])]
    return [len(range(s, meta["n"], meta["shards"]))
            for s in range(meta["shards"])]


def load_hashed(root: str, shard_ids: Optional[Sequence[int]] = None
                ) -> Tuple[np.ndarray, np.ndarray, dict]:
    """(codes uint16 (n, k), labels int32 (n,), meta).  All shards come
    back in the original row order, a subset in shard order; ``oph_zero``
    empty bins carry ``OPH_EMPTY_CODE``."""
    meta = _read_meta(root)
    all_codes, all_labels, sels = [], [], []
    for codes, labels, rows in iter_hashed(root, shard_ids, mmap=False):
        all_codes.append(codes)
        all_labels.append(labels)
        sels.append(rows)
    if not all_codes:
        return (np.zeros((0, meta["k"]), np.uint16),
                np.zeros((0,), np.int32), meta)
    codes = np.concatenate(all_codes)
    labels = np.concatenate(all_labels)
    if shard_ids is None:
        order = np.concatenate(sels)
        inv = np.empty_like(order)
        inv[order] = np.arange(len(order))
        codes, labels = codes[inv], labels[inv]
    return codes, labels, meta


def preprocess_and_save(root: str, rows: Sequence[np.ndarray],
                        labels: np.ndarray, k: int, b: int, *,
                        scheme: str = "minwise",
                        family: str = "multiply_shift", seed: int = 0,
                        n_shards: int = 1, chunk: int = 1024,
                        device: DeviceLike = None) -> dict:
    """Streaming preprocessing: the fused encode (B1 minwise, B2 OPH;
    packed bytes off ``device``, default ``cuda:0``) into
    ``HashedShardWriter``, in O(pipeline depth · chunk + one shard) host
    memory.  ``seconds_hashing`` (hash + pack + write), ``total_nnz``
    and ``mnnz_per_s`` go into meta.json."""
    dev = resolve_device(device)
    labels = np.asarray(labels)
    writer = HashedShardWriter(
        root, k, b, n_total=len(rows), scheme=scheme, family=family,
        seed=seed, n_shards=n_shards)
    total_nnz = int(sum(len(r) for r in rows))
    t0 = time.perf_counter()
    for sel, packed, empty in _stream_encoded(
            rows, k, b, scheme=scheme, family=family, seed=seed,
            chunk=chunk, packed=True, dev=dev):
        writer.append(sel, packed, labels[sel], empty)
    t_hash = time.perf_counter() - t0
    stats = dict(seconds_hashing=t_hash, total_nnz=total_nnz,
                 mnnz_per_s=total_nnz / max(t_hash, 1e-9) / 1e6)
    writer.close(stats)
    return dict(stats, n=len(rows), k=k, b=b, scheme=scheme)
