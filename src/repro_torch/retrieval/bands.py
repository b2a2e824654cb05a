"""LSH band keys extracted directly from packed b-bit codes (a copy of
``repro/retrieval/bands.py``: the port imports nothing of ``repro``).

A packed row (``core.bbit.pack_codes``) is the row-major bitstream of k
b-bit codes, LSB-first within each byte: code j occupies bits
[j·b, (j+1)·b).  Band ``i`` of ``r`` codes is the contiguous bit span
[i·r·b, (i+1)·r·b), so a key is one unaligned little-endian load:

    start = i·r·b;  byte0 = start // 8;  shift = start % 8
    key   = (Σ_t bytes[byte0+t] << 8t) >> shift  &  (2^(r·b) − 1)

With r·b ≤ 56 the gather fits one uint64 (shift ≤ 7).  When r·b is a
whole number of bytes the bands tile the row and the shift vanishes.
``band_keys_ref`` recomputes the same keys from unpacked codes.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from repro_torch.core.bbit import packed_width

# One uint64 must hold shift (≤7) + r·b band bits.
MAX_BAND_BITS = 56


def band_geometry(k: int, b: int, rows_per_band: int) -> int:
    """Validates (k, b, r) banding and returns the band count k/r."""
    r = int(rows_per_band)
    if r < 1:
        raise ValueError(f"rows_per_band must be >= 1, got {r}")
    if k % r:
        raise ValueError(
            f"rows_per_band must divide k: k={k}, rows_per_band={r}")
    if r * b > MAX_BAND_BITS:
        raise ValueError(
            f"band of {r}x{b}-bit codes = {r * b} bits exceeds the "
            f"{MAX_BAND_BITS}-bit uint64 extraction limit")
    return k // r


def band_keys_packed(
    packed: np.ndarray, k: int, b: int, rows_per_band: int,
) -> np.ndarray:
    """Packed uint8 (n, ceil(k·b/8)) → uint64 band keys (n, k/r), with
    no unpack: each key is one unaligned little-endian uint64 load."""
    r = int(rows_per_band)
    nb = band_geometry(k, b, r)
    packed = np.asarray(packed, dtype=np.uint8)
    if packed.ndim != 2 or packed.shape[1] != packed_width(k, b):
        raise ValueError(
            f"expected packed shape (n, {packed_width(k, b)}), "
            f"got {packed.shape}")
    n = packed.shape[0]
    rb = r * b
    if rb % 8 == 0:
        bb = rb // 8                       # whole-byte bands tile the row
        v = packed[:, : nb * bb].reshape(n, nb, bb).astype(np.uint64)
        weights = (np.arange(bb, dtype=np.uint64) * np.uint64(8))
        return (v << weights[None, None, :]).sum(axis=2, dtype=np.uint64)
    starts = np.arange(nb, dtype=np.int64) * rb
    byte0 = starts // 8
    shift = (starts % 8).astype(np.uint64)
    span = (rb + 7) // 8 + 1               # bytes covering shift + rb bits
    padded = np.pad(packed, ((0, 0), (0, span)))
    cols = byte0[:, None] + np.arange(span, dtype=np.int64)[None, :]
    v = padded[:, cols].astype(np.uint64)  # (n, nb, span)
    weights = (np.arange(span, dtype=np.uint64) * np.uint64(8))
    acc = (v << weights[None, None, :]).sum(axis=2, dtype=np.uint64)
    mask = np.uint64((1 << rb) - 1)
    return (acc >> shift[None, :]) & mask


def band_keys_ref(
    codes: np.ndarray, b: int, rows_per_band: int,
) -> np.ndarray:
    """Unpacked uint16 codes (n, k) → uint64 band keys (n, k/r): code t
    of a band contributes bits [t·b, (t+1)·b), the packed layout."""
    r = int(rows_per_band)
    n, k = codes.shape
    nb = band_geometry(k, b, r)
    mask = np.uint64((1 << b) - 1)
    c = codes.astype(np.uint64).reshape(n, nb, r) & mask
    weights = (np.arange(r, dtype=np.uint64) * np.uint64(b))
    return (c << weights[None, None, :]).sum(axis=2, dtype=np.uint64)


def band_signature(
    packed_row: np.ndarray,
    k: int,
    b: int,
    rows_per_band: int,
    probe_bands: Optional[int] = None,
) -> Tuple[int, ...]:
    """One packed row → hashable tuple of its first ``probe_bands`` band
    keys (all by default): the dedup cache's probe key."""
    keys = band_keys_packed(np.asarray(packed_row)[None, :], k, b,
                            rows_per_band)[0]
    if probe_bands is not None:
        if probe_bands < 1:
            raise ValueError(f"probe_bands must be >= 1, got {probe_bands}")
        keys = keys[:probe_bands]
    return tuple(int(x) for x in keys)
