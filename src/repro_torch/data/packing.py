"""Padded-batch packing of variable-length sparse rows (a copy of
``repro/data/packing.py``: the port imports nothing of ``repro``)."""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np


def bucket_width(m: int, floor: int = 128) -> int:
    """Round a pad width up to the next power of two (≥ ``floor``).

    Shape-bucketing for jit: length-sorted chunks otherwise produce a
    fresh pad width — and a fresh XLA compile — per chunk; bucketing
    bounds the number of distinct compiled shapes at O(log max_nnz).
    """
    m = max(int(m), max(floor, 1))
    return 1 << (m - 1).bit_length()


def pad_rows(
    rows: Sequence[np.ndarray],
    max_nnz: Optional[int] = None,
    pad_to_multiple: int = 128,
    clip: bool = True,
    bucket: bool = False,
) -> Tuple[np.ndarray, np.ndarray]:
    """rows → (indices int32 (n, m), nnz int32 (n,)); contiguous padding.

    Indices beyond 2^31-1 are folded into [0, 2^31) (the minhash kernel
    hashes them anyway, so folding only changes the pre-hash id space).
    ``bucket=True`` additionally rounds the pad width up to a power of
    two (see ``bucket_width``) so chunked callers compile O(log m) jit
    variants instead of one per chunk.
    """
    n = len(rows)
    lengths = np.asarray([len(r) for r in rows], dtype=np.int64)
    m = int(lengths.max(initial=1))
    if max_nnz is not None:
        m = min(m, max_nnz) if clip else max_nnz
    m = max(m, 1)
    if pad_to_multiple > 1:
        m = ((m + pad_to_multiple - 1) // pad_to_multiple) * pad_to_multiple
    if bucket:
        m = bucket_width(m, floor=max(pad_to_multiple, 1))
    idx = np.zeros((n, m), dtype=np.int32)
    nnz = np.minimum(lengths, m).astype(np.int32)
    mask31 = np.int64((1 << 31) - 1)
    for i, r in enumerate(rows):
        k = int(nnz[i])
        idx[i, :k] = (np.asarray(r[:k], dtype=np.int64) & mask31).astype(
            np.int32)
    return idx, nnz


def batch_iterator(
    indices: np.ndarray,
    nnz: np.ndarray,
    labels: np.ndarray,
    batch_size: int,
    *,
    shuffle_seed: Optional[int] = None,
    drop_remainder: bool = True,
):
    """Yields (indices, nnz, labels) minibatches, optionally shuffled
    (``default_rng(shuffle_seed)``, the reference's order)."""
    n = indices.shape[0]
    order = np.arange(n)
    if shuffle_seed is not None:
        np.random.default_rng(shuffle_seed).shuffle(order)
    stop = (n // batch_size) * batch_size if drop_remainder else n
    for lo in range(0, stop, batch_size):
        sel = order[lo: lo + batch_size]
        yield indices[sel], nnz[sel], labels[sel]
